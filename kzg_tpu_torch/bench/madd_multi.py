"""Inputs for kernel K7 (`madd_multi`, the bucket loop's fused madd step),
and K7's two modes against each other and the wide mode against variants of
itself, on one NVIDIA GPU.

    python3 -m kzg_tpu_torch.bench.madd_multi [--out JSON]

`random_steps` builds S steps of random operands with the edge lanes
planted first (an infinite accumulator, a lane skipped at every step, P + P,
P + (-P) under the neg mask and an infinite accumulator taking the next
point); `bucket_shape` gives the operands the bucket loop hands K7 inside
an MSM. `tests/test_torch_cuda.py` and `chip_smoke.py` hold both modes and
the twin to them.

The bench, in one call:
  1. builds variants of the wide mode's kernel (`csrc/point.cuh`,
     `madd_multi_wide_kernel`, restated in `VARIANT_SOURCE`) beside the
     library (nvcc, one process a variant, side by side, into
     build/k7_variants/): 64 or 128 threads a block, a minimum of resident
     blocks an SM (`__launch_bounds__`), the next step's loads ahead of the
     madd or behind its skip branch (as the library's kernel). Prints their
     registers and spills from ptxas, and the library's;
  2. times the narrow and the wide mode in turns at the
     shapes the bucket loop gives K7 (the second launch of a 2^12-point MSM
     at c = 7, G1 and G2; the first of the 2^15 witness's, 2^15 - 1
     points at c = 9), at M = 2^11 .. 2^16 random lanes, S = 16, and at
     1-16 waves of the narrow kernel (132 SMs x its blocks an SM x 2
     lanes), G1 and G2: the device time alone (calls run back to back
     behind a held stream, `peaks.held_ms`) and a call's time (events
     around calls as the host makes them), each mode equal to the others
     word for word, and to the plain twin at the real shapes;
  3. prints the crossover, the most waves at which the narrow mode's
     device time is still the shorter (`cuda_ops.NARROW_WAVES` takes it);
  4. times every variant at the real shapes and at 2^15 and 2^16 lanes.
Prints the card's name and power limit and writes the rows to JSON
(default build/madd_multi_bench.json).
"""

import argparse
import ctypes
import json
import os
import random
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from .. import kernels
from ..config import get_config
from ..constants import R
from ..curve import G1, G2, cuda_ops
from . import horner as hbench
from . import pointwise as pw

SEED = 20260410
STEPS = 16
WIDTHS = tuple(1 << k for k in range(11, 17))
WAVES = (1, 2, 3, 4, 6, 8, 12, 16)
# (threads a block, minimum resident blocks an SM, prefetch); the first has the
# library kernel's shape
VARIANTS = ((128, 1, False), (128, 1, True), (128, 2, True), (128, 3, True), (64, 1, True),
            (64, 2, True), (64, 4, True), (128, 2, False))
VARIANT_WIDTHS = (1 << 15, 1 << 16)
KERNELS = {"g1": (cuda_ops._G1K, G1, cuda_ops.madd_multi, cuda_ops.madd_multi_plain),
           "g2": (cuda_ops._G2K, G2, cuda_ops.g2_madd_multi, cuda_ops.g2_madd_multi_plain)}


def random_steps(group: str, lanes: int, steps: int, generator: torch.Generator):
    """(acc, (qx, qy), skip, neg) on the generator's device: `lanes`
    Jacobian accumulators and `steps` x `lanes` affine points of random
    non-zero field values (not points of the curve: K7's arithmetic and
    branches are the same for them), skip and neg masks each set at a
    quarter of the steps.
    Planted where the lane exists: lane 0's accumulator infinite (it takes
    step 0's point); lane 1 skipped at every step; step 0 of lane 2 adds its
    accumulator's own point, (x2 Z^2, y2 Z^3, Z) (P + P: doubled), and of
    lane 3 the same under the neg mask (P + (-P): infinity), which then
    takes step 1's point."""
    g = KERNELS[group][0]
    f = g.plain.f
    dev = generator.device
    acc = tuple(t.clone() for t in hbench.random_sums(group, lanes, generator))
    q = tuple(t.reshape(g.lead + (steps, lanes))
              for t in hbench.random_sums(group, steps * lanes, generator)[:2])
    skip = torch.rand((steps, lanes), generator=generator, device=dev) < 0.25
    neg = torch.rand((steps, lanes), generator=generator, device=dev) < 0.25
    if lanes > 0:
        acc[2][..., 0] = 0
        skip[0, 0] = False
    if lanes > 1:
        skip[:, 1] = True
    for lane, negate in ((2, False), (3, True)):
        if lanes <= lane:
            continue
        x2, y2 = (t[..., 0, lane:lane + 1] for t in q)
        z = acc[2][..., lane:lane + 1]
        z2 = f.sqr(z)
        acc[0][..., lane:lane + 1] = f.mul(x2, z2)
        acc[1][..., lane:lane + 1] = f.mul(y2, f.mul(z2, z))
        skip[:2, lane] = False
        neg[0, lane] = negate
    return acc, q, skip, neg


def bucket_shape(group: str, points, ints, c: int, launch: int):
    """(acc, (qx, qy), skip, runs) of launch `launch` of the bucket loop in
    the MSM of the affine `points` by the integer scalars `ints` at window
    c (`msm.pippenger._bucket_loop`, `msm_fuse_steps` steps a launch): the
    accumulators start at infinity and, past launch 0, are the plain twin's
    sums of the launches before."""
    from ..fields import FR
    from ..msm import pippenger

    _, curve, _, plain_fn = KERNELS[group]
    dev = points[0].device
    std = FR.from_mont(torch.from_numpy(FR.encode(ints)).to(dev))
    inputs = pippenger.bucket_inputs(*points, std, c)
    runs = pippenger.split_runs(inputs[2], inputs[3], len(ints))
    fuse = get_config().msm_fuse_steps
    acc = curve.infinity((runs.pos.numel(),), dev)
    for k in range(launch + 1):
        q, skip = pippenger.loop_chunk(inputs[0], inputs[1], runs, k * fuse, fuse)
        q = tuple(t.contiguous() for t in q)
        if k < launch:
            acc = plain_fn(acc, q, skip)
    return acc, q, skip, runs


# ---- the wide mode's variants ----------------------------------------------------------------

VARIANT_SOURCE = r"""
// K7's wide kernel (point.cuh, madd_multi_wide_kernel) as a variant:
// KZG_THREADS a block, __launch_bounds__(KZG_THREADS, KZG_MB), step s + 1's
// point and masks loaded ahead of step s's madd (KZG_PREFETCH 1, the loads
// no longer behind the skip branch) or as the library's kernel loads them;
// G1 or G2 (KZG_G2).
#include "point.cuh"

#if KZG_G2
using VarE = Fp2E;
#else
using VarE = FpE;
#endif

__global__ void __launch_bounds__(KZG_THREADS, KZG_MB)
variant_madd_multi_kernel(uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                          uint32_t* __restrict__ oz, const uint32_t* __restrict__ ax,
                          const uint32_t* __restrict__ ay, const uint32_t* __restrict__ az,
                          const uint32_t* __restrict__ qx, const uint32_t* __restrict__ qy,
                          const uint8_t* __restrict__ skip, const uint8_t* __restrict__ neg,
                          int steps, long long n) {
  const long long i = (long long)blockIdx.x * KZG_THREADS + threadIdx.x;
  if (i >= n) return;
  const long long total = (long long)steps * n;
  Jac<VarE> acc = load_point<VarE>(ax, ay, az, n, i);
#if KZG_PREFETCH
  uint8_t sk = skip[i], ng = neg ? neg[i] : 0;
  VarE x2 = Coord<VarE>::load(qx, total, i), y2 = Coord<VarE>::load(qy, total, i);
  for (int s = 0; s < steps; s++) {
    const uint8_t sk_s = sk, ng_s = ng;
    const VarE x_s = x2;
    VarE y_s = y2;
    if (s + 1 < steps) {
      const long long k = (long long)(s + 1) * n + i;
      sk = skip[k];
      ng = neg ? neg[k] : 0;
      x2 = Coord<VarE>::load(qx, total, k);
      y2 = Coord<VarE>::load(qy, total, k);
    }
    if (sk_s) continue;
    if (ng_s) y_s = sub(Coord<VarE>::zero(), y_s);
    acc = madd(acc, x_s, y_s);
  }
#else
  for (int s = 0; s < steps; s++) {
    const long long k = (long long)s * n + i;
    if (skip[k]) continue;
    VarE y2 = Coord<VarE>::load(qy, total, k);
    if (neg && neg[k]) y2 = sub(Coord<VarE>::zero(), y2);
    acc = madd(acc, Coord<VarE>::load(qx, total, k), y2);
  }
#endif
  store_point<VarE>(ox, oy, oz, n, i, acc);
}

extern "C" int kzg_variant_madd_multi(void* ox, void* oy, void* oz, const void* ax,
                                      const void* ay, const void* az, const void* qx,
                                      const void* qy, const void* skip, const void* neg,
                                      int steps, long long n, void* stream) {
  if (n <= 0 || steps <= 0) return (int)cudaErrorInvalidValue;
  variant_madd_multi_kernel<<<(unsigned)((n + KZG_THREADS - 1) / KZG_THREADS), KZG_THREADS, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(ox), static_cast<uint32_t*>(oy), static_cast<uint32_t*>(oz),
      static_cast<const uint32_t*>(ax), static_cast<const uint32_t*>(ay),
      static_cast<const uint32_t*>(az), static_cast<const uint32_t*>(qx),
      static_cast<const uint32_t*>(qy), static_cast<const uint8_t*>(skip),
      static_cast<const uint8_t*>(neg), steps, n);
  return (int)cudaGetLastError();
}
"""


def variant_name(threads: int, min_blocks: int, prefetch: bool) -> str:
    return f"t{threads}_mb{min_blocks}{'_prefetch' if prefetch else ''}"


def build_variant(src, group: str, threads: int, min_blocks: int, prefetch: bool):
    """One variant of one group in a library of its own; returns (path,
    ptxas lines of its kernel)."""
    lib = src.parent / f"{group}_{variant_name(threads, min_blocks, prefetch)}.so"
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, f"-DKZG_THREADS={threads}",
           f"-DKZG_MB={min_blocks}", f"-DKZG_PREFETCH={int(prefetch)}",
           f"-DKZG_G2={int(group == 'g2')}", f"-I{kernels.CSRC}", "-shared", "-o", str(lib),
           str(src)]
    res = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if res.returncode != 0:
        raise kernels.KernelError(f"nvcc failed: {' '.join(cmd)}\n{res.stdout}")
    return lib, pw._ptxas(res.stdout, "madd_multi")


class Variant:
    """A variant library's entry, launched as `cuda_ops` launches K7."""

    def __init__(self, path):
        self.lib = ctypes.CDLL(str(path))
        self.fn = self.lib.kzg_variant_madd_multi
        self.fn.argtypes = kernels._SIGNATURES["kzg_g1_madd_multi"]
        self.fn.restype = ctypes.c_int

    def __call__(self, acc, q, skip, neg=None):
        n, steps = skip.shape[1], skip.shape[0]
        out = [torch.empty_like(acc[0]) for _ in range(3)]
        rc = self.fn(*(t.data_ptr() for t in out), *(t.data_ptr() for t in acc),
                     *(t.data_ptr() for t in q), skip.view(torch.uint8).data_ptr(),
                     None if neg is None else neg.view(torch.uint8).data_ptr(), steps, n,
                     kernels.stream_handle(acc[0].device))
        kernels.check_status(rc, "variant madd_multi")
        return tuple(out)


# ---- the bench -------------------------------------------------------------------------------

def _fns(group, args):
    kern = KERNELS[group][2]
    return {"narrow": lambda: kern(*args, mode="narrow"),
            "wide": lambda: kern(*args, mode="wide")}


def _row(group, label, lanes, wave, t):
    return {"group": group, "shape": label, "lanes": lanes, "waves": lanes / wave,
            **{f"{k}_ms": v[0] for k, v in t.items()},
            **{f"{k}_device_ms": v[2] for k, v in t.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join("build", "madd_multi_bench.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("madd_multi bench: a CUDA card is required", file=sys.stderr)
        return 1
    from ..kzg.srs import setup_device

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    groups = ("g1", "g2")
    out_dir = kernels.BUILD_ROOT.parent / "k7_variants" / kernels.source_digest()
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "variant.cu"
    src.write_text(VARIANT_SOURCE)
    with ThreadPoolExecutor(max_workers=len(VARIANTS) * len(groups)) as pool:  # nvcc side by side
        futures = {(g, v): pool.submit(build_variant, src, g, *v) for g in groups for v in VARIANTS}
        kernels.library()
        built = {key: f.result() for key, f in futures.items()}
    results = {"card": card, "ptxas": {}, "shapes": [], "widths": [], "waves": [],
               "variants": [], "crossover_waves": {}}
    libs = {}
    for (g, v), (path, lines) in built.items():
        results["ptxas"][f"{g}_{variant_name(*v)}"] = lines
        print(f"ptxas {g} {variant_name(*v)}: {lines}", flush=True)
        libs[(g, v)] = Variant(path)
    lib_log = (kernels.build().parent / "ptxas.log").read_text()
    results["ptxas"]["library_madd_multi"] = pw._ptxas(lib_log, "madd_multi")
    print(f"ptxas library, K7: {results['ptxas']['library_madd_multi']}", flush=True)

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    waves = {g: sms * cuda_ops.narrow_min_blocks(KERNELS[g][0].ncomp) * 2 for g in groups}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rng = random.Random(SEED)
    params = setup_device(SEED, 1 << 15, g2_count=1 << 12, device=dev)
    ints12 = [rng.randrange(R) for _ in range(1 << 12)]
    ints15 = [rng.randrange(R) for _ in range((1 << 15) - 1)]
    shapes = [("g1", "2^12 MSM, c = 7, launch 2", params.gs, ints12, 7, 1),
              ("g2", "2^12 MSM, c = 7, launch 2", params.hs, ints12, 7, 1),
              ("g1", "2^15 witness, c = 9, launch 1", params.gs, ints15, 9, 0)]
    shape_args = []
    for g, label, pts, ints, c, launch in shapes:
        pts = tuple(t[..., :len(ints)].contiguous() for t in pts)
        acc, q, skip, runs = bucket_shape(g, pts, ints, c, launch)
        args_ = (acc, q, skip)
        fns = _fns(g, args_)
        want = KERNELS[g][3](*args_)
        if not pw._equal_all({**fns, "plain": lambda: want}):
            print(f"FAILED: {g} {label}: the modes differ from the twin", file=sys.stderr)
            return 1
        lanes = skip.shape[1]
        row = _row(g, label, lanes, waves[g], pw._in_turns(fns, lanes))
        row["live_steps"] = int((~skip).sum())
        results["shapes"].append(row)
        shape_args.append((g, label, args_))
        print(json.dumps(row), flush=True)
    for g in groups:
        for label, widths in (("widths", WIDTHS), ("waves", [k * waves[g] for k in WAVES])):
            for n in widths:
                acc, q, skip, neg = random_steps(g, n, STEPS, gen)
                args_ = (acc, q, skip, neg)
                fns = _fns(g, args_)
                if not pw._equal_all(fns):
                    print(f"FAILED: {g} at {n} lanes: the modes differ", file=sys.stderr)
                    return 1
                row = _row(g, f"random, S = {STEPS}", n, waves[g], pw._in_turns(fns, n))
                results[label].append(row)
                print(json.dumps(row), flush=True)
        rows = results["waves"]
        wins = [round(r["waves"]) for r in rows
                if r["group"] == g and r["narrow_device_ms"] < r["wide_device_ms"]]
        results["crossover_waves"][f"{g}_madd_multi"] = max(wins, default=0)
    variant_cases = [(g, label, a) for g, label, a in shape_args]
    for g in groups:
        for n in VARIANT_WIDTHS:
            acc, q, skip, neg = random_steps(g, n, STEPS, gen)
            variant_cases.append((g, f"random, S = {STEPS}", (acc, q, skip, neg)))
    for g, label, args_ in variant_cases:
        fns = {"wide": _fns(g, args_)["wide"]}
        for v in VARIANTS:
            fns[variant_name(*v)] = (lambda lib: lambda: lib(*args_))(libs[(g, v)])
        if not pw._equal_all(fns):
            print(f"FAILED: {g} {label}: the variants differ", file=sys.stderr)
            return 1
        lanes = args_[2].shape[1]
        row = _row(g, label, lanes, waves[g], pw._in_turns(fns, lanes))
        results["variants"].append(row)
        print(json.dumps(row), flush=True)
    print(f"crossover (most waves at which the narrow mode's device time is the shorter): "
          f"{results['crossover_waves']} [{card}]", flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps({"card": card, "crossover_waves": results["crossover_waves"]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
