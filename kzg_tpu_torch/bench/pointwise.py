"""Inputs for kernel K2 (add, dbl) at its edge cases, and K2's two modes
against the one-thread kernel as it was before them, on one NVIDIA GPU.

    python3 -m kzg_tpu_torch.bench.pointwise [--out JSON]

`edge_pairs` builds add's edge cases in every pairing of the two points of
a narrow block from the host's oracle points (the CPU tests,
`tests/test_torch_cuda.py` and `chip_smoke.py` hold both modes and the
twin to them); `planted` gives random operands for timing with the edge
pairs first.

The bench, in one call:
  1. builds variants of the wide mode's one-thread kernels beside the
     library (nvcc, one process a variant, side by side, into
     build/k2_variants/): `__launch_bounds__(128, k)` for k = 1, 2, 3, each
     with add's rare doubling inlined and out of line, and the kernel as it
     was before the narrow mode (`__launch_bounds__(128)`, out of line,
     "before"); prints their registers and spills from ptxas;
  2. times add and dbl over G1 and G2 at 1, 16, 256, 2^11-2^16 and 2^20
     points in the narrow mode, the wide mode and "before", in turns (CUDA
     events and the host's clock around a run of calls, closed by a
     synchronize: a call's wall time; and the device time alone, the calls
     run back to back behind a held stream), each equal to the others word
     for word;
  3. times them at 1, 2, 3, 4, 6, 8, 12, 16, 24 and 32 waves of the narrow
     kernel (132 SMs x its blocks an SM x 2 points) and prints the
     crossover, the most waves at which the narrow mode's device time is
     still the shorter (`cuda_ops.NARROW_WAVES` takes it; below a few waves
     both modes' calls are bound by the host's launch);
  4. times every variant at 2^16, 2^18 and 2^20 points in turns.
Prints the card's name and power limit and writes the rows to JSON
(default build/pointwise_bench.json).
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import kernels
from ..constants import P
from ..curve import cuda_ops
from ..oracle import ec_add, ec_neg
from ..oracle.field import Fp2
from . import horner as hbench
from . import ladder as lbench
from . import peaks

SEED = 20260408
CASES = ("generic", "p_inf", "q_inf", "both_inf", "same", "opposite")
WIDTHS = (1, 16, 256, 1 << 11, 1 << 12, 1 << 13, 1 << 14, 1 << 15, 1 << 16, 1 << 20)
WAVES = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32)
VARIANT_WIDTHS = (1 << 16, 1 << 18, 1 << 20)
VARIANTS = ((0, False),) + tuple((k, i) for k in (1, 2, 3) for i in (False, True))


def _rand_fp(rs):
    return int.from_bytes(rs.bytes(48), "little") % (P - 1) + 1


def _jac(group, pt, rs):
    """An oracle point at a random Z; None: infinity with random X and Y."""
    if group == "g1":
        return hbench._jacobian(group, pt, _rand_fp(rs), (_rand_fp(rs), _rand_fp(rs)))
    z = Fp2.from_ints(_rand_fp(rs), _rand_fp(rs))
    inf_xy = ((_rand_fp(rs), _rand_fp(rs)), (_rand_fp(rs), _rand_fp(rs)))
    return hbench._jacobian(group, pt, z, inf_xy)


def _operands(case, a, b):
    return {"generic": (a, b), "p_inf": (None, b), "q_inf": (a, None), "both_inf": (None, None),
            "same": (a, a), "opposite": (a, ec_neg(a))}[case]


def edge_pairs(group: str, device=None, seed: int = SEED):
    """(p, q, want, pairs): Jacobian batches of 2 x len(CASES)^2 points;
    block k of the narrow kernel (points 2k and 2k + 1) holds the ordered
    pair of cases pairs[k], every pair of CASES both ways round: generic,
    p infinite, q infinite, both infinite (random X and Y under Z = 0),
    P == Q (under another Z), P == -Q. `want` is the oracle's p + q of
    every point (None: infinity)."""
    rs = np.random.default_rng([seed, int(group == "g2")])
    base = lbench.random_points(group, 3, rs)
    pairs = [(a, b) for a in CASES for b in CASES]
    ps, qs, want = [], [], []
    for k, pair in enumerate(pairs):
        for h, case in enumerate(pair):
            p, q = _operands(case, base[(k + h) % 3], base[(k + h + 1) % 3])
            ps.append(_jac(group, p, rs))
            qs.append(_jac(group, q, rs))
            want.append(ec_add(p, q))
    return (tuple(hbench._to_tensor(group, col, device) for col in zip(*ps)),
            tuple(hbench._to_tensor(group, col, device) for col in zip(*qs)), want, pairs)


def planted(group: str, n: int, generator: torch.Generator, edges):
    """(p, q): two Jacobian batches of n points of random non-zero field
    values (not points of the curve: add's arithmetic and branches are the
    same for them) on the generator's device, with the edge pairs `edges` =
    (p, q) of `edge_pairs` in the first points (all of them, cut to n if
    fewer)."""
    p, q = hbench.random_sums(group, n, generator), hbench.random_sums(group, n, generator)
    k = min(n, edges[0][0].shape[-1])
    for dst, src in ((p, edges[0]), (q, edges[1])):
        for d, s in zip(dst, src):
            d[..., :k] = s[..., :k].to(d.device)
    return p, q


# ---- the wide mode's variants ----------------------------------------------------------------

VARIANT_SOURCE = r"""
// K2's wide kernels as variants: __launch_bounds__(128, KZG_MB) (KZG_MB 0:
// no minimum, as before the narrow mode), add's rare doubling inlined
// (KZG_INLINE 1) or a call; G1 or G2 (KZG_G2).
#include "point.cuh"

#if KZG_MB > 0
#define KZG_BOUNDS __launch_bounds__(kPointThreads, KZG_MB)
#else
#define KZG_BOUNDS __launch_bounds__(kPointThreads)
#endif
#if KZG_G2
using VarE = Fp2E;
#else
using VarE = FpE;
#endif

__global__ void KZG_BOUNDS variant_add(uint32_t* ox, uint32_t* oy, uint32_t* oz,
                                       const uint32_t* x1, const uint32_t* y1,
                                       const uint32_t* z1, const uint32_t* x2,
                                       const uint32_t* y2, const uint32_t* z2, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Jac<VarE> p = load_point<VarE>(x1, y1, z1, n, i);
  const Jac<VarE> q = load_point<VarE>(x2, y2, z2, n, i);
  store_point<VarE>(ox, oy, oz, n, i, add_pts<VarE, KZG_INLINE != 0>(p, q));
}

__global__ void KZG_BOUNDS variant_dbl(uint32_t* ox, uint32_t* oy, uint32_t* oz,
                                       const uint32_t* x, const uint32_t* y, const uint32_t* z,
                                       long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Jac<VarE> p = load_point<VarE>(x, y, z, n, i);
  store_point<VarE>(ox, oy, oz, n, i, KZG_INLINE ? dbl_inline(p) : dbl(p));
}

extern "C" int kzg_variant_add(void* ox, void* oy, void* oz, const void* x1, const void* y1,
                               const void* z1, const void* x2, const void* y2,
                               const void* z2, long long n, void* stream) {
  auto o = [](void* p) { return static_cast<uint32_t*>(p); };
  auto i = [](const void* p) { return static_cast<const uint32_t*>(p); };
  variant_add<<<blocks_for(n), kPointThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      o(ox), o(oy), o(oz), i(x1), i(y1), i(z1), i(x2), i(y2), i(z2), n);
  return (int)cudaGetLastError();
}

extern "C" int kzg_variant_dbl(void* ox, void* oy, void* oz, const void* x, const void* y,
                               const void* z, long long n, void* stream) {
  auto o = [](void* p) { return static_cast<uint32_t*>(p); };
  auto i = [](const void* p) { return static_cast<const uint32_t*>(p); };
  variant_dbl<<<blocks_for(n), kPointThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      o(ox), o(oy), o(oz), i(x), i(y), i(z), n);
  return (int)cudaGetLastError();
}
"""


def variant_name(min_blocks: int, inline: bool) -> str:
    return "before" if min_blocks == 0 else f"mb{min_blocks}{'_inline' if inline else ''}"


def _ptxas(text, marker):
    """The ptxas -v register and spill lines of the kernels whose name holds
    `marker`."""
    out, live = [], False
    for line in text.splitlines():
        if "Compiling entry function" in line:
            live = marker in line
            if live:
                out.append(line.strip())
        elif live and ("spill" in line or "Used" in line):
            out.append(line.strip())
    return out


def variant_source():
    """The variants' source, written once beside their libraries."""
    out_dir = kernels.BUILD_ROOT.parent / "k2_variants" / kernels.source_digest()
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "variant.cu"
    src.write_text(VARIANT_SOURCE)
    return src


def build_variant(src, group: str, min_blocks: int, inline: bool):
    """One variant of one group in a library of its own; returns (path,
    ptxas lines of its two kernels)."""
    lib = src.parent / f"{group}_{variant_name(min_blocks, inline)}.so"
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, f"-DKZG_MB={min_blocks}",
           f"-DKZG_INLINE={int(inline)}", f"-DKZG_G2={int(group == 'g2')}",
           f"-I{kernels.CSRC}", "-shared", "-o", str(lib), str(src)]
    res = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if res.returncode != 0:
        raise kernels.KernelError(f"nvcc failed: {' '.join(cmd)}\n{res.stdout}")
    return lib, _ptxas(res.stdout, "variant_")


class Variant:
    """A variant library's two entries, launched as `cuda_ops` launches K2."""

    def __init__(self, path, lead):
        self.lib = ctypes.CDLL(str(path))
        self.lead = lead
        for op, sig in (("add", "kzg_g1_add"), ("dbl", "kzg_g1_dbl")):
            f = getattr(self.lib, f"kzg_variant_{op}")
            f.argtypes = kernels._SIGNATURES[sig]
            f.restype = ctypes.c_int

    def __call__(self, op, *coords):
        n = coords[0].shape[-1]
        out = [torch.empty_like(coords[0]) for _ in range(3)]
        rc = getattr(self.lib, f"kzg_variant_{op}")(
            *(t.data_ptr() for t in out), *(t.data_ptr() for t in coords), n,
            kernels.stream_handle(coords[0].device))
        kernels.check_status(rc, f"variant {op}")
        return tuple(out)


# ---- the bench -------------------------------------------------------------------------------

def _timed(fn, iters):
    """(CUDA-event ms, host ms, device ms) a call, means over iters after a
    warm-up: events and the host's clock around the calls as the host makes
    them (the larger of the host's and the device's time a call), and the
    device's time alone (`peaks.held_ms`: the calls run back to back)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return (start.elapsed_time(end) / iters, (time.perf_counter() - t0) * 1e3 / iters,
            peaks.held_ms(fn, iters))


def _iters(n):
    return 20 if n <= 1 << 14 else 5


def _in_turns(fns, n):
    """{name: (event ms, host ms, device ms)}, each the mean of two runs in
    turns (a, b, ..., ..., b, a)."""
    order = list(fns) + list(reversed(fns))
    runs = {k: [] for k in fns}
    for k in order:
        runs[k].append(_timed(fns[k], _iters(n)))
    return {k: tuple(sum(r[i] for r in v) / len(v) for i in range(3)) for k, v in runs.items()}


def _mode_fns(group, op, p, q, before):
    kern = {"g1": (cuda_ops.add, cuda_ops.dbl), "g2": (cuda_ops.g2_add, cuda_ops.g2_dbl)}[group]
    if op == "add":
        return {"narrow": lambda: kern[0](p, q, mode="narrow"),
                "wide": lambda: kern[0](p, q, mode="wide"),
                "before": lambda: before("add", *p, *q)}
    return {"narrow": lambda: kern[1](p, mode="narrow"),
            "wide": lambda: kern[1](p, mode="wide"),
            "before": lambda: before("dbl", *p)}


def _equal_all(fns):
    outs = [fn() for fn in fns.values()]
    return all(torch.equal(a, b) for out in outs[1:] for a, b in zip(out, outs[0]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join("build", "pointwise_bench.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("pointwise bench: a CUDA card is required", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    groups = ("g1", "g2")
    with ThreadPoolExecutor(max_workers=len(VARIANTS) * len(groups)) as pool:  # nvcc side by side
        src = variant_source()
        futures = {(g, v): pool.submit(build_variant, src, g, *v) for g in groups for v in VARIANTS}
        kernels.library()
        built = {key: f.result() for key, f in futures.items()}
    results = {"card": card, "ptxas": {}, "widths": [], "waves": [], "variants": [],
               "crossover_waves": {}}
    libs = {}
    for (g, v), (path, lines) in built.items():
        name = variant_name(*v)
        results["ptxas"][f"{g}_{name}"] = lines
        print(f"ptxas {g} {name}: {lines}", flush=True)
        libs[(g, v)] = Variant(path, (12,) if g == "g1" else (12, 2))
    lib_log = (kernels.build().parent / "ptxas.log").read_text()
    results["ptxas"]["library_pointwise"] = _ptxas(lib_log, "pointwise_")
    print(f"ptxas library, narrow: {results['ptxas']['library_pointwise']}", flush=True)

    gen = torch.Generator(device=dev).manual_seed(SEED)
    edges = {g: edge_pairs(g, dev) for g in groups}
    for g in groups:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        wave = sms * cuda_ops.narrow_min_blocks(1 if g == "g1" else 2) * 2
        before = libs[(g, (0, False))]
        for label, widths in (("widths", WIDTHS), ("waves", [k * wave for k in WAVES])):
            for n in widths:
                p, q = planted(g, n, gen, edges[g][:2])
                for op in ("add", "dbl"):
                    fns = _mode_fns(g, op, p, q, before)
                    if not _equal_all(fns):
                        print(f"FAILED: {g} {op} at {n} points: the modes differ", file=sys.stderr)
                        return 1
                    t = _in_turns(fns, n)
                    row = {"group": g, "op": op, "points": n, "waves": n / wave,
                           **{f"{k}_ms": v[0] for k, v in t.items()},
                           **{f"{k}_host_ms": v[1] for k, v in t.items()},
                           **{f"{k}_device_ms": v[2] for k, v in t.items()}}
                    results[label].append(row)
                    print(json.dumps(row), flush=True)
        for op in ("add", "dbl"):
            rows = [r for r in results["waves"] if r["group"] == g and r["op"] == op]
            wins = [r["points"] // wave for r in rows
                    if r["narrow_device_ms"] < r["wide_device_ms"]]
            results["crossover_waves"][f"{g}_{op}"] = max(wins, default=0)
        for n in VARIANT_WIDTHS:
            p, q = planted(g, n, gen, edges[g][:2])
            for op in ("add", "dbl"):
                fns = {"wide": _mode_fns(g, op, p, q, before)["wide"]}
                for v in VARIANTS:
                    fns[variant_name(*v)] = (lambda lib: (lambda: lib(op, *p, *q)) if op == "add"
                                             else (lambda: lib(op, *p)))(libs[(g, v)])
                if not _equal_all(fns):
                    print(f"FAILED: {g} {op} variants differ at {n} points", file=sys.stderr)
                    return 1
                t = _in_turns(fns, n)
                row = {"group": g, "op": op, "points": n, **{f"{k}_ms": v[0] for k, v in t.items()},
                       **{f"{k}_device_ms": v[2] for k, v in t.items()}}
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
