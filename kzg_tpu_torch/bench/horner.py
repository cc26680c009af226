"""Window sums for kernel K4 (the window join), and K4 against the one-thread
chain it replaced, on one NVIDIA GPU.

    python3 -m kzg_tpu_torch.bench.horner [--out JSON]

`edge_case_sums` builds the join's edge cases from the host engine's
points (the CPU tests, `tests/test_torch_cuda.py` and `chip_smoke.py` hold
K4 and its twin to them); `random_sums` gives full-size window sums for
timing.

The bench builds two one-thread variants of the join beside the library
(nvcc, one source a group, into build/horner_serial/): the chain as K4 ran
it before its redesign (`dbl` out of line, the accumulator passed through
the local stack at every doubling) and the same chain with the doubling
inlined. It prints their registers and spills from ptxas, checks that both
give K4's words, and times the three in turns (K4, out of line, inlined,
inlined, out of line, K4; CUDA events) over G1 at (W, c) = (26, 10),
(37, 7), (18, 15), (19, 14) and over Fp2 at (26, 10), (37, 7). Prints the
card's name and power limit and writes the rows to JSON (default
build/horner_bench.json).
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import kernels, native
from ..constants import P, R
from ..curve import cuda_ops
from ..fields import FP
from ..oracle import ec_neg, g1_generator, g2_generator
from ..oracle.field import Fp2
from . import peaks

SEED = 20260406
SHAPES = (("g1", 26, 10), ("g1", 37, 7), ("g1", 18, 15), ("g1", 19, 14), ("g2", 26, 10),
          ("g2", 37, 7))

# case -> (W, c). Windows are listed LSB first, S_0 ... S_{W-1}; the join
# starts at S_{W-1}.
CASES = {
    "empty_top": (3, 2),     # S_2 = S_1 = infinity: the accumulator stays infinity, then S_0
    "all_infinite": (3, 2),  # every S_w infinity (Z = 0 under random X, Y): S_0 comes out as it is
    "equal": (3, 2),         # S_1 = 2^c S_2 under another Z: the add's P == Q branch
    "negated": (3, 2),       # S_1 = -2^c S_2: P == -Q gives infinity, then S_0
    "w1": (1, 2),            # one window
    "c1": (3, 1),            # one doubling a window; S_1 infinity (finite + infinity)
    "c16": (2, 16),          # the widest window of a 2^20 MSM and more
}


def _jacobian(group, pt, z, inf_xy):
    """Oracle point -> (X, Y, Z) ints ((c0, c1) pairs over Fp2) at Z = z;
    None -> (X, Y, 0) with the given X, Y."""
    if group == "g1":
        if pt is None:
            return inf_xy + (0,)
        x, y = pt[0].n, pt[1].n
        return (x * z * z % P, y * z * z * z % P, z)
    if pt is None:
        return inf_xy + ((0, 0),)
    zz = z * z
    vals = (pt[0] * zz, pt[1] * zz * z, z)
    return tuple((v.a.n, v.b.n) for v in vals)


def _to_tensor(group, coords, device):
    """W coordinate values -> (12, W) or (12, 2, W) Montgomery words."""
    if group == "g1":
        arr = FP.encode(list(coords))
    else:
        arr = np.stack([FP.encode([v[0] for v in coords]), FP.encode([v[1] for v in coords])],
                       axis=1)
    return torch.from_numpy(arr).to(device)


def edge_case_sums(group: str, case: str, device=None, seed: int = SEED):
    """(window sums, c) of one edge case of CASES: Jacobian points k G of
    the group at random Z, 3 x (12, W) for G1 or 3 x (12, 2, W) for G2."""
    windows, c = CASES[case]
    rs = np.random.default_rng([seed, list(CASES).index(case), int(group == "g2")])

    def rand(mod):
        return int.from_bytes(rs.bytes(48), "little") % (mod - 1) + 1

    gen, mul = ((g1_generator(), native.g1_mul) if group == "g1"
                else (g2_generator(), native.g2_mul))
    pts = [mul(gen, rand(R)) for _ in range(windows)]
    top = pts[-1]
    if case == "empty_top":
        pts[1] = pts[2] = None
    elif case == "all_infinite":
        pts = [None] * windows
    elif case in ("equal", "negated"):
        pts[1] = mul(top, 1 << c)
        if case == "negated":
            pts[1] = ec_neg(pts[1])
    elif case == "c1":
        pts[1] = None
    if group == "g1":
        zs = [rand(P) for _ in pts]
        inf_xy = [((rand(P), rand(P)) if case == "all_infinite" else (1, 1)) for _ in pts]
    else:
        zs = [Fp2.from_ints(rand(P), rand(P)) for _ in pts]
        inf_xy = [(((rand(P), rand(P)), (rand(P), rand(P))) if case == "all_infinite"
                   else ((1, 0), (1, 0))) for _ in pts]
    cols = list(zip(*(_jacobian(group, pt, z, xy) for pt, z, xy in zip(pts, zs, inf_xy))))
    return tuple(_to_tensor(group, col, device) for col in cols), c


def random_sums(group: str, windows: int, generator: torch.Generator):
    """3 coordinates of `windows` random non-zero field values below p
    (not points of the curve: the join's arithmetic and branches are the
    same for them), on the generator's device."""
    comps = 1 if group == "g1" else 2
    return tuple(peaks.random_elements(FP, windows * comps, generator)
                 .reshape((FP.W, windows, comps)).transpose(1, 2).contiguous()
                 .reshape((FP.W,) + ((windows,) if comps == 1 else (2, windows)))
                 for _ in range(3))


# ---- the one-thread chain, as K4 ran it before, and with the doubling inlined ----------

SERIAL_SOURCE = r"""
// The window join in one thread: kInline = false is K4 before its
// redesign (point.cuh's dbl, out of line); true inlines the doubling.
#include "point.cuh"

template <class E>
__device__ __forceinline__ Jac<E> dbl_inline(const Jac<E>& p) {
  const E a = sqr(p.x);
  const E b = sqr(p.y);
  const E c = sqr(b);
  const E t = sqr(add(p.x, b));
  E d = sub(sub(t, a), c);
  d = add(d, d);
  const E e = add(add(a, a), a);
  const E ff = sqr(e);
  Jac<E> out;
  out.x = sub(ff, add(d, d));
  E c8 = add(c, c);
  c8 = add(c8, c8);
  c8 = add(c8, c8);
  out.y = sub(mul(e, sub(d, out.x)), c8);
  const E yz = mul(p.y, p.z);
  out.z = add(yz, yz);
  return out;
}

template <class E, bool kInline>
__global__ void serial_join(uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                            uint32_t* __restrict__ oz, const uint32_t* __restrict__ sx,
                            const uint32_t* __restrict__ sy, const uint32_t* __restrict__ sz,
                            int windows, int c) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  Jac<E> acc = infinity<E>();
  for (int i = windows - 1; i >= 0; i--) {
    for (int k = 0; k < c; k++) {
      if (!is_zero(acc.z)) acc = kInline ? dbl_inline(acc) : dbl(acc);
    }
    acc = add_pts(acc, load_point<E>(sx, sy, sz, windows, i));
  }
  store_point<E>(ox, oy, oz, 1, 0, acc);
}

#if KZG_SERIAL_G2
using SerialE = Fp2E;
#else
using SerialE = FpE;
#endif

extern "C" int kzg_serial_join(int inline_dbl, void* ox, void* oy, void* oz, const void* sx,
                               const void* sy, const void* sz, int windows, int c,
                               void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto o = [](void* p) { return static_cast<uint32_t*>(p); };
  auto i = [](const void* p) { return static_cast<const uint32_t*>(p); };
  if (inline_dbl)
    serial_join<SerialE, true><<<1, 1, 0, s>>>(o(ox), o(oy), o(oz), i(sx), i(sy), i(sz),
                                               windows, c);
  else
    serial_join<SerialE, false><<<1, 1, 0, s>>>(o(ox), o(oy), o(oz), i(sx), i(sy), i(sz),
                                                windows, c);
  return (int)cudaGetLastError();
}
"""


def build_serial(group: str):
    """The one-thread variants of one group in a library of their own;
    returns (path, ptxas lines of serial_join)."""
    out_dir = kernels.BUILD_ROOT.parent / "horner_serial" / kernels.source_digest()
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "serial.cu"
    src.write_text(SERIAL_SOURCE)
    lib = out_dir / f"serial_{group}.so"
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, f"-DKZG_SERIAL_G2={int(group == 'g2')}",
           f"-I{kernels.CSRC}", "-shared", "-o", str(lib), str(src)]
    res = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if res.returncode != 0:
        raise kernels.KernelError(f"nvcc failed: {' '.join(cmd)}\n{res.stdout}")
    lines, live = [], False
    for line in res.stdout.splitlines():
        if "Compiling entry function" in line:
            live = "serial_join" in line
            if live:
                lines.append(line.strip())
        elif live and ("spill" in line or "Used" in line):
            lines.append(line.strip())
    return lib, lines


def cuda_ms(fn, iters=3):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join("build", "horner_bench.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("horner bench: a CUDA card is required", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    kernels.library()
    with ThreadPoolExecutor(max_workers=2) as pool:  # one nvcc a group, side by side
        built = dict(zip(("g1", "g2"), pool.map(build_serial, ("g1", "g2"))))
    libs = {}
    for group, (path, lines) in built.items():
        for line in lines:
            print(f"ptxas {group}: {line}", flush=True)
        lib = ctypes.CDLL(str(path))
        lib.kzg_serial_join.argtypes = ((ctypes.c_int,) + (ctypes.c_void_p,) * 6
                                        + (ctypes.c_int, ctypes.c_int, ctypes.c_void_p))
        lib.kzg_serial_join.restype = ctypes.c_int
        libs[group] = lib

    def serial(group, inline, s_all, c):
        out = [torch.empty(s_all[0].shape[:-1], dtype=torch.int32, device=dev) for _ in range(3)]
        rc = libs[group].kzg_serial_join(int(inline), *(t.data_ptr() for t in out),
                                         *(t.data_ptr() for t in s_all), s_all[0].shape[-1], c,
                                         kernels.stream_handle(dev))
        kernels.check_status(rc, f"serial join {group}")
        return tuple(out)

    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = []
    for group, windows, c in SHAPES:
        s_all = random_sums(group, windows, gen)
        want = cuda_ops.horner_join(s_all, c)
        for inline in (False, True):
            got = serial(group, inline, s_all, c)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                print(f"FAILED: serial join {group} inline={inline} differs from K4 at "
                      f"W={windows}, c={c}", file=sys.stderr)
                return 1
        fns = {"k4": lambda: cuda_ops.horner_join(s_all, c),
               "serial": lambda: serial(group, False, s_all, c),
               "serial_inline": lambda: serial(group, True, s_all, c)}
        times = {k: [] for k in fns}
        for k in ("k4", "serial", "serial_inline", "serial_inline", "serial", "k4"):
            times[k].append(cuda_ms(fns[k]))
        row = {"group": group, "windows": windows, "c": c,
               **{f"{k}_ms": sum(v) / len(v) for k, v in times.items()},
               "runs_ms": times}
        rows.append(row)
        print(f"{group} W={windows} c={c}: K4 {row['k4_ms']:.4f} ms, one thread (dbl out of "
              f"line) {row['serial_ms']:.4f} ms, one thread (dbl inlined) "
              f"{row['serial_inline_ms']:.4f} ms; all three equal [{card}]", flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "rows": rows, "ptxas": {g: b[1] for g, b in built.items()}}, f,
                  indent=1)
    print(json.dumps({"card": card, "rows": [{k: v for k, v in r.items() if k != "runs_ms"}
                                             for r in rows]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
