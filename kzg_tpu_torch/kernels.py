"""Build, load and account for the port's hand-written CUDA kernels.

All kernels live in `kzg_tpu_torch/csrc/` and are compiled by `nvcc` for
`sm_90a` into ONE shared library with a plain C interface, loaded through
`ctypes` (no PyTorch headers). Each source compiles to an object in its own
`nvcc` process, all started together, then one link makes the library. The
build runs at first use, into `build/kzg_tpu_torch/<hash of sources and
flags>/`, so a changed source never loads a stale library. Nothing here
runs at import time: the CPU tests import every module of the port.

Each kernel is described by a `Kernel` record in `REGISTRY`: its C entry
point, its source, the Pallas kernel it replaces, and `launches`, the count
its wrapper increments each time it launches the kernel on the card. K2's
`add` and `dbl` and K7's `madd_multi` run in two modes, picked by the
width (`curve.cuda_ops`): their records also name each mode's source and
count its launches apart. K6's `madd` is K7's narrow entry at S = 1 with a
record and a count of its own. K5 has two entries with a record each:
`ntt_block` (whole sub-transforms a launch, the Domain's route on the card)
and `ntt_stage` (one butterfly stage a launch, the route as it was).
`miller_loop` and `final_exp` replace no Pallas kernel but the reference's
K1 chains of the pairing; `replaces` names those.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "kzg_tpu_torch"
SOURCES = ("field_kernels.cu", "point_kernels.cu", "ntt_kernels.cu",
           "point_g2_kernels.cu", "madd_multi_g2_kernels.cu",
           "msm_g2_kernels.cu", "horner_g2_kernels.cu", "mxu_kernels.cu", "ladder_kernels.cu",
           "pointwise_g2_kernels.cu", "scan_kernels.cu", "pairing_kernels.cu")
HEADERS = ("field.cuh", "point.cuh", "coop.cuh", "horner.cuh", "horner_schedule.cuh",
           "pair.cuh", "ladder.cuh", "pointwise.cuh", "madd_multi.cuh", "scan.cuh",
           "ntt_block.cuh", "pairing.cuh", "pairing_schedule.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LIB_NAME = "libkzg_tpu_torch_kernels.so"


class KernelError(RuntimeError):
    """A kernel failed to build, was given tensors it does not take, or
    returned a non-zero CUDA status from its launch."""


@dataclass
class Kernel:
    name: str          # report name
    source: str        # repo path of the CUDA source
    replaces: str      # file:line of the Pallas kernel it replaces
    launches: int = 0  # launches on the card since the last reset
    modes: dict = field(default_factory=dict)  # mode -> repo path of its source
    mode_launches: dict = field(default_factory=dict)  # mode -> launches since the last reset

    def count(self, mode=None):
        """One launch on the card, in `mode` where the kernel has modes."""
        self.launches += 1
        if mode is not None:
            self.mode_launches[mode] = self.mode_launches.get(mode, 0) + 1


_CSRC = "kzg_tpu_torch/csrc/"


def _modes(name: str, replaces: str, narrow: str, wide: str) -> Kernel:
    """A record of a kernel in two modes (K2, K7): the narrow mode (two
    points or lanes a block on 16-lane products: pointwise.cuh,
    madd_multi.cuh) and the wide mode (point.cuh, one thread a point or
    lane), each in the source that instantiates it."""
    return Kernel(name, _CSRC + wide, replaces,
                  modes={"narrow": _CSRC + narrow, "wide": _CSRC + wide})


REGISTRY = {
    k.name: k
    for k in (
        Kernel("field_elementwise", "kzg_tpu_torch/csrc/field_kernels.cu",
               "kzg_tpu/fields/pallas_field.py:273"),
        _modes("g1_add", "kzg_tpu/curve/pallas_ops.py:712", "point_kernels.cu",
               "point_kernels.cu"),
        _modes("g1_dbl", "kzg_tpu/curve/pallas_ops.py:707", "point_kernels.cu",
               "point_kernels.cu"),
        Kernel("g1_bucket_accumulate", "kzg_tpu_torch/csrc/point_kernels.cu",
               "kzg_tpu/curve/pallas_ops.py:388"),
        Kernel("g1_horner_join", "kzg_tpu_torch/csrc/point_kernels.cu",
               "kzg_tpu/curve/pallas_ops.py:590"),
        Kernel("ntt_stage", "kzg_tpu_torch/csrc/ntt_kernels.cu",
               "kzg_tpu/fields/pallas_field.py:346"),
        # whole sub-transforms of make_ntt_stage's loop, bit reversal and scales fused
        Kernel("ntt_block", "kzg_tpu_torch/csrc/ntt_block.cuh",
               "kzg_tpu/fields/pallas_field.py:346"),
        # the ncomp=2 (Fp2) instantiations of _PointKernels.add / .dbl
        _modes("g2_add", "kzg_tpu/curve/pallas_ops.py:712", "pointwise_g2_kernels.cu",
               "point_g2_kernels.cu"),
        _modes("g2_dbl", "kzg_tpu/curve/pallas_ops.py:707", "pointwise_g2_kernels.cu",
               "point_g2_kernels.cu"),
        # _PointKernels.madd, ncomp=1 and 2: K7's narrow kernel at S = 1
        Kernel("g1_madd", "kzg_tpu_torch/csrc/madd_multi.cuh",
               "kzg_tpu/curve/pallas_ops.py:270"),
        Kernel("g2_madd", "kzg_tpu_torch/csrc/madd_multi.cuh",
               "kzg_tpu/curve/pallas_ops.py:270"),
        # _PointKernels.madd_multi, ncomp=1 and 2
        _modes("g1_madd_multi", "kzg_tpu/curve/pallas_ops.py:275", "point_kernels.cu",
               "point_kernels.cu"),
        _modes("g2_madd_multi", "kzg_tpu/curve/pallas_ops.py:275", "madd_multi_g2_kernels.cu",
               "madd_multi_g2_kernels.cu"),
        # the ncomp=2 instantiations of bucket_accumulate / horner_join
        Kernel("g2_bucket_accumulate", "kzg_tpu_torch/csrc/msm_g2_kernels.cu",
               "kzg_tpu/curve/pallas_ops.py:388"),
        Kernel("g2_horner_join", "kzg_tpu_torch/csrc/horner_g2_kernels.cu",
               "kzg_tpu/curve/pallas_ops.py:590"),
        # make_mul_chain: k dependent Montgomery products in one launch
        Kernel("mul_chain", "kzg_tpu_torch/csrc/field_kernels.cu",
               "kzg_tpu/fields/pallas_field.py:323"),
        # the reduce epilogue of the matmul-DFT NTT
        Kernel("mxu_reduce", "kzg_tpu_torch/csrc/mxu_kernels.cu",
               "kzg_tpu/ntt/mxu.py:135"),
        # pow_static's chain of elementwise products (LimbField.inv), one launch
        Kernel("field_pow", "kzg_tpu_torch/csrc/field_kernels.cu",
               "kzg_tpu/fields/pallas_field.py:295"),
        # the digit ladder's rounds of _PointKernels.dbl and .madd, one launch
        Kernel("g1_ladder", "kzg_tpu_torch/csrc/ladder_kernels.cu",
               "kzg_tpu/curve/pallas_ops.py:707"),
        Kernel("g2_ladder", "kzg_tpu_torch/csrc/ladder_kernels.cu",
               "kzg_tpu/curve/pallas_ops.py:707"),
        # the rounds of K1 launches of _prefix_scan / sum_last, a few tile passes
        Kernel("field_scan", "kzg_tpu_torch/csrc/scan_kernels.cu",
               "kzg_tpu/fields/pallas_field.py:295"),
        # the K1 chain of the linear division and the evaluation, a few tile passes
        Kernel("fr_horner", "kzg_tpu_torch/csrc/scan_kernels.cu",
               "kzg_tpu/fields/pallas_field.py:295"),
        # no Pallas kernel: the K1 chains of the reference's Miller loop and
        # final exponentiation, one launch each (pairing.cuh)
        Kernel("miller_loop", "kzg_tpu_torch/csrc/pairing_kernels.cu",
               "kzg_tpu/pairing/pairing.py:109"),
        Kernel("final_exp", "kzg_tpu_torch/csrc/pairing_kernels.cu",
               "kzg_tpu/pairing/pairing.py:163"),
    )
}


def reset_launches():
    for k in REGISTRY.values():
        k.launches = 0
        k.mode_launches = dict.fromkeys(k.modes, 0)


def launch_counts() -> dict:
    return {name: k.launches for name, k in REGISTRY.items()}


def mode_counts() -> dict:
    """Launches by mode of the kernels that have modes: {name: {mode: n}}."""
    return {name: {m: k.mode_launches.get(m, 0) for m in k.modes}
            for name, k in REGISTRY.items() if k.modes}


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise KernelError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def source_digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels unless this exact source set is already built.
    Returns the library path; the compiler's `-Xptxas -v` report (registers,
    spills) of every source, headed by the seconds its nvcc process took,
    is kept beside it as `ptxas.log`."""
    out_dir = BUILD_ROOT / source_digest()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = os.getpid()
    nvcc = _nvcc()
    objs = [out_dir / f"{Path(s).stem}.{tag}.o" for s in SOURCES]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", str(CSRC / s), "-o", str(o)]
            for s, o in zip(SOURCES, objs)]

    def compile_one(cmd):
        t0 = time.perf_counter()
        res = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        return res, time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=len(cmds)) as pool:  # one nvcc process each
        done = list(pool.map(compile_one, cmds))
    (out_dir / "ptxas.log").write_text(
        "".join(f"nvcc seconds {s}: {dt:.1f}\n{res.stdout}"
                for s, (res, dt) in zip(SOURCES, done)))
    for cmd, (res, _) in zip(cmds, done):
        if res.returncode != 0:
            raise KernelError(f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n{res.stdout}")
    tmp = out_dir / f"{LIB_NAME}.{tag}.tmp"
    cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", str(tmp),
           *map(str, objs)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise KernelError(f"nvcc link failed ({res.returncode}): {' '.join(cmd)}\n"
                          f"{res.stdout}{res.stderr}")
    for o in objs:
        o.unlink()
    os.replace(tmp, lib)  # atomic: a concurrent process never loads half a file
    return lib


_lib = None
_lib_lock = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_N = ctypes.c_longlong
_SIGNATURES = {
    # (field, op, out, a, b, n, stream)
    "kzg_field_binary": (_I, _I, _P, _P, _P, _N, _P),
    # (field, out, a, const words on the host, n, stream)
    "kzg_field_mul_const": (_I, _P, _P, _P, _N, _P),
    # (ox, oy, oz, x1, y1, z1, x2, y2, z2, n, stream)
    "kzg_g1_add": (_P,) * 9 + (_N, _P),
    # (ox, oy, oz, x, y, z, n, stream)
    "kzg_g1_dbl": (_P,) * 6 + (_N, _P),
    # G2: the same with (12, 2, n) coordinates
    "kzg_g2_add": (_P,) * 9 + (_N, _P),
    "kzg_g2_dbl": (_P,) * 6 + (_N, _P),
    # K2's narrow mode, two points a block: the same arguments
    "kzg_g1_add_narrow": (_P,) * 9 + (_N, _P),
    "kzg_g1_dbl_narrow": (_P,) * 6 + (_N, _P),
    "kzg_g2_add_narrow": (_P,) * 9 + (_N, _P),
    "kzg_g2_dbl_narrow": (_P,) * 6 + (_N, _P),
    # (out, x, twiddles, nb, m, bt, table length, stage, stream)
    "kzg_ntt_stage": (_P,) * 3 + (_N,) * 4 + (_I, _P),
    # (out, x, stage table, columns, log2 m, bt, out_bt, log2 cols, threads,
    #  pre hi, pre lo, pre mode, pre s, pre div, the same for post, stream)
    "kzg_ntt_block": (_P,) * 3 + (_N, _I, _N, _N, _I, _I) + ((_P, _P, _I, _I, _N) * 2)
                     + (_P,),
    # (ox, oy, oz, rows, order, sub-run pos, sub-run len, sub-runs, stream)
    "kzg_g1_bucket_accumulate": (_P,) * 7 + (_N, _P),
    # (ox, oy, oz, sx, sy, sz, windows, c, stream)
    "kzg_g1_horner_join": (_P,) * 6 + (_I, _I, _P),
    # G2: rows (n, 48), outputs (12, 2, W, B) / (12, 2)
    "kzg_g2_bucket_accumulate": (_P,) * 7 + (_N, _P),
    "kzg_g2_horner_join": (_P,) * 6 + (_I, _I, _P),
    # (ox, oy, oz, ax, ay, az, qx, qy, skip bytes, neg bytes or null, steps, n, stream);
    # the wide mode, one thread a lane, and the narrow mode, two lanes a block
    "kzg_g1_madd_multi": (_P,) * 10 + (_I, _N, _P),
    "kzg_g2_madd_multi": (_P,) * 10 + (_I, _N, _P),
    "kzg_g1_madd_multi_narrow": (_P,) * 10 + (_I, _N, _P),
    "kzg_g2_madd_multi_narrow": (_P,) * 10 + (_I, _N, _P),
    # (field, out, a, b, k, n, stream); the coop entry spreads each product over 16 lanes
    "kzg_field_mul_chain": (_I, _P, _P, _P, _I, _N, _P),
    "kzg_field_mul_chain_coop": (_I, _P, _P, _P, _I, _N, _P),
    # (out (8, n) words, digit sums (64, n) int32, n, stream)
    "kzg_mxu_reduce": (_P, _P, _N, _P),
    # (field, out, a, exponent words on the host, exponent bits, n, stream)
    "kzg_field_pow": (_I, _P, _P, _P, _I, _N, _P),
    # (ox, oy, oz, table x, table y, digits, p_inf bytes, windows, c, entries, lanes, stream)
    "kzg_g1_ladder": (_P,) * 7 + (_I, _I, _I, _N, _P),
    "kzg_g2_ladder": (_P,) * 7 + (_I, _I, _I, _N, _P),
    # (field, op, out, in, word / row / element strides, totals, carry, n, rows, reverse, stream)
    "kzg_field_scan": (_I, _I, _P, _P, _N, _N, _N, _P, _P, _N, _I, _I, _P),
    # (q, rem, totals, xpow, f, f word / row strides, x, carry in, tile carry, n, k, stream)
    "kzg_fr_horner": (_P,) * 5 + (_N, _N) + (_P,) * 3 + (_N, _I, _P),
    # (out, xp, yp, xq, yq, skip bytes or null, constants, n, stream)
    "kzg_miller_loop": (_P,) * 7 + (_N, _P),
    # (out, f, skip bytes or null, bit columns, columns, constants, n, product, stream)
    "kzg_final_exp": (_P,) * 4 + (_I, _P, _N, _I, _P),
}


def library():
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for fn, argtypes in _SIGNATURES.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _lib = lib
        return _lib


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """The SM count of CUDA device `device_index` (the launch rules' unit)."""
    import torch

    return torch.cuda.get_device_properties(device_index).multi_processor_count


def stream_handle(device):
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check_status(rc: int, what: str):
    if rc != 0:
        raise KernelError(f"{what}: CUDA launch status {rc}")
