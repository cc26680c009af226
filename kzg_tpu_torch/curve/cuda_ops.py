"""Kernels K2-K4: the point kernels of the MSM, and their plain twins.

All three live in `csrc/point_kernels.cu` over the Montgomery arithmetic of
`csrc/field.cuh`. G1 coordinates are limb-major (12, n) int32 words, G2
coordinates (12, 2, n) (Fp2: c0 then c1 on axis 1).

K2 `add` / `dbl` (G1) and `g2_add` / `g2_dbl` (G2) replace
`_PointKernels.add` / `.dbl` (`kzg_tpu/curve/pallas_ops.py:712,707`, with
ncomp = 1 and 2; the group law of `:81-196`). One kernel template over the
coordinate type, one thread per point, the formulas and exceptional-case
selects verbatim (opposite -> (1, 1, 0), infinity operands pass the other
point through); the rare doubling inside `add` is a per-thread branch.
Bound: field multiplications (add-2007-bl is 11M + 5S, an Fp M being a
144-multiply CIOS and an Fp2 M three of them) and registers (a G2 point is
72 words, so the G2 kernels spill); on the TPU it was VMEM round trips of
limb planes, which the register-resident thread removes.

K3 `bucket_accumulate` replaces `_PointKernels.bucket_accumulate`
(`pallas_ops.py:388`). The TPU version walked one window per launch over a
sequential grid of 1024-bucket blocks, DMA-ing each bucket's sorted run in
8-point chunks. Here ONE launch covers every (window, bucket) with one
thread per bucket: the thread walks its run [start, start + count) of the
window's stable sort order and folds each affine point into a Jacobian
accumulator with madd-2007-bl (exceptional cases included), then writes the
bucket sum once. Points are read through the sort order from a row-major
(n, 24) table of x || y words, 96 contiguous bytes per point, instead of
from rows permuted per window: at 2^15 points the table is 3 MB and stays
in the 50 MB L2, so the indirect read costs no device-memory pass, where a
per-window permutation would write and read W copies of it. Bound: the
madd chain of the fullest bucket in each warp (~N / 2^c points) and
register pressure (36-word accumulator + 24-word point + temporaries,
`__launch_bounds__(128)`).

K4 `horner_join` replaces `_PointKernels.horner_join` (`pallas_ops.py:590`):
sum_w 2^(c*w) * S_w, MSB window first, c doublings (infinity kept fixed)
then one full add per window. The chain is sequential by nature; one
thread runs all W*(c+1) point ops with everything in registers (the TPU
version spent one 1024-lane tile per step computing the same value in
every lane). Bound: latency of the dependent Fp multiplications.

Each wrapper takes the plain twin for CPU tensors and launches its kernel
for CUDA tensors; `*_plain` are the twins, usable on any device.
"""

import math

import torch

from .. import kernels
from ..fields import FP
from .ops import CurveOps, Fp2Adapter

_ADD = kernels.REGISTRY["g1_add"]
_DBL = kernels.REGISTRY["g1_dbl"]
_BUCKETS = kernels.REGISTRY["bucket_accumulate"]
_HORNER = kernels.REGISTRY["horner_join"]
_ADD2 = kernels.REGISTRY["g2_add"]
_DBL2 = kernels.REGISTRY["g2_dbl"]

# the plain twins of the point kernels: the same formulas over plain field ops
PLAIN = CurveOps(FP.as_plain(), name="G1-plain")
PLAIN2 = CurveOps(Fp2Adapter(FP.as_plain()), name="G2-plain")

_W = FP.W  # 12 words per Fp coordinate


def _is_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise kernels.KernelError(f"no point kernel for device {t.device}")
    return False


def _coord(t: torch.Tensor, device, n: int, what: str, lead=(_W,)) -> torch.Tensor:
    """t as a contiguous (*lead, n) tensor, checked: (12, n) for G1
    coordinates, (12, 2, n) for G2."""
    if t.dtype != torch.int32 or t.device != device or tuple(t.shape[:len(lead)]) != lead:
        raise kernels.KernelError(
            f"{what}: expected int32 {lead + ('...',)} words on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}"
        )
    flat = t.reshape(lead + (-1,))
    if flat.shape[-1] != n:
        raise kernels.KernelError(f"{what}: batch {flat.shape[-1]} != {n}")
    return flat.contiguous()


def _ptrs(ts):
    return [t.data_ptr() for t in ts]


# ---- K2: add / dbl -----------------------------------------------------------------

def add_plain(p, q):
    return PLAIN.add(p, q)


def dbl_plain(p):
    return PLAIN.dbl(p)


def _launch(entry, counter, lead, coords, what):
    """Launch a pointwise K2 entry on the coordinates of one or two point
    batches ((*lead, *batch) each); returns the (X, Y, Z) result."""
    shape = coords[0].shape
    n = coords[0].numel() // math.prod(lead)
    dev = coords[0].device
    ins = [_coord(t, dev, n, what, lead) for t in coords]
    out = [torch.empty_like(ins[0]) for _ in range(3)]
    if n:
        rc = entry(*_ptrs(out), *_ptrs(ins), n, kernels.stream_handle(dev))
        kernels.check_status(rc, what)
        counter.launches += 1
    return tuple(o.reshape(shape) for o in out)


def add(p, q):
    """K2 Jacobian add-2007-bl (exceptional cases included), elementwise
    over equal-shaped G1 batches."""
    if _is_cpu(p[0]):
        return add_plain(p, q)
    return _launch(kernels.library().kzg_g1_add, _ADD, (_W,), (*p, *q), "g1_add")


def dbl(p):
    """K2 Jacobian dbl-2009-l, elementwise over a G1 batch."""
    if _is_cpu(p[0]):
        return dbl_plain(p)
    return _launch(kernels.library().kzg_g1_dbl, _DBL, (_W,), p, "g1_dbl")


def g2_add_plain(p, q):
    return PLAIN2.add(p, q)


def g2_dbl_plain(p):
    return PLAIN2.dbl(p)


def g2_add(p, q):
    """K2 over Fp2: G2 Jacobian add, elementwise over equal-shaped batches
    of (12, 2, *batch) coordinates."""
    if _is_cpu(p[0]):
        return g2_add_plain(p, q)
    return _launch(kernels.library().kzg_g2_add, _ADD2, (_W, 2), (*p, *q), "g2_add")


def g2_dbl(p):
    """K2 over Fp2: G2 Jacobian dbl, elementwise."""
    if _is_cpu(p[0]):
        return g2_dbl_plain(p)
    return _launch(kernels.library().kzg_g2_dbl, _DBL2, (_W, 2), p, "g2_dbl")


# ---- K3: bucket accumulation ----------------------------------------------------------

def bucket_accumulate_plain(rows, order, start, count):
    """Plain twin of K3 on any device: all (window, bucket) accumulators
    advance together, step k folding in the k-th point of every bucket's
    run (masked where k >= count), so each bucket sees its run in the same
    ascending order as the kernel's thread."""
    windows, buckets = start.shape
    n = order.shape[-1]
    acc = PLAIN.infinity((windows, buckets), rows.device)
    steps = int(count.max()) if count.numel() else 0
    for k in range(steps):
        valid = count > k
        pos = (start + k).clamp(max=n - 1).to(torch.int64)
        idx = order.to(torch.int64).gather(1, pos)  # (W, B) point indices
        q = rows[idx.reshape(-1)].T.reshape(2 * _W, windows, buckets)
        acc = PLAIN.madd(acc, (q[:_W], q[_W:]), ~valid)
    return acc


def bucket_accumulate(rows, order, start, count):
    """K3: per (window, bucket), the sum of the affine points of the
    bucket's run.

    rows:  (n, 24) int32, point i's x words then y words (affine);
    order: (W, n) int32, each window's stable sort of the points by digit;
    start, count: (W, B) int32, bucket b of window w is the run
           order[w, start : start + count] (callers zero bucket 0's count).
    Returns 3 x (12, W, B) Jacobian bucket sums (infinity where empty)."""
    if _is_cpu(rows):
        return bucket_accumulate_plain(rows, order, start, count)
    dev = rows.device
    windows, buckets = start.shape
    n = rows.shape[0]
    for t, shape, what in ((rows, (n, 2 * _W), "rows"), (order, (windows, n), "order"),
                           (start, (windows, buckets), "start"),
                           (count, (windows, buckets), "count")):
        if t.dtype != torch.int32 or t.device != dev or tuple(t.shape) != shape:
            raise kernels.KernelError(
                f"bucket_accumulate: {what} must be int32 {shape} on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
            )
    ins = [t.contiguous() for t in (rows, order, start, count)]
    out = [torch.empty((_W, windows, buckets), dtype=torch.int32, device=dev)
           for _ in range(3)]
    if windows * buckets:
        rc = kernels.library().kzg_g1_bucket_accumulate(
            *_ptrs(out), *_ptrs(ins), windows, buckets, n, kernels.stream_handle(dev)
        )
        kernels.check_status(rc, "bucket_accumulate")
        _BUCKETS.launches += 1
    return tuple(out)


# ---- K4: Horner window join ---------------------------------------------------------------

def horner_join_plain(s_all, c: int):
    return PLAIN.window_join(s_all, c)


def horner_join(s_all, c: int):
    """K4: sum_w 2^(c*w) * s_all[..., w] for 3 x (12, W) Jacobian window
    sums -> one Jacobian point, 3 x (12,)."""
    if _is_cpu(s_all[0]):
        return horner_join_plain(s_all, c)
    dev = s_all[0].device
    windows = s_all[0].shape[-1]
    if s_all[0].dim() != 2:
        raise kernels.KernelError("horner_join: window sums must be (12, W)")
    ins = [_coord(t, dev, windows, "horner_join") for t in s_all]
    out = [torch.empty((_W,), dtype=torch.int32, device=dev) for _ in range(3)]
    rc = kernels.library().kzg_g1_horner_join(
        *_ptrs(out), *_ptrs(ins), windows, c, kernels.stream_handle(dev)
    )
    kernels.check_status(rc, "horner_join")
    _HORNER.launches += 1
    return tuple(out)
