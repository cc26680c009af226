"""Kernels K2-K4, K6 and K7: the point kernels, G1 and G2, and their plain twins.

The kernel templates live in `csrc/point.cuh` over the Montgomery
arithmetic of `csrc/field.cuh`; `csrc/point_kernels.cu` instantiates them
for G1 and, one source a kernel so that their long compilations run side by
side, `csrc/point_g2_kernels.cu` (add / dbl), `csrc/madd_g2_kernels.cu`,
`csrc/madd_multi_g2_kernels.cu`, `csrc/msm_g2_kernels.cu`
(bucket_accumulate) and `csrc/horner_g2_kernels.cu` for G2. G1
coordinates are limb-major (12, n) int32 words, G2 coordinates (12, 2, n)
(Fp2: c0 then c1 on axis 1).

Point rows, the layout of K3's affine input, fixed here once
(`point_rows`) and read by the kernel and its plain twin alike: row i is
point i's x words then its y words, contiguous. G1: 24 words, 96 bytes.
G2: x.c0, x.c1, y.c0, y.c1, 12 words each: 48 words, 192 bytes.

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

K3 / K4 over Fp2 (counted as `g2_bucket_accumulate`, `g2_horner_join`) are
the same templates instantiated for G2 (`pallas_ops.py:388,590` with ncomp = 2):
48-word rows, 3 x (12, 2, W, B) bucket sums; an empty bucket is infinity
and K4 keeps infinity fixed through its doublings. The 72-word accumulator
and 48-word point spill; accepted for a first version.

K6 `madd` / `g2_madd` replace `_PointKernels.madd` (`pallas_ops.py:270`,
`_madd_vals` `:122-156`): one thread per lane, Jacobian + affine under a
skip mask, precedence skip -> p, p infinite -> (x2, y2, 1), same -> dbl(p),
opposite -> (1, 1, 0). It is the body of the digit ladder
(`CurveOps.scalar_mul_digits`) behind the Lagrange-SRS group iNTT. Bound as
K2: one thread's chain of field multiplications (7M + 4S).

K7 `madd_multi` / `g2_madd_multi` replace `_PointKernels.madd_multi`
(`pallas_ops.py:275`): S skip-masked, optionally negated madds per bucket
lane in one launch, the fused step of the bucket loop that serves windows
of fewer than 1024 buckets (`msm.pippenger._bucket_loop`). The TPU kernel
revisited the accumulator block in VMEM across a minor grid axis of S
steps; here one thread per lane keeps the accumulator in registers and
reads step s's point from the step-major (12[, 2], S, B) batch, coalesced
over lanes. Bound: one thread's chain of up to S madds.

Each wrapper takes the plain twin for CPU tensors and launches its kernel
for CUDA tensors; `*_plain` are the twins, usable on any device.
"""

import math
from dataclasses import dataclass

import torch

from .. import kernels
from ..fields import FP
from .ops import CurveOps, Fp2Adapter

# the plain twins of the point kernels: the same formulas over plain field ops
PLAIN = CurveOps(FP.as_plain(), name="G1-plain")
PLAIN2 = CurveOps(Fp2Adapter(FP.as_plain()), name="G2-plain")

_W = FP.W  # 12 words per Fp coordinate


@dataclass(frozen=True)
class _Group:
    """One group's side of the point kernels: the leading (non-batch) axes
    of a coordinate, the plain curve of the twins, and per kernel the C
    entry's name and its launch counter."""

    name: str
    lead: tuple
    plain: CurveOps

    @property
    def words(self) -> int:
        """Words of one coordinate: 12 (Fp) or 24 (Fp2)."""
        return math.prod(self.lead)

    def entry(self, op: str):
        return getattr(kernels.library(), f"kzg_{self.name}_{op}")

    def counter(self, op: str):
        return kernels.REGISTRY[f"{self.name}_{op}"]


_G1K = _Group("g1", (_W,), PLAIN)
_G2K = _Group("g2", (_W, 2), PLAIN2)


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


# ---- K2 / K6: add, dbl, madd ---------------------------------------------------------

def _launch(group, op, coords, extra=()):
    """Launch a pointwise entry on the coordinates of one or two point
    batches ((*lead, *batch) each) plus `extra` flat (n,) operands;
    returns the (X, Y, Z) result."""
    what = f"{group.name}_{op}"
    lead = group.lead
    shape = coords[0].shape
    n = coords[0].numel() // group.words
    dev = coords[0].device
    ins = [_coord(t, dev, n, what, lead) for t in coords]
    for t in extra:
        if t.device != dev or t.numel() != n:
            raise kernels.KernelError(f"{what}: mask of {t.numel()} lanes on {t.device}")
    out = [torch.empty_like(ins[0]) for _ in range(3)]
    if n:
        rc = group.entry(op)(*_ptrs(out), *_ptrs(ins), *_ptrs(extra), n,
                             kernels.stream_handle(dev))
        kernels.check_status(rc, what)
        group.counter(op).launches += 1
    return tuple(o.reshape(shape) for o in out)


def _add(group, p, q):
    if _is_cpu(p[0]):
        return group.plain.add(p, q)
    return _launch(group, "add", (*p, *q))


def _dbl(group, p):
    if _is_cpu(p[0]):
        return group.plain.dbl(p)
    return _launch(group, "dbl", p)


def _madd(group, p, q_affine, skip):
    if _is_cpu(p[0]):
        return group.plain.madd(p, q_affine, skip)
    batch = p[0].shape[len(group.lead):]
    if skip.dtype != torch.bool or tuple(skip.shape) != tuple(batch):
        raise kernels.KernelError(
            f"{group.name}_madd: skip must be a bool {tuple(batch)} mask, got "
            f"{skip.dtype} {tuple(skip.shape)}"
        )
    q_affine = tuple(t.expand(p[0].shape) for t in q_affine)
    mask = skip.reshape(-1).contiguous().view(torch.uint8)
    return _launch(group, "madd", (*p, *q_affine), (mask,))


def add_plain(p, q):
    return PLAIN.add(p, q)


def dbl_plain(p):
    return PLAIN.dbl(p)


def madd_plain(p, q_affine, skip):
    return PLAIN.madd(p, q_affine, skip)


def add(p, q):
    """K2 Jacobian add-2007-bl (exceptional cases included), elementwise
    over equal-shaped G1 batches."""
    return _add(_G1K, p, q)


def dbl(p):
    """K2 Jacobian dbl-2009-l, elementwise over a G1 batch."""
    return _dbl(_G1K, p)


def madd(p, q_affine, skip):
    """K6 over Fp: Jacobian p + affine (x2, y2), elementwise over G1
    batches; `skip` is a batch-shaped bool mask (true keeps p)."""
    return _madd(_G1K, p, q_affine, skip)


def g2_add_plain(p, q):
    return PLAIN2.add(p, q)


def g2_dbl_plain(p):
    return PLAIN2.dbl(p)


def g2_madd_plain(p, q_affine, skip):
    return PLAIN2.madd(p, q_affine, skip)


def g2_add(p, q):
    """K2 over Fp2: G2 Jacobian add, elementwise over equal-shaped batches
    of (12, 2, *batch) coordinates."""
    return _add(_G2K, p, q)


def g2_dbl(p):
    """K2 over Fp2: G2 Jacobian dbl, elementwise."""
    return _dbl(_G2K, p)


def g2_madd(p, q_affine, skip):
    """K6 over Fp2: G2 Jacobian p + affine (x2, y2) under a skip mask."""
    return _madd(_G2K, p, q_affine, skip)


# ---- K7: the fused bucket-loop step ---------------------------------------------------

def _madd_multi(group, acc, q_affine, skip, neg):
    if _is_cpu(acc[0]):
        return group.plain.madd_multi(acc, q_affine, skip, neg)
    what = f"{group.name}_madd_multi"
    lead = group.lead
    shape = acc[0].shape
    batch = tuple(shape[len(lead):])
    dev = acc[0].device
    n = math.prod(batch)
    if skip.dim() != len(batch) + 1 or tuple(skip.shape[1:]) != batch:
        raise kernels.KernelError(
            f"{what}: skip must be a bool (S, {batch}) mask, got {tuple(skip.shape)}")
    steps = skip.shape[0]
    if neg is None:
        neg = torch.zeros_like(skip)
    for t in (skip, neg):
        if t.dtype != torch.bool or t.device != dev or t.shape != skip.shape:
            raise kernels.KernelError(
                f"{what}: masks must be bool {tuple(skip.shape)} on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")
    for t in q_affine:
        if tuple(t.shape) != lead + (steps,) + batch:
            raise kernels.KernelError(
                f"{what}: points must be {lead + (steps,) + batch}, got {tuple(t.shape)}")
    if not n or not steps:
        return acc
    ins = [_coord(t, dev, n, what, lead) for t in acc]
    ins += [_coord(t, dev, steps * n, what, lead) for t in q_affine]
    masks = [t.reshape(-1).contiguous().view(torch.uint8) for t in (skip, neg)]
    out = [torch.empty_like(ins[0]) for _ in range(3)]
    rc = group.entry("madd_multi")(*_ptrs(out), *_ptrs(ins), *_ptrs(masks), steps, n,
                                   kernels.stream_handle(dev))
    kernels.check_status(rc, what)
    group.counter("madd_multi").launches += 1
    return tuple(o.reshape(shape) for o in out)


def madd_multi_plain(acc, q_affine, skip, neg=None):
    return PLAIN.madd_multi(acc, q_affine, skip, neg)


def g2_madd_multi_plain(acc, q_affine, skip, neg=None):
    return PLAIN2.madd_multi(acc, q_affine, skip, neg)


def madd_multi(acc, q_affine, skip, neg=None):
    """K7 over Fp: acc += q_affine[s] for s = 0 .. S - 1, per lane. acc is a
    G1 Jacobian batch (12, *batch), q_affine = (qx, qy) of (12, S, *batch),
    skip / neg (S, *batch) bool masks (skip keeps the lane, neg adds -q;
    neg=None adds every point as it is)."""
    return _madd_multi(_G1K, acc, q_affine, skip, neg)


def g2_madd_multi(acc, q_affine, skip, neg=None):
    """K7 over Fp2: as `madd_multi` with (12, 2, *batch) accumulators and
    (12, 2, S, *batch) points."""
    return _madd_multi(_G2K, acc, q_affine, skip, neg)


# ---- K3: bucket accumulation ----------------------------------------------------------

def point_rows(xa, ya):
    """Affine coordinate batches -> K3's row table (see the module
    docstring): (n, 24) from (12, n) G1 words, (n, 48) from (12, 2, n) G2
    words with each coordinate's c0 words before its c1 words."""
    n = xa.shape[-1]

    def flat(t):
        return t.reshape(_W, n) if t.dim() == 2 else t.transpose(0, 1).reshape(2 * _W, n)

    return torch.cat([flat(xa), flat(ya)], dim=0).T.contiguous()


def _row_group(rows):
    for group in (_G1K, _G2K):
        if rows.dim() == 2 and rows.shape[1] == 2 * group.words:
            return group
    raise kernels.KernelError(f"point rows must be (n, 24) or (n, 48), got {tuple(rows.shape)}")


def rows_to_affine(q, batch):
    """(k, 24) or (k, 48) point rows -> the (x, y) coordinate batches of
    shape (*lead, *batch), k = prod(batch): the inverse of `point_rows`."""
    group = _row_group(q)
    k = q.shape[0]
    q = q.T.reshape((2,) + group.lead[::-1] + (k,))  # (x|y, [c,] word, k)
    if len(group.lead) == 2:
        q = q.transpose(1, 2)
    q = q.reshape((2,) + group.lead + tuple(batch))
    return q[0], q[1]


def bucket_accumulate_plain(rows, order, start, count):
    """Plain twin of K3 on any device, for G1 rows (n, 24) or G2 rows
    (n, 48): all (window, bucket) accumulators advance together, step k
    folding in the k-th point of every bucket's run (masked where
    k >= count), so each bucket sees its run in the same ascending order as
    the kernel's thread."""
    group = _row_group(rows)
    windows, buckets = start.shape
    n = order.shape[-1]
    acc = group.plain.infinity((windows, buckets), rows.device)
    steps = int(count.max()) if count.numel() else 0
    for k in range(steps):
        valid = count > k
        pos = (start + k).clamp(max=n - 1).to(torch.int64)
        idx = order.to(torch.int64).gather(1, pos)  # (W, B) point indices
        q = rows_to_affine(rows[idx.reshape(-1)], (windows, buckets))
        acc = group.plain.madd(acc, q, ~valid)
    return acc


def bucket_accumulate(rows, order, start, count):
    """K3: per (window, bucket), the sum of the affine points of the
    bucket's run; G1 or G2 by the row width.

    rows:  (n, 24) int32 for G1 or (n, 48) for G2 (`point_rows`);
    order: (W, n) int32, each window's stable sort of the points by digit;
    start, count: (W, B) int32, bucket b of window w is the run
           order[w, start : start + count] (callers zero bucket 0's count).
    Returns Jacobian bucket sums, 3 x (12, W, B) for G1 or 3 x (12, 2, W, B)
    for G2 (infinity where empty)."""
    if _is_cpu(rows):
        return bucket_accumulate_plain(rows, order, start, count)
    group = _row_group(rows)
    what = f"{group.name}_bucket_accumulate"
    dev = rows.device
    windows, buckets = start.shape
    n = rows.shape[0]
    for t, shape, name in ((rows, (n, 2 * group.words), "rows"), (order, (windows, n), "order"),
                           (start, (windows, buckets), "start"),
                           (count, (windows, buckets), "count")):
        if t.dtype != torch.int32 or t.device != dev or tuple(t.shape) != shape:
            raise kernels.KernelError(
                f"{what}: {name} must be int32 {shape} on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
            )
    ins = [t.contiguous() for t in (rows, order, start, count)]
    out = [torch.empty(group.lead + (windows, buckets), dtype=torch.int32, device=dev)
           for _ in range(3)]
    if windows * buckets:
        rc = group.entry("bucket_accumulate")(
            *_ptrs(out), *_ptrs(ins), windows, buckets, n, kernels.stream_handle(dev)
        )
        kernels.check_status(rc, what)
        group.counter("bucket_accumulate").launches += 1
    return tuple(out)


# ---- K4: Horner window join ---------------------------------------------------------------

def _sums_group(s_all):
    """Window sums are (12, W) for G1 and (12, 2, W) for G2."""
    return _G2K if s_all[0].dim() == 3 else _G1K


def horner_join_plain(s_all, c: int):
    """Plain twin of K4, G1 ((12, W) sums) or G2 ((12, 2, W))."""
    return _sums_group(s_all).plain.window_join(s_all, c)


def horner_join(s_all, c: int):
    """K4: sum_w 2^(c*w) * s_all[..., w] for Jacobian window sums, 3 x
    (12, W) for G1 or 3 x (12, 2, W) for G2 -> one Jacobian point,
    3 x (12,) or 3 x (12, 2)."""
    if _is_cpu(s_all[0]):
        return horner_join_plain(s_all, c)
    group = _sums_group(s_all)
    what = f"{group.name}_horner_join"
    dev = s_all[0].device
    windows = s_all[0].shape[-1]
    if s_all[0].dim() != len(group.lead) + 1:
        raise kernels.KernelError(f"{what}: window sums must be {group.lead + ('W',)}")
    ins = [_coord(t, dev, windows, what, group.lead) for t in s_all]
    out = [torch.empty(group.lead, dtype=torch.int32, device=dev) for _ in range(3)]
    rc = group.entry("horner_join")(
        *_ptrs(out), *_ptrs(ins), windows, c, kernels.stream_handle(dev)
    )
    kernels.check_status(rc, what)
    group.counter("horner_join").launches += 1
    return tuple(out)
