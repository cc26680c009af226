"""Kernels K2-K4, K6 and K7: the point kernels, G1 and G2, and their plain twins.

The kernel templates live in `csrc/point.cuh` over the Montgomery
arithmetic of `csrc/field.cuh`; `csrc/point_kernels.cu` instantiates them
for G1 and, one source a kernel so that their long compilations run side by
side, `csrc/point_g2_kernels.cu` (add / dbl),
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
ncomp = 1 and 2; the group law of `:81-196`), the formulas and
exceptional-case selects verbatim (opposite -> (1, 1, 0), infinity operands
pass the other point through). Two modes, picked by the width
(`width_mode`): most launches are narrow (the levels of the MSM's reductions
and combines, the ladder table's adds, the batched verify's
double-and-add), where one thread a point leaves the card nearly empty and
the time is one thread's chain of 144-step serial CIOS products. There the
NARROW kernel (`csrc/pointwise.cuh`) runs two points a block on the
digit ladder's engine: each level's products side by side, each product
over 16 lanes, so a point's time is its critical path of products. Once
the points fill more than `NARROW_WAVES` waves of it, the WIDE kernel takes
over (`csrc/point.cuh`): one thread a point, bound by the card's multiply
throughput, where the 16-lane product's extra instructions cost more than
they save. Registers: a G2 point is 72 words, so the wide G2 kernels
spill.

K3 `bucket_accumulate` replaces `_PointKernels.bucket_accumulate`
(`pallas_ops.py:388`). The TPU version walked one window per launch over a
sequential grid of 1024-bucket blocks, DMA-ing each bucket's sorted run in
8-point chunks, its trip count capped and skew sent to a segmented scan.
Here `msm.pippenger.split_runs` first cuts every bucket's run into
sub-runs of at most L points, L = max(16, ceil(n / B)) from the shapes
alone, and ranks them longest first; then ONE launch (`bucket_runs`)
covers every sub-run of every window with one thread each: the thread walks
its positions of the flattened sort order and folds each affine point into
a Jacobian accumulator with madd-2007-bl (exceptional cases included),
then writes its partial sum once; `msm.pippenger.combine_runs` adds the
partials of each cut bucket by a segmented pairwise tree on K2. Points are
read through the sort order from a row-major (n, 24) table of x || y
words, 96 contiguous bytes per point (192 over Fp2), instead of from rows
permuted per window. Bound: the madd chain, <= L madds a thread, and the
total, count.sum() madds at the card's multiply rate (K8 measures 1.54e10
Fp multiplications a second, so the ~20 M madds of a 2^20 MSM are ~15 ms).
Not memory: a madd reads one row for ~40 us of dependent arithmetic, even
at 2^20 where the 96 MB table exceeds the 50 MB L2, so there is no TMA or
cp.async stage to hide anything behind. Tensor cores do not apply to CIOS
on 32-bit words. Registers: G1 168 under `__launch_bounds__(128, 3)`, 92 B
spilled; G2 255, 580 B spilled (`csrc/point.cuh`, K3MinBlocks).

K4 `horner_join` replaces `_PointKernels.horner_join` (`pallas_ops.py:590`):
sum_w 2^(c*w) * S_w, MSB window first, c doublings (infinity kept fixed)
then one full add per window. The chain is sequential by nature and bound
by its latency. One block runs it (`csrc/horner.cuh`): its warps hold the
point in shared memory and run each level of the doubling's and the
addition's independent products side by side, from the program that
`curve.horner_schedule` generates, and each product, add and sub is
spread over 16 lanes, a word a lane (`csrc/coop.cuh`).

K3 / K4 over Fp2 (counted as `g2_bucket_accumulate`, `g2_horner_join`) are
the same templates instantiated for G2 (`pallas_ops.py:388,590` with ncomp = 2):
48-word rows, 3 x (12, 2, W, B) bucket sums; an empty bucket is infinity
and K4 keeps infinity fixed through its doublings. K3's 72-word accumulator
and 48-word point spill; accepted for a first version.

K6 `madd` / `g2_madd` replace `_PointKernels.madd` (`pallas_ops.py:270`,
`_madd_vals` `:122-156`): Jacobian + affine under a skip mask, precedence
skip -> p, p infinite -> (x2, y2, 1), same -> dbl(p), opposite -> (1, 1, 0).
They run K7's narrow kernel (`csrc/madd_multi.cuh`) at S = 1 with no neg
mask, which computes exactly this function (two lanes a block, each
product over 16 lanes), counted as K6. No path launches them: the digit
ladder runs its madd inside the ladder kernel.

K7 `madd_multi` / `g2_madd_multi` replace `_PointKernels.madd_multi`
(`pallas_ops.py:275`): S skip-masked, optionally negated madds per lane in
one launch, the fused step of the bucket loop that serves windows of fewer
than 1024 buckets (`msm.pippenger._bucket_loop`). The loop runs over the
sub-run lanes of `split_runs`, so it takes ceil(longest sub-run / S) <=
ceil(L / S) launches whatever the digits, then the same combine as K3. The
TPU kernel revisited the accumulator block in VMEM across a minor grid
axis of S steps. Here, as K2, two modes by the width (`width_mode`): the
bucket loop's lanes (a few thousand sub-runs) leave one thread a lane with
most SMs idle and each step's 11 products (29 over Fp2) in a serial chain,
so the NARROW kernel (`csrc/madd_multi.cuh`) runs two lanes a block on the
ladder's engine, the accumulator in shared slots across the steps, each
step's madd program over 16-lane products (5 / 7 products on the critical
path) and the next step's point copied in by cp.async while a step runs;
the WIDE kernel (`csrc/point.cuh`) keeps one thread a lane and
its accumulator in registers, once the lanes fill more than `NARROW_WAVES`
waves of the narrow one (loading the next step's point ahead only cost
registers there: `bench.madd_multi`'s sweep). Both read step
s's point from the step-major (12[, 2], S, M) batch and the (S, M) skip and
neg bytes (no neg array when no step is negated).

The digit ladder (`ladder`, counted as `g1_ladder` / `g2_ladder`,
`csrc/ladder.cuh`) runs the rounds of `CurveOps.scalar_mul_digits` in one
launch: for every lane W windows of c doublings (K2's `dbl`) and one
skip-masked mixed addition (K6's `madd`) with the affine table entry the
lane's digit selects, on K4's engine (two lanes a block, one a
half-warp, each level's products side by side, 16 lanes a product). It replaces, on that path, the
Pallas `dbl` / `madd` launches of `kzg_tpu/curve/ops.py:316-374`
(`pallas_ops.py:707,270`). Bound: each lane's chain of W (c + 1) dependent
point operations, and all lanes' products at the card's multiply rate.

Each wrapper takes the plain twin for CPU tensors and launches its kernel
for CUDA tensors; `*_plain` are the twins, usable on any device.
"""

import math
from dataclasses import dataclass

import torch

from .. import kernels
from ..fields import FP
from .horner_schedule import WARPS
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

    @property
    def ncomp(self) -> int:
        return len(self.lead)

    def entry(self, op: str):
        return getattr(kernels.library(), f"kzg_{self.name}_{op}")

    def counter(self, op: str):
        return kernels.REGISTRY[f"{self.name}_{op}"]

    # the curve interface `msm.pippenger.combine_runs` needs: K2 add (its
    # twin on CPU tensors) and infinity
    def add(self, p, q):
        return _add(self, p, q)

    def infinity(self, batch_shape=(), device=None):
        return self.plain.infinity(batch_shape, device)


_G1K = _Group("g1", (_W,), PLAIN)
_G2K = _Group("g2", (_W, 2), PLAIN2)


def _is_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise kernels.KernelError(f"no kernel for device {t.device}")
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

MODES = ("narrow", "wide")
# The most waves of the narrow kernel (SMs x its blocks an SM x 2 points or
# lanes) at which K2 or K7 takes it, by kernel: the crossover of
# `bench.pointwise` (K2) and `bench.madd_multi` (K7, S = 16), the most waves
# at which the narrow mode's device time was the shorter (H100).
NARROW_WAVES = {"g1_add": 3, "g1_dbl": 1, "g2_add": 16, "g2_dbl": 2,
                "g1_madd_multi": 2, "g2_madd_multi": 4}
_NARROW_LANES = 2  # points a block of the narrow kernel, one a half-warp


def narrow_min_blocks(ncomp: int) -> int:
    """Blocks of the narrow kernel an SM: its __launch_bounds__ minimum
    (`min_blocks` in csrc/ladder.cuh), 32 registers a thread for the
    program's warps."""
    return 65536 // (32 * 32 * WARPS[ncomp])


def pointwise_mode(n: int, sm_count: int, min_blocks: int, waves: int) -> str:
    """The mode for a launch of n points or lanes: "narrow" while they fit
    `waves` waves of the narrow kernel (sm_count x min_blocks blocks of two
    each), "wide" above."""
    return "narrow" if n <= waves * sm_count * min_blocks * _NARROW_LANES else "wide"


_sm_count = kernels.sm_count


def width_mode(group, op: str, n: int, device) -> str:
    """The mode kernel `op` of `group` takes for a launch of n points (K2
    "add" or "dbl") or bucket lanes (K7 "madd_multi") on a CUDA device."""
    return pointwise_mode(n, _sm_count(device.index if device.index is not None
                                       else torch.cuda.current_device()),
                          narrow_min_blocks(group.ncomp), NARROW_WAVES[f"{group.name}_{op}"])


def _pick_mode(group, op, n, device, mode):
    """`mode` checked, or the mode the width picks (mode None)."""
    if mode is None:
        return width_mode(group, op, n, device)
    if mode not in MODES:
        raise kernels.KernelError(f"{group.name}_{op}: mode {mode!r} is not one of {MODES}")
    return mode


def _launch(group, op, coords, extra=(), mode=None):
    """Launch a pointwise entry on the coordinates of one or two point
    batches ((*lead, *batch) each) plus `extra` flat (n,) operands, in K2's
    `mode` where it has one; returns the (X, Y, Z) result."""
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
        entry = group.entry(f"{op}_narrow" if mode == "narrow" else op)
        rc = entry(*_ptrs(out), *_ptrs(ins), *_ptrs(extra), n, kernels.stream_handle(dev))
        kernels.check_status(rc, what if mode is None else f"{what} ({mode})")
        group.counter(op).count(mode)
    return tuple(o.reshape(shape) for o in out)


def _k2(group, op, coords, mode):
    """K2 `op` in `mode`, or in the mode the width picks (mode None)."""
    mode = _pick_mode(group, op, coords[0].numel() // group.words, coords[0].device, mode)
    return _launch(group, op, coords, mode=mode)


def _add(group, p, q, mode=None):
    if _is_cpu(p[0]):
        return group.plain.add(p, q)
    return _k2(group, "add", (*p, *q), mode)


def _dbl(group, p, mode=None):
    if _is_cpu(p[0]):
        return group.plain.dbl(p)
    return _k2(group, "dbl", p, mode)


def _madd(group, p, q_affine, skip):
    if _is_cpu(p[0]):
        return group.plain.madd(p, q_affine, skip)
    lead = len(group.lead)
    batch = p[0].shape[lead:]
    if skip.dtype != torch.bool or tuple(skip.shape) != tuple(batch):
        raise kernels.KernelError(
            f"{group.name}_madd: skip must be a bool {tuple(batch)} mask, got "
            f"{skip.dtype} {tuple(skip.shape)}"
        )
    q_affine = tuple(t.expand(p[0].shape).unsqueeze(lead) for t in q_affine)
    return _madd_multi(group, p, q_affine, skip.unsqueeze(0), None, "narrow", counter="madd")


def add_plain(p, q):
    return PLAIN.add(p, q)


def dbl_plain(p):
    return PLAIN.dbl(p)


def madd_plain(p, q_affine, skip):
    return PLAIN.madd(p, q_affine, skip)


def add(p, q, mode=None):
    """K2 Jacobian add-2007-bl (exceptional cases included), elementwise
    over equal-shaped G1 batches; `mode` ("narrow" or "wide") overrides the
    one the width picks (`width_mode`)."""
    return _add(_G1K, p, q, mode)


def dbl(p, mode=None):
    """K2 Jacobian dbl-2009-l, elementwise over a G1 batch; `mode` as
    `add`."""
    return _dbl(_G1K, p, mode)


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


def g2_add(p, q, mode=None):
    """K2 over Fp2: G2 Jacobian add, elementwise over equal-shaped batches
    of (12, 2, *batch) coordinates; `mode` as `add`."""
    return _add(_G2K, p, q, mode)


def g2_dbl(p, mode=None):
    """K2 over Fp2: G2 Jacobian dbl, elementwise; `mode` as `add`."""
    return _dbl(_G2K, p, mode)


def g2_madd(p, q_affine, skip):
    """K6 over Fp2: G2 Jacobian p + affine (x2, y2) under a skip mask."""
    return _madd(_G2K, p, q_affine, skip)


# ---- K7: the fused bucket-loop step ---------------------------------------------------

def _mask_bytes(t: torch.Tensor) -> torch.Tensor:
    """A bool mask as contiguous bytes at a 4-byte aligned address: the
    narrow kernel copies the mask in 32-bit words, and a slice (`m[1:]` of
    an odd width) can start at any byte."""
    b = t.reshape(-1).contiguous().view(torch.uint8)
    return b if b.data_ptr() % 4 == 0 else b.clone()


def _madd_multi(group, acc, q_affine, skip, neg, mode=None, counter="madd_multi"):
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
    for t in (skip,) if neg is None else (skip, neg):
        if t.dtype != torch.bool or t.device != dev or t.shape != skip.shape:
            raise kernels.KernelError(
                f"{what}: masks must be bool {tuple(skip.shape)} on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")
    for t in q_affine:
        if tuple(t.shape) != lead + (steps,) + batch:
            raise kernels.KernelError(
                f"{what}: points must be {lead + (steps,) + batch}, got {tuple(t.shape)}")
    mode = _pick_mode(group, "madd_multi", n, dev, mode)
    if not n or not steps:
        return acc
    ins = [_coord(t, dev, n, what, lead) for t in acc]
    ins += [_coord(t, dev, steps * n, what, lead) for t in q_affine]
    masks = [None if t is None else _mask_bytes(t) for t in (skip, neg)]
    out = [torch.empty_like(ins[0]) for _ in range(3)]
    entry = group.entry("madd_multi_narrow" if mode == "narrow" else "madd_multi")
    rc = entry(*_ptrs(out), *_ptrs(ins), *(None if m is None else m.data_ptr() for m in masks),
               steps, n, kernels.stream_handle(dev))
    kernels.check_status(rc, f"{what} ({mode})")
    rec = group.counter(counter)
    rec.count(mode if rec.modes else None)
    return tuple(o.reshape(shape) for o in out)


def madd_multi_plain(acc, q_affine, skip, neg=None):
    return PLAIN.madd_multi(acc, q_affine, skip, neg)


def g2_madd_multi_plain(acc, q_affine, skip, neg=None):
    return PLAIN2.madd_multi(acc, q_affine, skip, neg)


def madd_multi(acc, q_affine, skip, neg=None, mode=None):
    """K7 over Fp: acc += q_affine[s] for s = 0 .. S - 1, per lane. acc is a
    G1 Jacobian batch (12, *batch), q_affine = (qx, qy) of (12, S, *batch),
    skip / neg (S, *batch) bool masks (skip keeps the lane, neg adds -q;
    neg=None adds every point as it is); `mode` ("narrow" or "wide")
    overrides the one the width picks (`width_mode`)."""
    return _madd_multi(_G1K, acc, q_affine, skip, neg, mode)


def g2_madd_multi(acc, q_affine, skip, neg=None, mode=None):
    """K7 over Fp2: as `madd_multi` with (12, 2, *batch) accumulators and
    (12, 2, S, *batch) points."""
    return _madd_multi(_G2K, acc, q_affine, skip, neg, mode)


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


def _runs_checked(rows, order, pos, length):
    """K3's operands, checked: rows (n, 24 | 48), order (W, n), pos /
    length (M,), all int32 on one device; positions into the flattened
    order must fit int32."""
    group = _row_group(rows)
    what = f"{group.name}_bucket_accumulate"
    n = rows.shape[0]
    windows = order.shape[0] if order.dim() == 2 else -1
    m = pos.numel()
    for t, shape, name in ((rows, (n, 2 * group.words), "rows"), (order, (windows, n), "order"),
                           (pos, (m,), "pos"), (length, (m,), "length")):
        if t.dtype != torch.int32 or t.device != rows.device or tuple(t.shape) != shape:
            raise kernels.KernelError(
                f"{what}: {name} must be int32 {shape} on {rows.device}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
            )
    if windows * n >= 1 << 31:
        raise kernels.KernelError(f"{what}: {windows} x {n} sort positions exceed int32")
    return group


def bucket_runs_plain(rows, order, pos, length):
    """Plain twin of K3 on any device, G1 rows (n, 24) or G2 rows (n, 48):
    all M sub-run accumulators advance together, step k folding in the
    k-th point of every sub-run (masked where k >= length), so each sees
    its points in the same ascending order as the kernel's thread."""
    group = _runs_checked(rows, order, pos, length)
    m = pos.numel()
    flat = order.reshape(-1).to(torch.int64)
    acc = group.plain.infinity((m,), rows.device)
    for k in range(int(length.max()) if m else 0):
        idx = flat[(pos.to(torch.int64) + k).clamp(max=flat.numel() - 1)]
        acc = group.plain.madd(acc, rows_to_affine(rows[idx], (m,)), length <= k)
    return acc


def bucket_runs(rows, order, pos, length):
    """K3: the sum of the affine points of each sub-run, one thread each.

    rows:   (n, 24) int32 for G1 or (n, 48) for G2 (`point_rows`);
    order:  (W, n) int32, each window's stable sort of the points by digit;
    pos, length: (M,) int32, sub-run i is the points order.flat[pos[i] :
            pos[i] + length[i]] (`msm.pippenger.split_runs`).
    Returns Jacobian partial sums, 3 x (12, M) for G1 or 3 x (12, 2, M) for
    G2 (infinity where a sub-run is empty)."""
    if _is_cpu(rows):
        return bucket_runs_plain(rows, order, pos, length)
    group = _runs_checked(rows, order, pos, length)
    m = pos.numel()
    out = [torch.empty(group.lead + (m,), dtype=torch.int32, device=rows.device)
           for _ in range(3)]
    if m:
        ins = [t.contiguous() for t in (rows, order, pos, length)]
        rc = group.entry("bucket_accumulate")(*_ptrs(out), *_ptrs(ins), m,
                                              kernels.stream_handle(rows.device))
        kernels.check_status(rc, f"{group.name}_bucket_accumulate")
        group.counter("bucket_accumulate").launches += 1
    return tuple(out)


def _bucket_sums(runs_fn, curve, rows, order, start, count, run_length):
    # the split and the combine live in the MSM layer, which imports this
    # module, so they are imported at the call
    from ..msm import pippenger

    runs = pippenger.split_runs(start, count, order.shape[-1], run_length)
    return pippenger.combine_runs(curve, runs_fn(rows, order, runs.pos, runs.length), runs)


def bucket_accumulate_plain(rows, order, start, count, run_length=None):
    """Plain twin of the K3 route on any device: the same split, the plain
    twin of K3 on the sub-runs, the same combine tree on plain adds."""
    return _bucket_sums(bucket_runs_plain, _row_group(rows).plain, rows, order, start, count,
                        run_length)


def bucket_accumulate(rows, order, start, count, run_length=None):
    """Per (window, bucket), the sum of the affine points of the bucket's
    run; G1 or G2 by the row width. The run is cut into sub-runs of at most
    L points (`msm.pippenger.split_runs`, L = `run_length` or the default
    from n and B), K3 sums every sub-run in one launch, and
    `msm.pippenger.combine_runs` adds the partials of each bucket on K2.

    rows, order as `bucket_runs`; start, count: (W, B) int32, bucket b of
    window w is the run order[w, start : start + count] (callers zero
    bucket 0's count). Returns Jacobian bucket sums, 3 x (12, W, B) for G1
    or 3 x (12, 2, W, B) for G2 (infinity where empty)."""
    return _bucket_sums(bucket_runs, _row_group(rows), rows, order, start, count, run_length)


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


# ---- the digit ladder -----------------------------------------------------------------

def _ladder_group(tx, p_inf):
    """Table coordinates are (12, T, *batch) for G1, (12, 2, T, *batch) for G2."""
    return _G2K if tx.dim() - p_inf.dim() == 3 else _G1K


def ladder_plain(tx, ty, p_inf, digits, c: int):
    """Plain twin of the ladder kernel, G1 or G2 by the table's shape: the
    rounds of `CurveOps.scalar_mul_digits` on the plain point formulas."""
    return _ladder_group(tx, p_inf).plain.ladder_rounds(tx, ty, p_inf, digits, c)


def ladder(tx, ty, p_inf, digits, c: int):
    """The digit ladder's rounds in one launch: per lane, from infinity, W
    windows (MSB first) of c doublings and one mixed addition of table entry
    digit - 1, skipped where the digit is 0 or p is infinite.

    tx, ty: the affine multiples 1 .. 2^c - 1 of each lane's point,
            (12, T, *batch) for G1 or (12, 2, T, *batch) for G2
            (`CurveOps.ladder_table`);
    p_inf:  (*batch) bool, the lanes whose point is infinite;
    digits: (W, *batch) integers in [0, 2^c).
    Returns the Jacobian (X, Y, Z), 3 x (12[, 2], *batch)."""
    if _is_cpu(tx):
        return ladder_plain(tx, ty, p_inf, digits, c)
    group = _ladder_group(tx, p_inf)
    what = f"{group.name}_ladder"
    dev = tx.device
    if not 1 <= c <= 16:
        raise kernels.KernelError(f"{what}: window {c} outside [1, 16]")
    batch = tuple(p_inf.shape)
    n = math.prod(batch)
    t_count = (1 << c) - 1
    for t in (tx, ty):
        if tuple(t.shape) != group.lead + (t_count,) + batch:
            raise kernels.KernelError(
                f"{what}: table must be {group.lead + (t_count,) + batch}, got {tuple(t.shape)}")
    if (p_inf.dtype != torch.bool or p_inf.device != dev or digits.device != dev
            or tuple(digits.shape[1:]) != batch or digits.dtype.is_floating_point):
        raise kernels.KernelError(
            f"{what}: p_inf must be bool {batch} and digits integer (W, {batch}) on {dev}")
    windows = digits.shape[0]
    if not windows or not n:
        return group.plain.infinity(batch, dev)
    tab = [_coord(t, dev, t_count * n, what, group.lead) for t in (tx, ty)]
    dig = digits.reshape(windows, n).to(torch.int32).contiguous()
    mask = p_inf.reshape(-1).contiguous().view(torch.uint8)
    out = [torch.empty(group.lead + (n,), dtype=torch.int32, device=dev) for _ in range(3)]
    rc = group.entry("ladder")(*_ptrs(out), *_ptrs(tab), dig.data_ptr(), mask.data_ptr(),
                               windows, c, t_count, n, kernels.stream_handle(dev))
    kernels.check_status(rc, what)
    group.counter("ladder").launches += 1
    return tuple(o.reshape(group.lead + batch) for o in out)
