"""Pippenger multi-scalar multiplication over G1 and G2 (port of
`kzg_tpu/msm/pippenger.py`, the `msm_impl="runs"` structure).

  * scalars are cut into c-bit window digits (`_digits`);
  * per window, points are stably sorted by digit (`torch.argsort`) so each
    bucket's points form one run of the sort order; `torch.searchsorted`
    finds every run; points at infinity are forced into bucket 0, and
    bucket 0's count is zeroed;
  * the buckets are accumulated as the reference's `msm_impl="runs"` does:
    with 1024 buckets a window or more (c >= 10, from 2^15 points), kernel
    K3 accumulates every bucket of every window in ONE launch; with fewer
    (`:480-481`), the reference's v1 bucket loop (`:234-345`) runs on
    kernel K7, `madd_multi`: step k adds the k-th point of every bucket's
    run, `msm_fuse_steps` steps to a launch (`_bucket_loop`);
  * the bucket reduction sum_b b * B_b (`weighted_bucket_sum`) and the
    point sums are the pairwise tree forms of the JAX package's kernel path
    (`:159-231`), on kernel K2;
  * kernel K4 joins the windows (Horner, MSB first).

Deviations from the reference:
  * the bucket loop advances the buckets of ALL windows together (the
    reference scans the windows one by one, a window's 128 to 512 buckets
    to a launch), and gathers its points through the sort order from the
    one row table instead of from rows permuted per window. Points at
    infinity get digit 0, as in the runs structure, so the rows carry no
    infinity column.
  * no capped-trip segmented-scan fallback (`:262,309-340`, `:546-571`). On
    the TPU a grid block runs to the maximum trip count of its buckets, so
    skewed digits cost the whole block; on the GPU a skewed bucket only
    slows its own thread, never the result. The bucket loop pays for skew
    in launches: its trip count is the fullest bucket's.
Below small_msm_threshold points a batched double-and-add ladder on K2 plus
a tree sum is used (`_msm_small`), as in the reference. MSMs are not chunked
above 2^msm_chunk_log points yet (the reference's `:818-833`).

G2 (`msm_g2`) takes the same two routes with the same window rule as the
reference's `msm()`: the ladder below small_msm_threshold points, the
bucket method on the Fp2 instantiations of K7 or K3, and K4, at and above
it.
"""

import math

import torch

from ..config import get_config
from ..curve import G1, G2, cuda_ops
from ..fields import FR


def pick_window(n: int) -> int:
    """Window size heuristic of the JAX package: bucket count ~ N/64,
    clamped to [2, 16] (swept there on a TPU; not yet re-derived on the
    H100)."""
    if n <= 16:
        return 2
    return max(2, min(16, int(math.log2(n)) - 6))


def effective_window(n: int) -> int:
    """The window msm() uses when the caller passes c=None: the configured
    override, else pick_window bumped one up, as the reference's runs
    implementation does (c = 10 at 2^15 points, c = 5 at 2^10)."""
    cfg = get_config()
    if cfg.msm_window is not None:
        return cfg.msm_window
    return min(16, pick_window(n) + 1)


def _std_words64(scalars_std: torch.Tensor) -> torch.Tensor:
    """(8, N) int32 standard-form scalar words -> unsigned values in int64."""
    return scalars_std.to(torch.int64) & 0xFFFFFFFF


def _digits(scalars_std: torch.Tensor, c: int) -> torch.Tensor:
    """(W, N) int64 window digits of (8, N) standard-form scalar words,
    least significant window first; W = ceil(256 / c)."""
    words = _std_words64(scalars_std)
    nbits = 32 * FR.W
    mask = (1 << c) - 1
    rows = []
    for w in range(-(-nbits // c)):
        bit = w * c
        word, off = bit // 32, bit % 32
        d = words[word] >> off
        if off + c > 32 and word + 1 < FR.W:
            d = d | (words[word + 1] << (32 - off))
        rows.append(d & mask)
    return torch.stack(rows)


def _scalar_bits(scalars_std: torch.Tensor) -> torch.Tensor:
    """(256, N) 0/1 rows, LSB first."""
    words = _std_words64(scalars_std)
    shifts = torch.arange(32, device=words.device)
    return ((words[:, None, :] >> shifts[None, :, None]) & 1).reshape(-1, words.shape[-1])


def point_sum(curve, p):
    """Sum of a batch of points along the last axis -> batch-() point:
    pairwise halving tree, n - 1 adds in log2(n) batched launches."""
    n = p[0].shape[-1]
    while n > 1:
        half = n // 2
        lo = tuple(t[..., :half] for t in p)
        hi = tuple(t[..., half:2 * half] for t in p)
        s = curve.add(lo, hi)
        if n % 2:
            s = tuple(torch.cat([a, t[..., -1:]], dim=-1) for a, t in zip(s, p))
        p = s
        n = s[0].shape[-1]
    return tuple(t[..., 0] for t in p)


def weighted_bucket_sum(curve, buckets):
    """S = sum_b b * B_b over the last axis (bucket index = weight), for
    every leading window at once.

    Pairwise fold: with T_i = B_2i + B_2i+1 and O_i = B_2i+1,
    S(B) = 2 * S(T) + sum(O), unrolled S = sum_l 2^l * sum(O_l). The odd
    elements of every level are concatenated level-ascending; the tail of
    levels >= l is doubled once per l; one tree sum finishes (~3n adds in
    ~3 log n launches)."""
    n = buckets[0].shape[-1]
    if n & (n - 1):
        raise ValueError("bucket count must be a power of two")
    parts, widths = [], []
    p = buckets
    while n > 1:
        even = tuple(t[..., 0::2] for t in p)
        odd = tuple(t[..., 1::2] for t in p)
        parts.append(odd)
        widths.append(n // 2)
        p = curve.add(even, odd)
        n //= 2
    q = tuple(torch.cat([pt[i] for pt in parts], dim=-1) for i in range(3))
    off = 0
    for l in range(1, len(widths)):
        off += widths[l - 1]
        head = tuple(t[..., :off] for t in q)
        tail = curve.dbl(tuple(t[..., off:] for t in q))
        q = tuple(torch.cat([h, t_], dim=-1) for h, t_ in zip(head, tail))
    return point_sum(curve, q)


def _msm_small(curve, xa, ya, inf, scalars_std):
    """Small batches: every point times its own scalar with one batched
    double-and-add ladder, then a tree sum."""
    bits = _scalar_bits(scalars_std)
    base = curve.select(inf, curve.infinity(inf.shape, xa.device), curve.from_affine(xa, ya))
    return point_sum(curve, curve.scalar_mul_bits(base, bits))


def bucket_inputs(xa, ya, inf, scalars_std, c: int):
    """The arrays kernel K3 and the bucket loop take for one MSM: (rows,
    order, start, count).

    rows (n, 24) for G1 or (n, 48) for G2 (`cuda_ops.point_rows`): each
    point's x then y words; order (W, n): each window's
    stable sort of the points by digit; start / count (W, B): bucket b of
    window w is order[w, start : start + count]. Points at infinity get
    digit 0 and bucket 0's count is zeroed, so neither contributes."""
    digits = _digits(scalars_std, c)
    digits = torch.where(inf[None], 0, digits)
    windows = digits.shape[0]
    buckets = 1 << c
    order = torch.argsort(digits, dim=-1, stable=True)
    ds = torch.gather(digits, 1, order)
    ids = torch.arange(buckets, device=xa.device).expand(windows, buckets).contiguous()
    start = torch.searchsorted(ds, ids, side="left")
    count = torch.searchsorted(ds, ids, side="right") - start
    count[:, 0] = 0
    rows = cuda_ops.point_rows(xa, ya)
    return rows, order.to(torch.int32), start.to(torch.int32), count.to(torch.int32)


# K3 serves windows of at least this many buckets; smaller windows take the
# bucket loop on K7, as in the reference (`:478-481`)
RUNS_MIN_BUCKETS = 1024


def loop_chunk(rows, order, start, count, k0: int, fuse: int):
    """Steps k0 .. k0 + fuse - 1 of the bucket loop as `madd_multi` takes
    them: the affine points (x, y) of shape (12[, 2], S, W, B), point s of
    lane (w, b) being the (k0 + s)-th of that bucket's run (a clamped, masked
    read past its end), and the (S, W, B) skip mask k0 + s >= count."""
    windows, buckets = start.shape
    n = order.shape[-1]
    ks = (k0 + torch.arange(fuse, device=rows.device))[:, None, None]
    pos = (start[None] + ks).clamp(max=n - 1).to(torch.int64)
    idx = torch.gather(order.to(torch.int64).expand(fuse, windows, n), 2, pos)
    q = cuda_ops.rows_to_affine(rows[idx.reshape(-1)], (fuse, windows, buckets))
    return q, ks >= count[None]


def _bucket_loop(curve, rows, order, start, count):
    """The v1 bucket loop on K7: Jacobian bucket sums, 3 x (12[, 2], W, B),
    from the arrays of `bucket_inputs`. Step k folds the k-th point of every
    (window, bucket) run into its accumulator, masked where k >= count;
    `msm_fuse_steps` steps' points are gathered at once and added by one
    `madd_multi` launch. The trip count is the fullest bucket's (one read
    of the device)."""
    fuse = get_config().msm_fuse_steps
    acc = curve.infinity(tuple(start.shape), rows.device)
    steps = int(count.max()) if count.numel() else 0
    for k0 in range(0, steps, fuse):
        q, skip = loop_chunk(rows, order, start, count, k0, fuse)
        acc = curve.madd_multi(acc, q, skip)
    return acc


def _msm_runs(curve, xa, ya, inf, scalars_std, c: int):
    inputs = bucket_inputs(xa, ya, inf, scalars_std, c)
    if (1 << c) < RUNS_MIN_BUCKETS:
        acc = _bucket_loop(curve, *inputs)
    else:
        acc = curve.bucket_accumulate(*inputs)
    s_all = weighted_bucket_sum(curve, acc)  # 3 x (12, W)
    return curve.window_join(s_all, c)


def msm(curve, points, scalars_mont, c: int | None = None):
    """MSM: points = (x, y, inf_mask) affine batch ((12, N) words for G1,
    (12, 2, N) for G2), scalars (8, N) in Montgomery form. Returns one
    Jacobian point."""
    xa, ya, inf = points
    n = xa.shape[-1]
    if scalars_mont.shape[-1] != n:
        raise ValueError(f"{n} points but {scalars_mont.shape[-1]} scalars")
    if c is None:
        c = effective_window(n)
    small = n < get_config().small_msm_threshold
    scalars_std = FR.from_mont(scalars_mont)
    if small:
        return _msm_small(curve, xa, ya, inf, scalars_std)
    return _msm_runs(curve, xa, ya, inf, scalars_std, c)


def msm_g1(points, scalars_mont, c: int | None = None):
    return msm(G1, points, scalars_mont, c)


def msm_g2(points, scalars_mont, c: int | None = None):
    return msm(G2, points, scalars_mont, c)
