"""Pippenger multi-scalar multiplication over G1 and G2 (port of
`kzg_tpu/msm/pippenger.py`, the `msm_impl="runs"` structure).

  * scalars are cut into c-bit window digits (`_digits`);
  * per window, points are stably sorted by digit (`torch.argsort`) so each
    bucket's points form one run of the sort order; `torch.searchsorted`
    finds every run; points at infinity are forced into bucket 0, and
    bucket 0's count is zeroed;
  * every bucket's run is cut into sub-runs of at most L consecutive
    positions (`split_runs`; L from the point and bucket counts only,
    `default_run_length`), so no serial chain is longer than L whatever
    the digits;
  * the sub-runs are summed as the reference's `msm_impl="runs"` routes its
    buckets: with 1024 buckets a window or more (c >= 10, from 2^15
    points), kernel K3 sums every sub-run of every window in ONE launch;
    with fewer (`:480-481`), the reference's v1 bucket loop (`:234-345`)
    runs on kernel K7, `madd_multi`, over the sub-run lanes: step k adds
    the k-th point of every sub-run, `msm_fuse_steps` steps to a launch,
    ceil(L / msm_fuse_steps) launches at most (`_bucket_loop`);
  * a bucket's sum is a segmented pairwise tree over its sub-runs' partial
    sums on kernel K2 (`combine_runs`), the same tree on both routes;
  * the bucket reduction sum_b b * B_b (`weighted_bucket_sum`) and the
    point sums are the pairwise tree forms of the JAX package's kernel path
    (`:159-231`), on kernel K2;
  * kernel K4 joins the windows (Horner, MSB first).

Deviations from the reference:
  * the bucket loop advances the sub-runs of ALL windows together (the
    reference scans the windows one by one, a window's 128 to 512 buckets
    to a launch), and gathers its points through the sort order from the
    one row table instead of from rows permuted per window. Points at
    infinity get digit 0, as in the runs structure, so the rows carry no
    infinity column.
  * skew is bounded by the split, not by the reference's capped trip count
    and its segmented-scan fallback (`:262,309-340`, `:508`, `:546-573`): a
    bucket of m points is ceil(m / L) chains of at most L madds, run side
    by side, then ceil(log2(m / L)) batched adds, in every window and on
    both routes, so there is no second path to switch to. The sub-runs are
    ranked longest first, so the threads of a warp run equal trip counts:
    the reference's occupancy ranking (`:529-540`), done for warps.
Below small_msm_threshold points every point is multiplied by its own
scalar with the batched digit ladder (a table on K2, the rounds in one
ladder launch) and the products summed by a tree on K2 (`_msm_small`); the
reference runs a double-and-add ladder there, the same point. Above
2^msm_chunk_log points an MSM runs as one MSM a chunk of 2^msm_chunk_log
points, each with its own window, the Jacobian partials summed by K2
`add` (the reference's `:818-833`): the digits, sort and row table are one
chunk's.

G2 (`msm_g2`) takes the same two routes with the same window rule as the
reference's `msm()`: the ladder below small_msm_threshold points, the
bucket method on the Fp2 instantiations of K7 or K3, and K4, at and above
it.
"""

import math
from dataclasses import dataclass

import torch

from ..config import get_config
from ..curve import G1, G2, cuda_ops
from ..fields import FR


# the digit ladder's window below small_msm_threshold points and in the
# device verify's scalar multiplications (PERF.md §6 row 8b measured the
# ladder at c = 4)
SMALL_MSM_WINDOW = 4


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


def _std_digits_msb(std: torch.Tensor, c: int, w_count: int) -> torch.Tensor:
    """MSB-first base-2^c digit rows (w_count, n) int64 from (8, n)
    standard-form 32-bit scalar words. The reference reads 16-bit limbs
    (`kzg_tpu/kzg/eval_form.py:90-102`); the digits are the same integers'
    windows. Unlike `_digits` this is MSB first, the order the digit ladder
    (`CurveOps.scalar_mul_digits`) takes."""
    words = _std_words64(std)
    mask = (1 << c) - 1
    rows = []
    for w in range(w_count - 1, -1, -1):
        bit = w * c
        word, off = bit // 32, bit % 32
        row = words[word] >> off
        if off + c > 32 and word + 1 < FR.W:
            row = row | (words[word + 1] << (32 - off))
        rows.append(row & mask)
    return torch.stack(rows)


def _host_digits_msb(value: int, c: int, nbits: int = 255) -> list:
    """MSB-first base-2^c digits of a host int (width ceil(nbits/c))."""
    w_count = -(-nbits // c)
    mask = (1 << c) - 1
    return [(value >> (c * w)) & mask for w in range(w_count - 1, -1, -1)]


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
    digit ladder (`CurveOps.scalar_mul_digits` at c = SMALL_MSM_WINDOW over
    all 256 bits of the words: a table of 2^c - 1 multiples, then one
    ladder launch on a card), then a tree sum. The reference runs
    `scalar_mul_bits` (`kzg_tpu/msm/pippenger.py:80-87`); the sum is the
    same point."""
    c = SMALL_MSM_WINDOW
    digits = _std_digits_msb(scalars_std, c, -(-32 * FR.W // c))
    base = curve.select(inf, curve.infinity(inf.shape, xa.device), curve.from_affine(xa, ya))
    return point_sum(curve, curve.scalar_mul_digits(base, digits, c))


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

# L = max(RUN_MIN, RUN_MEAN_FACTOR * ceil(n / B)) (`default_run_length`)
RUN_MIN = 16
RUN_MEAN_FACTOR = 1


def default_run_length(n: int, buckets: int, factor: int = RUN_MEAN_FACTOR) -> int:
    """L, the longest serial madd chain of an MSM of n points over `buckets`
    buckets a window: `factor` times the mean bucket, at least RUN_MIN.
    From the shapes only, as the reference derives its trip cap (`:508`),
    so both routes, whatever `msm_fuse_steps` is, cut the same sub-runs.
    1x, 2x and 4x the mean were timed on an H100 (`bench.runs_sweep`,
    PERF.md): 1x was fastest where the sub-runs fit the card in about one
    wave (2^12 and 2^15 points) and tied at 2^20, where a balanced window's
    buckets, split about half the time at 1x, cost a combine level."""
    return max(RUN_MIN, factor * -(-n // buckets))


@dataclass(frozen=True)
class Runs:
    """The bucket runs of one MSM cut into M sub-runs (`split_runs`),
    longest first: sub-run i is the `length[i]` positions from `pos[i]` of
    the flattened (W * n) sort order, a piece of bucket `bucket[i]` (flat
    index w * B + b). The combine's plan: `single` lists the sub-runs that
    are a whole bucket; `multi` those of the buckets cut in more than one,
    bucket by bucket in run order, with `rank` each one's place in its
    bucket and `size` that bucket's count of sub-runs."""

    pos: torch.Tensor      # (M,) int32
    length: torch.Tensor   # (M,) int32, 1 .. L, non-increasing
    bucket: torch.Tensor   # (M,) int64
    single: torch.Tensor   # int64 indices into the M sub-runs
    multi: torch.Tensor    # (K,) int64 indices into the M sub-runs
    rank: torch.Tensor     # (K,) int64
    size: torch.Tensor     # (K,) int64
    windows: int
    buckets: int
    run_length: int        # L
    longest: int           # the longest sub-run (the bucket loop's trip count)
    max_split: int         # the most sub-runs of one bucket


def split_runs(start, count, n: int, run_length: int | None = None) -> Runs:
    """Cut every run order[w, start : start + count] (the (W, B) arrays of
    `bucket_inputs`, n points a window) into sub-runs of at most L
    consecutive positions, L = `default_run_length(n, B)` unless given.
    The one split of both routes and of both plain twins; the counts are
    read to the host once, to size the arrays."""
    windows, buckets = start.shape
    limit = default_run_length(n, buckets) if run_length is None else run_length
    if limit < 1:
        raise ValueError(f"run length must be >= 1, got {limit}")
    dev = start.device
    cnt = count.reshape(-1).to(torch.int64)
    m = (cnt + limit - 1) // limit  # sub-runs of each bucket
    if cnt.numel():
        total, longest, max_split = torch.stack([m.sum(), cnt.max(), m.max()]).tolist()
    else:
        total = longest = max_split = 0
    bucket = torch.repeat_interleave(torch.arange(cnt.numel(), device=dev), m,
                                     output_size=total)
    j = torch.arange(total, device=dev) - (torch.cumsum(m, 0) - m)[bucket]  # place in bucket
    base = start.to(torch.int64) + n * torch.arange(windows, device=dev)[:, None]
    pos = base.reshape(-1)[bucket] + j * limit
    length = torch.clamp(cnt[bucket] - j * limit, max=limit)
    # longest first: full sub-runs, then the tails; stable, so a bucket's
    # full sub-runs keep their run order
    perm = torch.argsort(length, descending=True, stable=True)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(total, device=dev)
    cut = m[bucket] > 1
    multi = cut.nonzero().squeeze(1)  # bucket-major, j ascending
    return Runs(pos=pos[perm].to(torch.int32), length=length[perm].to(torch.int32),
                bucket=bucket[perm], single=inv[(~cut).nonzero().squeeze(1)],
                multi=inv[multi], rank=j[multi], size=m[bucket[multi]],
                windows=windows, buckets=buckets, run_length=limit,
                longest=min(limit, longest), max_split=max_split)


def combine_runs(curve, partial, runs: Runs):
    """Bucket sums 3 x (lead, W, B), infinity where a bucket is empty, from
    the sub-runs' partial sums 3 x (lead, M). A bucket of one sub-run keeps
    its partial; the others are summed by one segmented pairwise tree:
    each level adds partials 2i and 2i + 1 of every bucket with one
    `curve.add` (K2, P + P and P + (-P) included), an odd last one carried,
    ceil(log2 runs.max_split) levels."""
    lead = partial[0].shape[:-1]
    dev = partial[0].device
    out = curve.infinity((runs.windows * runs.buckets,), dev)
    out = tuple(o.index_copy(-1, runs.bucket[runs.single], p[..., runs.single])
                for o, p in zip(out, partial))
    cur = tuple(p[..., runs.multi] for p in partial)
    bucket, rank, size = runs.bucket[runs.multi], runs.rank, runs.size
    for _ in range((runs.max_split - 1).bit_length()):
        even = rank % 2 == 0
        keep = even.nonzero().squeeze(1)
        pair = (even & (rank + 1 < size)).nonzero().squeeze(1)
        sums = curve.add(tuple(t[..., pair] for t in cur), tuple(t[..., pair + 1] for t in cur))
        slot = (torch.cumsum(even, 0) - 1)[pair]
        cur = tuple(t[..., keep].index_copy(-1, slot, s_) for t, s_ in zip(cur, sums))
        bucket, rank, size = bucket[keep], rank[keep] // 2, (size[keep] + 1) // 2
    out = tuple(o.index_copy(-1, bucket, t) for o, t in zip(out, cur))
    return tuple(o.reshape(lead + (runs.windows, runs.buckets)) for o in out)


def loop_chunk(rows, order, runs: Runs, k0: int, fuse: int):
    """Steps k0 .. k0 + fuse - 1 of the bucket loop as `madd_multi` takes
    them: the affine points (x, y) of shape (12[, 2], S, M), point s of
    lane i being the (k0 + s)-th of sub-run i (a clamped, masked read past
    its end), and the (S, M) skip mask k0 + s >= length."""
    flat = order.reshape(-1).to(torch.int64)
    ks = (k0 + torch.arange(fuse, device=rows.device))[:, None]
    idx = flat[(runs.pos[None].to(torch.int64) + ks).clamp(max=flat.numel() - 1)]
    q = cuda_ops.rows_to_affine(rows[idx.reshape(-1)], tuple(idx.shape))
    return q, ks >= runs.length[None]


def _bucket_loop(curve, rows, order, start, count, run_length: int | None = None):
    """The v1 bucket loop on K7: Jacobian bucket sums, 3 x (12[, 2], W, B),
    from the arrays of `bucket_inputs`, over the lanes of `split_runs`.
    Step k folds the k-th point of every sub-run into its accumulator,
    masked where k >= its length; `msm_fuse_steps` steps' points are
    gathered at once and added by one `madd_multi` launch, so the longest
    sub-run (<= L) sets the launch count. `combine_runs` finishes."""
    runs = split_runs(start, count, order.shape[-1], run_length)
    fuse = get_config().msm_fuse_steps
    acc = curve.infinity((runs.pos.numel(),), rows.device)
    for k0 in range(0, runs.longest, fuse):
        q, skip = loop_chunk(rows, order, runs, k0, fuse)
        acc = curve.madd_multi(acc, q, skip)
    return combine_runs(curve, acc, runs)


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
    chunk = 1 << get_config().msm_chunk_log
    if n > chunk:
        acc = None
        for off in range(0, n, chunk):
            part = msm(curve, tuple(t[..., off:off + chunk] for t in points),
                       scalars_mont[..., off:off + chunk], c)
            acc = part if acc is None else curve.add(acc, part)
        return acc
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
