"""The bounded sub-runs of the port's bucket accumulation
(`kzg_tpu_torch.msm.pippenger.split_runs` / `combine_runs`), on CPU with the
plain twins of kernels K2, K3 and K7.

  * the split covers every bucket run exactly once and no sub-run is longer
    than L, on random, one-bucket and mostly empty counts;
  * the combine tree sums a bucket's partials for m_b in {1, 2, 3, 5, 17}
    sub-runs, with P + P and P + (-P) on its first and second levels;
  * skewed MSMs on both bucket routes (the bucket loop at n = 600, the K3
    twin at a small n with c = 10) against the JAX package's native engine
    (`kzg_tpu.native.g1_msm` / `g2_msm`), in affine: all-equal scalars,
    [R - 1] + [1] * (n - 1), and a batch whose weight sits in the top window;
  * the K3 route equals the bucket-loop route limb for limb where a bucket
    is longer than L.

Tolerance 0: all of it is exact integer arithmetic. Inputs from numpy seeds.
"""

import numpy as np
import pytest
import torch

from kzg_tpu import native as jnative
from kzg_tpu.oracle import ec_add, ec_neg, g1_generator, g2_generator
from kzg_tpu_torch import config
from kzg_tpu_torch.constants import R
from kzg_tpu_torch.curve import (
    G1, G2, cuda_ops, g1_from_device, g1_to_device, g2_from_device, g2_to_device,
)
from kzg_tpu_torch.fields import FR
from kzg_tpu_torch.msm import pippenger

GROUPS = {
    "g1": (G1, cuda_ops.PLAIN, jnative.g1_mul, g1_generator, jnative.g1_msm, g1_to_device,
           g1_from_device),
    "g2": (G2, cuda_ops.PLAIN2, jnative.g2_mul, g2_generator, jnative.g2_msm, g2_to_device,
           g2_from_device),
}


@pytest.fixture(scope="module", autouse=True)
def _cpu_device():
    """The port places tensors on the card by default; these tests run its
    plain twins, so they ask for the CPU. The twins' ops are tiny, so one
    intra-op thread is as fast as many, and test processes side by side do
    not stall each other's thread pools."""
    old, threads = config.get_config(), torch.get_num_threads()
    config.configure(device="cpu")
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    config.set_config(old)


def _runs_arrays(counts, n):
    """(W, B) start / count of runs laid out in bucket order, n positions a
    window (the layout `bucket_inputs` gives)."""
    count = np.asarray(counts, dtype=np.int64)
    start = np.cumsum(count, axis=1) - count
    assert (count.sum(axis=1) <= n).all()
    return torch.from_numpy(start).to(torch.int32), torch.from_numpy(count).to(torch.int32)


def _counts(case, rs, windows, buckets, n):
    if case == "random":
        counts = rs.multinomial(n, np.full(buckets, 1 / buckets), size=windows)
    elif case == "one-bucket":  # every point of a window in one bucket
        counts = np.zeros((windows, buckets), np.int64)
        counts[np.arange(windows), rs.integers(1, buckets, windows)] = n
    else:  # "mostly-empty": three live buckets a window, one of them huge
        counts = np.zeros((windows, buckets), np.int64)
        counts[:, 1] = n - 7
        counts[:, buckets - 1] = 5
        counts[:, buckets // 2] = 2
    counts[:, 0] = 0  # bucket 0 never counts
    return counts


@pytest.mark.parametrize("run_length", [None, 1, 7])
@pytest.mark.parametrize("case", ["random", "one-bucket", "mostly-empty"])
def test_split_covers_every_run_once(case, run_length):
    rs = np.random.default_rng(["random", "one-bucket", "mostly-empty"].index(case))
    windows, buckets, n = 5, 32, 500
    counts = _counts(case, rs, windows, buckets, n)
    start, count = _runs_arrays(counts, n)
    runs = pippenger.split_runs(start, count, n, run_length)
    limit = pippenger.default_run_length(n, buckets) if run_length is None else run_length
    assert runs.run_length == limit and (windows, buckets) == (runs.windows, runs.buckets)
    pos, length = runs.pos.numpy().astype(np.int64), runs.length.numpy().astype(np.int64)
    bucket = runs.bucket.numpy()
    assert (length >= 1).all() and (length <= limit).all()
    assert (np.diff(length) <= 0).all()  # longest first
    assert runs.longest == (length.max() if length.size else 0)
    # every position of every run is covered by exactly one sub-run of its bucket
    covered = np.zeros(windows * n, np.int64)
    owner = np.full(windows * n, -1)
    for p, ln, b in zip(pos, length, bucket):
        covered[p:p + ln] += 1
        owner[p:p + ln] = b
    for w in range(windows):
        for b in range(buckets):
            lo = w * n + int(start[w, b])
            hi = lo + int(count[w, b])
            assert (covered[lo:hi] == 1).all() and (owner[lo:hi] == w * buckets + b).all()
    assert covered.sum() == counts.sum()
    # the combine's plan
    per_bucket = np.bincount(bucket, minlength=windows * buckets)
    assert runs.max_split == per_bucket.max()
    assert (per_bucket == -(-counts.reshape(-1) // limit)).all()
    single, multi = runs.single.numpy(), runs.multi.numpy()
    assert sorted(np.concatenate([single, multi]).tolist()) == list(range(len(pos)))
    assert (per_bucket[bucket[single]] == 1).all() and (per_bucket[bucket[multi]] > 1).all()
    assert (runs.size.numpy() == per_bucket[bucket[multi]]).all()
    # multi is bucket-major, each bucket's pieces in run order, rank = place
    mb, mpos, rank = bucket[multi], pos[multi], runs.rank.numpy()
    assert (np.diff(mb) >= 0).all()
    for b in np.unique(mb):
        sel = mb == b
        assert (np.diff(mpos[sel]) == limit).all() and (rank[sel] == np.arange(sel.sum())).all()


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_combine_tree_sums(group):
    """One window of 10 buckets cut at L = 2: buckets of 1, 2, 3, 5 and 17
    sub-runs (odd counts, so each ends in a 1-point tail), and four of 2 or
    3 sub-runs whose partials are equal or opposite on the tree's first
    level (P + P, P + (-P)) or on its second ((P + Q) + (P + Q), and its
    opposite)."""
    curve, plain, mul, gen, _, to_dev, from_dev = GROUPS[group]
    rs = np.random.default_rng(50)
    splits = [0, 1, 2, 3, 5, 17, 2, 2, 3, 3]
    counts = [[2 * m - 1 if m else 0 for m in splits]]
    start, count = _runs_arrays(counts, sum(counts[0]))
    runs = pippenger.split_runs(start, count, sum(counts[0]), 2)
    assert runs.max_split == 17
    parts = {b: [mul(gen(), int(rs.integers(1, 1 << 62))) for _ in range(m)]
             for b, m in enumerate(splits)}
    parts[6][1] = parts[6][0]
    parts[7][1] = ec_neg(parts[7][0])
    parts[8][2] = ec_add(parts[8][0], parts[8][1])
    parts[9][2] = ec_neg(ec_add(parts[9][0], parts[9][1]))
    # lane i holds piece j of its bucket, j read back from its position
    base = start.reshape(-1).numpy()
    lane_pts = [parts[b][(p - base[b]) // 2]
                for p, b in zip(runs.pos.tolist(), runs.bucket.tolist())]
    x, y, z = to_dev(lane_pts)
    for c in (curve, plain):  # the kernel curve (twins on CPU) and the plain curve
        sums = pippenger.combine_runs(c, (x, y, z), runs)
        assert sums[0].shape[-2:] == (1, 10)
        got = from_dev(tuple(t[..., 0, :] for t in sums))
        want = []
        for b in range(10):
            acc = None
            for pt in parts[b]:
                acc = ec_add(acc, pt)
            want.append(acc)
        assert got == want
        assert got[7] is None and got[9] is None and got[0] is None


def _msm_case(group, pattern, n, c):
    """Points k_i g from the JAX package's native engine (one at infinity)
    and a skewed scalar vector."""
    _, _, mul, gen, _, _, _ = GROUPS[group]
    rs = np.random.default_rng(n + c)
    pts = [mul(gen(), int(rs.integers(1, 1 << 62))) for _ in range(n)]
    pts[n // 3] = None
    windows = -(-256 // c)
    if pattern == "equal":
        scal = [int.from_bytes(rs.bytes(32), "little") % R] * n
    elif pattern == "minus-one":
        scal = [R - 1] + [1] * (n - 1)
    else:  # "top-heavy": a few top-window digits and a low byte
        top = [int(d) for d in rs.integers(1, 4, n)]
        scal = [(d << (c * (windows - 1))) % R + int(rs.integers(0, 256)) for d in top]
    return pts, scal


@pytest.mark.parametrize("pattern", ["equal", "minus-one", "top-heavy"])
@pytest.mark.parametrize("route", ["loop-600", "k3-c10"])
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_skewed_msm_matches_native(group, route, pattern):
    """The bucket loop at n = 600 (c = 4: 16 buckets a window, the fullest
    holds every point) and the K3 twin at n = 96 with c = 10, against the
    native engine's MSM."""
    curve, _, _, _, msm_native, to_dev, from_dev = GROUPS[group]
    n, c = (600, pippenger.effective_window(600)) if route == "loop-600" else (96, 10)
    assert ((1 << c) < pippenger.RUNS_MIN_BUCKETS) == (route == "loop-600")
    pts, scal = _msm_case(group, pattern, n, c)
    x, y, z = to_dev(pts)
    inf = (z == 0).reshape(-1, n).all(dim=0)
    std = FR.from_mont(torch.from_numpy(FR.encode(scal)))
    count = pippenger.bucket_inputs(x, y, inf, std, c)[3]
    assert int(count.max()) > pippenger.default_run_length(n, 1 << c)  # some bucket is cut
    got = pippenger._msm_runs(curve, x, y, inf, std, c)
    assert from_dev(tuple(t[..., None] for t in got))[0] == msm_native(pts, scal)


@pytest.mark.parametrize("run_length", [None, 5])
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_k3_route_equals_bucket_loop_past_run_length(group, run_length):
    """Buckets longer than L: the K3 twin and the bucket loop (fuse 1 and
    16) cut the same sub-runs and combine them by the same tree, so their
    bucket sums agree limb for limb."""
    curve, _, mul, gen, _, to_dev, _ = GROUPS[group]
    rs = np.random.default_rng(71)
    n, c = 120, 3
    x, y, z = to_dev([mul(gen(), int(rs.integers(1, 1 << 62))) for _ in range(n)])
    inf = (z == 0).reshape(-1, n).all(dim=0)
    scal = [int(rs.integers(1, 3)) * 0x1249249249249249 for _ in range(n)]  # digits 1 or 2
    inputs = pippenger.bucket_inputs(x, y, inf, FR.from_mont(torch.from_numpy(FR.encode(scal))), c)
    limit = run_length or pippenger.default_run_length(n, 1 << c)
    assert int(inputs[3].max()) > limit
    want = cuda_ops.bucket_accumulate(*inputs, run_length=run_length)
    old = config.get_config()
    try:
        for fuse in (1, 16):
            config.configure(msm_fuse_steps=fuse)
            got = pippenger._bucket_loop(curve, *inputs, run_length=run_length)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
    finally:
        config.set_config(old)
