"""G2 Pippenger in the port (kzg_tpu_torch.msm.msm_g2 at and above
small_msm_threshold points: the plain twins of K7, K3 and K4 over Fp2 on
CPU; windows of fewer than 1024 buckets take the bucket loop on K7)
against the native engine's `g2_msm` and the oracle, in affine form
(Jacobian Z depends on the bucket order). Tolerance 0.

  * the G2 row layout of `cuda_ops.point_rows` (x.c0, x.c1, y.c0, y.c1) and
    the per-bucket sums of the K3 twin against oracle sums;
  * msm_g2 at 512 and 1024 points with the window the reference's `msm()`
    takes, each batch holding a point at infinity and a zero scalar;
  * the all-points verifier's scalar vector [-1, 0, ..., 0, 1]: nearly
    every point sits in bucket 0 and all but two buckets a window are
    empty, so empty buckets must be infinity and the join must keep
    infinity fixed; the result is points[n-1] - points[0];
  * a batch of points at infinity only.
"""

import numpy as np
import pytest
import torch

from kzg_tpu.msm import pippenger as jpip
from kzg_tpu_torch import config, native
from kzg_tpu_torch.constants import R
from kzg_tpu_torch.curve import G2, cuda_ops, g2_from_device, g2_to_device
from kzg_tpu_torch.fields import FP, FR
from kzg_tpu_torch.msm import msm_g2, pippenger
from kzg_tpu_torch.oracle import ec_add, ec_neg, g2_generator


@pytest.fixture(scope="module", autouse=True)
def _cpu_device():
    """The port places tensors on the card by default; these tests run its
    plain twins, so they ask for the CPU. The twins' ops are tiny, so one
    intra-op thread is as fast as many and several test processes side by
    side do not fight over the cores."""
    old, threads = config.get_config(), torch.get_num_threads()
    config.configure(device="cpu")
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    config.set_config(old)


@pytest.fixture(scope="module")
def points():
    """1024 G2 points k_i g (the native engine's multiples), lane 9 at
    infinity."""
    rs = np.random.default_rng(61)
    pts = [native.g2_mul(g2_generator(), int(k)) for k in rs.integers(1, 1 << 62, size=1024)]
    pts[9] = None
    x, y, z = g2_to_device(pts)
    return pts, (x, y, (z == 0).all(dim=0).all(dim=0))


def _scalars(seed, n):
    rs = np.random.default_rng(seed)
    scal = [int.from_bytes(rs.bytes(32), "little") % R for _ in range(n)]
    scal[n // 2] = 0
    return scal


def _one(point):
    return g2_from_device(tuple(t[..., None] for t in point))[0]


def test_g2_rows_layout_and_bucket_sums(points):
    pts, (x, y, inf) = points
    n, c = 24, 2
    rows = cuda_ops.point_rows(x[..., :n], y[..., :n])
    assert rows.shape == (n, 48) and rows.is_contiguous()
    for i in (0, 5, n - 1):
        for k, part in enumerate((x[:, 0, i], x[:, 1, i], y[:, 0, i], y[:, 1, i])):
            assert torch.equal(rows[i, 12 * k:12 * (k + 1)], part)
    scal = _scalars(62, n)
    std = torch.from_numpy(FR.from_ints(scal))
    inputs = pippenger.bucket_inputs(x[..., :n], y[..., :n], inf[:n], std, c)
    assert torch.equal(inputs[0], rows)
    # a few windows keep the twin's step loop short
    inputs = (rows,) + tuple(t[:3].contiguous() for t in inputs[1:])
    acc = cuda_ops.bucket_accumulate(*inputs)
    assert acc[0].shape == (FP.W, 2, 3, 1 << c)
    got = g2_from_device(tuple(t.reshape(FP.W, 2, -1) for t in acc))
    digits = pippenger._digits(std, c)
    for w in range(3):
        for b in range(1 << c):
            want = None
            if b:
                for i in range(n):
                    if int(digits[w, i]) == b and pts[i] is not None:
                        want = ec_add(want, pts[i])
            assert got[w * (1 << c) + b] == want, (w, b)


def test_g2_bucket_loop_equals_bucket_accumulate(points):
    """The bucket loop over `madd_multi` (two launches' worth of steps at
    msm_fuse_steps = 4) gives the K3 twin's G2 bucket sums limb for limb."""
    _, (x, y, inf) = points
    n, c = 48, 2
    std = torch.from_numpy(FR.from_ints(_scalars(75, n)))
    inputs = pippenger.bucket_inputs(x[..., :n], y[..., :n], inf[:n], std, c)
    old = config.get_config()
    config.configure(msm_fuse_steps=4)
    try:
        got = pippenger._bucket_loop(G2, *inputs)
    finally:
        config.set_config(old)
    assert got[0].shape == (12, 2) + tuple(inputs[2].shape)
    assert all(torch.equal(a, b) for a, b in zip(got, cuda_ops.bucket_accumulate(*inputs)))


@pytest.mark.parametrize("n,c", [(512, 4), (1024, 5)], ids=["512", "1024"])
def test_msm_g2_pippenger_matches_native(points, n, c):
    """With the window the reference's msm() takes for G2 as for G1."""
    pts, (x, y, inf) = points
    assert n >= config.get_config().small_msm_threshold  # the bucket route
    assert pippenger.effective_window(n) == jpip.pick_window(n) + 1 == c
    scal = _scalars(n, n)
    got = msm_g2((x[..., :n], y[..., :n], inf[:n]), torch.from_numpy(FR.encode(scal)))
    assert got[0].shape == (FP.W, 2)
    assert _one(got) == native.g2_msm(pts[:n], scal)


def test_msm_g2_all_points_vector(points):
    """z = [-1, 0, ..., 0, 1] over 512 points, the first one swapped for a
    finite point."""
    pts, (x, y, inf) = points
    sl = slice(10, 522)
    scal = [R - 1] + [0] * 510 + [1]
    got = msm_g2((x[..., sl], y[..., sl], inf[sl]), torch.from_numpy(FR.encode(scal)), 8)
    assert _one(got) == ec_add(pts[521], ec_neg(pts[10]))


def test_msm_g2_only_infinite_points(points):
    _, (x, y, _) = points
    inf = torch.ones(512, dtype=torch.bool)
    got = msm_g2((x[..., :512], y[..., :512], inf),
                 torch.from_numpy(FR.encode(_scalars(63, 512))), 8)
    assert bool(G2.is_inf(got)) and _one(got) is None
