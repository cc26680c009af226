"""Port MSM (kzg_tpu_torch.msm, plain kernel twins on CPU) against the JAX
package's native engine MSM (`kzg_tpu.native.g1_msm`) and its pure-Python
oracle (`kzg_tpu.oracle`), in affine form (Jacobian Z depends
on the summation order). Tolerance 0.

n = 64 takes the double-and-add ladder, n = 600 the bucket path (the bucket
loop on the K7 twin at its c = 4, tree reduction, K4 twin); the route by
bucket count is checked against the reference's threshold. Each batch holds a zero scalar and a point at
infinity. One slow case also runs the JAX package's msm_g1, whose XLA
compile takes minutes on a CPU, as tests/test_msm.py is marked.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kzg_tpu import native
from kzg_tpu.fields import FR as JFR
from kzg_tpu.msm import pippenger as jpip
from kzg_tpu.oracle import ec_add, ec_mul, g1_generator
from kzg_tpu_torch import config
from kzg_tpu_torch.config import get_config
from kzg_tpu_torch.constants import R
from kzg_tpu_torch.curve import g1_from_device, g1_to_device
from kzg_tpu_torch.fields import FR
from kzg_tpu_torch.msm import msm_g1, pippenger


@pytest.fixture(scope="module", autouse=True)
def _cpu_device():
    """The port places tensors on the card by default; these tests run its
    plain twins, so they ask for the CPU."""
    old, threads = config.get_config(), torch.get_num_threads()
    config.configure(device="cpu")
    torch.set_num_threads(1)  # the twins' ops are tiny; test files run side by side
    yield
    torch.set_num_threads(threads)
    config.set_config(old)


def _case(seed, n):
    rs = np.random.default_rng(seed)
    pts = [native.g1_mul(g1_generator(), int.from_bytes(rs.bytes(32), "little") % R)
           for _ in range(n)]
    pts[n // 3] = None
    scal = [int.from_bytes(rs.bytes(32), "little") % R for _ in range(n)]
    scal[n // 2] = 0
    return pts, scal


def _device_args(pts, scal):
    x, y, z = g1_to_device(pts)
    return (x, y, (z == 0).all(dim=0)), torch.from_numpy(FR.encode(scal))


@pytest.mark.parametrize("n", [64, 600], ids=["ladder-64", "buckets-600"])
def test_msm_matches_native(n):
    pts, scal = _case(n, n)
    path = "ladder" if n < get_config().small_msm_threshold else "buckets"
    assert path == ("ladder" if n == 64 else "buckets")
    points, s = _device_args(pts, scal)
    got = g1_from_device(tuple(t[..., None] for t in msm_g1(points, s)))[0]
    assert got == native.g1_msm(pts, scal)
    if n == 64:
        want = None
        for pt, k in zip(pts, scal):
            want = ec_add(want, ec_mul(pt, k))
        assert got == want


def test_msm_explicit_window_all_zero_scalars():
    pts, _ = _case(3, 520)
    points, s = _device_args(pts, [0] * 520)
    assert g1_from_device(tuple(t[..., None] for t in msm_g1(points, s, c=6)))[0] is None


@pytest.mark.parametrize("c", [5, 10, 13])
def test_digits_match_jax(c):
    rs = np.random.default_rng(c)
    scal = [int.from_bytes(rs.bytes(32), "little") % R for _ in range(33)]
    scal[0] = R - 1
    got = pippenger._digits(torch.from_numpy(FR.from_ints(scal)), c)
    want = jpip._digits(jnp.asarray(JFR.from_ints(scal)), c)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for k, col in zip(scal, got.T.tolist()):
        assert sum(d << (c * w) for w, d in enumerate(col)) == k


@pytest.mark.parametrize("c,route", [(9, "loop"), (10, "runs")])
def test_bucket_route_by_window(monkeypatch, c, route):
    """As in the reference (`kzg_tpu/msm/pippenger.py:480`): windows of
    fewer than 1024 buckets take the bucket loop on `madd_multi`, the others
    the one-launch bucket kernel."""
    from kzg_tpu_torch.curve import G1

    class Taken(Exception):
        pass

    def taken(name):
        def fn(*args, **kwargs):
            raise Taken(name)
        return fn

    monkeypatch.setattr(pippenger, "_bucket_loop", taken("loop"))
    monkeypatch.setattr(type(G1), "bucket_accumulate", taken("runs"))
    (x, y, inf), scal = _device_args(*_case(3, 8))
    with pytest.raises(Taken, match=route):
        pippenger._msm_runs(G1, x, y, inf, FR.from_mont(scal), c)


def test_window_choice_matches_reference():
    assert pippenger.effective_window(1 << 15) == 10
    assert pippenger.effective_window(1 << 10) == 5
    for n in (17, 600, 1 << 12, 1 << 20):
        assert pippenger.pick_window(n) == jpip.pick_window(n)


@pytest.mark.slow
def test_msm_matches_jax_msm_g1():
    from kzg_tpu import curve as jcurve
    from kzg_tpu.msm import msm_g1 as jmsm_g1

    pts, scal = _case(7, 600)
    points, s = _device_args(pts, scal)
    got = g1_from_device(tuple(t[..., None] for t in msm_g1(points, s)))[0]
    jx, jy, jz = jcurve.g1_to_device(pts)
    jinf = jnp.asarray([p is None for p in pts])
    want = jmsm_g1((jx, jy, jinf), jnp.asarray(JFR.encode(scal)))
    assert got == jcurve.g1_from_device(tuple(t[..., None] for t in want))[0]
