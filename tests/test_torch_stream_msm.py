"""The chunked MSM of the 2^24 path on the CPU: `msm_g1` at msm_chunk_log
= 4 on 64 points (four 16-point MSMs, the Jacobian partials added on K2's
twin) equal in affine to the one-shot MSM and to the oracle
(`tests/test_msm.py::test_msm_chunked_matches_unchunked` in the JAX
package). Tolerance 0; points and scalars from a numpy seed.
"""

import numpy as np
import pytest
import torch

from kzg_tpu_torch import config, native
from kzg_tpu_torch.constants import R
from kzg_tpu_torch.curve import g1_from_device, g1_to_device
from kzg_tpu_torch.fields import FR
from kzg_tpu_torch.msm import msm_g1
from kzg_tpu_torch.oracle import ec_add, ec_mul, g1_generator


@pytest.fixture(scope="module", autouse=True)
def _cpu_device():
    """The port's plain versions on the CPU, one intra-op thread (the twins
    run many tiny ops)."""
    old, threads = config.get_config(), torch.get_num_threads()
    config.configure(device="cpu")
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    config.set_config(old)


def _affine_args(pts, scal):
    x, y, z = g1_to_device(pts)
    return (x, y, (z == 0).all(dim=0)), torch.from_numpy(FR.encode(scal))


def test_chunked_msm_matches_one_shot_and_oracle():
    """64 points at msm_chunk_log = 4: four 16-point MSMs (bucket method,
    small_msm_threshold lowered to 4) and three K2 adds, against the
    one-shot MSM and the oracle, in affine. A zero scalar and a point at
    infinity sit in different chunks."""
    rs = np.random.default_rng(64)
    n = 64
    pts = [native.g1_mul(g1_generator(), int.from_bytes(rs.bytes(32), "little") % R)
           for _ in range(n)]
    pts[21] = None
    scal = [int.from_bytes(rs.bytes(32), "little") % R for _ in range(n)]
    scal[40] = 0
    points, s = _affine_args(pts, scal)
    want = None
    for pt, k in zip(pts, scal):
        want = ec_add(want, ec_mul(pt, k))
    old = config.get_config()
    try:
        config.configure(small_msm_threshold=4)
        one_shot = msm_g1(points, s)
        config.configure(msm_chunk_log=4)
        chunked = msm_g1(points, s)
    finally:
        config.set_config(old)
    got = g1_from_device(tuple(t[..., None] for t in chunked))[0]
    assert got == want
    assert got == g1_from_device(tuple(t[..., None] for t in one_shot))[0]
