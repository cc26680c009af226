"""The streamed single-point witness (`KZGProver._witness_streamed`, the
2^24 path above 2^msm_chunk_log coefficients) on the CPU, forced on at a
small size as `tests/test_kzg_coeff.py::test_streamed_witness_matches_direct`
does: n = 48 coefficients (not a multiple of the 2^4 chunk) at
msm_chunk_log = 4 give the same witness point as the one-shot division and
MSM, and the opening verifies; against the JAX package's
`_witness_streamed` the compressed bytes are equal (`slow`: the JAX MSM
graphs compile for minutes on the CPU).

Tolerance 0. Coefficients and the point from a numpy seed; the SRS from a
fixed secret on the host engine.
"""

import numpy as np
import pytest
import torch

from kzg_tpu_torch import config, native
from kzg_tpu_torch.constants import R
from kzg_tpu_torch.curve import g1_to_device
from kzg_tpu_torch.kzg import setup
from kzg_tpu_torch.kzg.coeff_form import KZGProver, KZGVerifier, g1_compressed
from kzg_tpu_torch.oracle import g1_generator
from kzg_tpu_torch.poly import Polynomial

SECRET = 0x1234_5678_9ABC_DEF0
N = 48


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


@pytest.fixture(scope="module")
def case():
    rs = np.random.default_rng(48)
    coeffs = [int.from_bytes(rs.bytes(32), "little") % R for _ in range(N)]
    x = int.from_bytes(rs.bytes(32), "little") % R
    y = sum(c * pow(x, i, R) for i, c in enumerate(coeffs)) % R
    return setup(SECRET, 64), coeffs, x, y


def _streamed(prover, poly, point):
    """create_witness under msm_chunk_log = 4 (the bucket method on the
    16-point chunks: small_msm_threshold 4)."""
    old = config.get_config()
    try:
        config.configure(msm_chunk_log=4, small_msm_threshold=4)
        return prover.create_witness(poly, point)
    finally:
        config.set_config(old)


def test_streamed_witness_matches_direct(case, monkeypatch):
    params, coeffs, x, y = case
    prover = KZGProver(params)
    poly = Polynomial.from_ints(coeffs)
    old = config.get_config()
    try:
        config.configure(small_msm_threshold=4)
        w_direct = prover.create_witness(poly, (x, y))
    finally:
        config.set_config(old)
    seen = []
    real = KZGProver._witness_streamed

    def spy(self, p, pt):
        seen.append(pt)
        return real(self, p, pt)

    monkeypatch.setattr(KZGProver, "_witness_streamed", spy)
    w_stream = _streamed(prover, poly, (x, y))
    assert seen == [x]
    assert g1_compressed(w_stream) == g1_compressed(w_direct)
    verifier = KZGVerifier(params)
    # the commitment f(s) g from the host engine (the device commit is
    # tested elsewhere; here it would only add a 48-point MSM's time)
    f_s = sum(k * pow(SECRET, i, R) for i, k in enumerate(coeffs)) % R
    c = tuple(t[..., 0] for t in g1_to_device([native.g1_mul(g1_generator(), f_s)]))
    assert verifier.verify_eval((x, y), c, w_stream)
    assert not verifier.verify_eval((x, (y + 1) % R), c, w_stream)


@pytest.mark.slow
def test_streamed_witness_matches_jax_bytes(case):
    """The JAX package's `_witness_streamed` at the same chunk, same bytes."""
    from kzg_tpu.config import configure as jconfigure, get_config as jget_config
    from kzg_tpu.kzg import setup as jsetup
    from kzg_tpu.kzg.coeff_form import KZGProver as JProver
    from kzg_tpu.poly import Polynomial as JPolynomial
    from kzg_tpu.compat.serialize import g1_compress
    from kzg_tpu.curve import g1_from_device as jg1_from_device

    params, coeffs, x, y = case
    w_stream = _streamed(KZGProver(params), Polynomial.from_ints(coeffs), (x, y))
    old = jget_config().msm_chunk_log
    try:
        jconfigure(msm_chunk_log=4)
        jw = JProver(jsetup(SECRET, 64)).create_witness(JPolynomial.from_ints(coeffs), (x, y))
    finally:
        jconfigure(msm_chunk_log=old)
    want = g1_compress(jg1_from_device(tuple(np.asarray(t)[..., None] for t in jw))[0])
    assert g1_compressed(w_stream) == want
