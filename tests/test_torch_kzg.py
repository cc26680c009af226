"""Port protocol layer (kzg_tpu_torch.kzg, plain kernel twins on CPU).

  * carry-across: an SRS built by the JAX package's host setup and saved
    with its KZGParams.save loads into the port's KZGParams.load word for
    word, and equals the port's own setup;
  * the coeff_2e10 golden vector of tests/vectors.json: commitment and
    witness bytes, verify_eval accepts, and rejects a tampered y;
    verify_poly accepts the commitment;
  * csprng_setup yields a power ladder (checked with one pairing);
  * the batched opening on the same carried-across SRS (its G2 powers are
    now used on the device, by msm_g2): the batched_2e8_k16 golden vector
    (commitment, witness, h^Z and g^r bytes), verify_eval_batched accepts
    and rejects other xs, bad ys raise, k + 1 past the G2 powers raises,
    and the coset division's on-coset fallback (one x = 7 omega^i) against
    host-int quotients.
Tolerance 0 throughout.
"""

import json
import os
import random

import numpy as np
import pytest
import torch

from kzg_tpu.kzg import srs as jsrs
from kzg_tpu_torch import config
from kzg_tpu_torch.constants import R
from kzg_tpu_torch.curve import G1, g1_from_device, g2_from_device
from kzg_tpu_torch.fields import FR
from kzg_tpu_torch.fields.limb import unpack16
from kzg_tpu_torch.hostcrypto import multi_pairing_check
from kzg_tpu_torch.kzg import (
    BatchedPointsNotOnPolynomial,
    KZGParams,
    KZGProver,
    KZGVerifier,
    PointNotOnPolynomial,
    PolynomialDegreeTooLarge,
)
from kzg_tpu_torch.kzg.coeff_form import g1_compressed, g2_compressed
from kzg_tpu_torch.kzg.srs import csprng_setup, setup
from kzg_tpu_torch.msm import msm_g1, msm_g2
from kzg_tpu_torch.ntt import Domain
from kzg_tpu_torch.oracle import ec_neg, g1_generator, g2_generator
from kzg_tpu_torch.poly import Polynomial, lagrange_interpolation, vanishing_poly

VEC = json.load(open(os.path.join(os.path.dirname(__file__), "vectors.json")))
SECRET = int(VEC["secret"], 16)
GOLD = VEC["configs"]["coeff_2e10"]
BATCHED = VEC["configs"]["batched_2e8_k16"]


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


def _eval(coeffs, x):
    y = 0
    for c in reversed(coeffs):
        y = (y * x + c) % R
    return y


@pytest.fixture(scope="module")
def jax_params_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("srs") / "jax_srs.npz")
    jsrs._setup_host(SECRET, GOLD["n"]).save(path)
    return path


@pytest.fixture(scope="module")
def params(jax_params_file):
    return KZGParams.load(jax_params_file)


@pytest.fixture(scope="module")
def golden():
    rng = random.Random(VEC["seed"])
    coeffs = [rng.randrange(R) for _ in range(GOLD["n"])]
    x = rng.randrange(R)
    assert hex(x) == GOLD["open_x"]
    y = 0
    for c in reversed(coeffs):
        y = (y * x + c) % R
    assert hex(y) == GOLD["open_y"]
    return Polynomial.from_ints(coeffs), x, y


def test_srs_carries_across_from_jax(jax_params_file, params, tmp_path):
    z = np.load(jax_params_file)
    for port, key in ((params.gs[0], "g_x"), (params.gs[1], "g_y"),
                      (params.hs[0], "h_x"), (params.hs[1], "h_y")):
        np.testing.assert_array_equal(unpack16(port).numpy().astype(np.uint32), z[key])
    np.testing.assert_array_equal(params.gs[2].numpy(), z["g_i"])
    np.testing.assert_array_equal(params.hs[2].numpy(), z["h_i"])
    assert params.n == int(z["n"])
    # the port's own setup builds the same SRS, and its save round-trips
    own = setup(SECRET, GOLD["n"])
    for a, b in zip(own.gs + own.hs, params.gs + params.hs):
        assert torch.equal(a, b)
    own.save(str(tmp_path / "port_srs"))
    again = KZGParams.load(str(tmp_path / "port_srs"))
    for a, b in zip(again.gs + again.hs, params.gs + params.hs):
        assert torch.equal(a, b)


def test_golden_coeff_2e10(params, golden):
    poly, x, y = golden
    prover = KZGProver(params)
    commitment = prover.commit(poly)
    assert g1_compressed(commitment).hex() == GOLD["commit"]
    witness = prover.create_witness(poly, (x, y))
    assert g1_compressed(witness).hex() == GOLD["witness"]
    verifier = KZGVerifier(params)
    assert verifier.verify_eval((x, y), commitment, witness)
    assert not verifier.verify_eval((x, (y + 1) % R), commitment, witness)
    with pytest.raises(PointNotOnPolynomial):
        prover.create_witness(poly, (x, (y + 1) % R))
    assert verifier.verify_poly(commitment, poly)
    assert not bool(G1.eq(commitment, witness))


def test_csprng_setup_is_a_power_ladder():
    params = csprng_setup(3)
    g = g1_from_device(params.gs)
    h = g2_from_device(params.hs)
    assert params.n == 3 and g[0] == g1_generator() and h[0] == g2_generator()
    # e(g^(s^2), h) == e(g^s, h^s) without knowing s
    assert multi_pairing_check([(g[2], h[0]), (ec_neg(g[1]), h[1])])


def test_eval_and_division_against_host_ints():
    rs = np.random.default_rng(21)
    coeffs = [int.from_bytes(rs.bytes(32), "little") % R for _ in range(37)]
    poly = Polynomial.from_ints(coeffs)
    for x in (0, 1, int.from_bytes(rs.bytes(32), "little") % R):
        y = 0
        for c in reversed(coeffs):
            y = (y * x + c) % R
        assert poly.eval(x) == y
        q, rem = poly.div_by_linear(x)
        assert rem == y
        # synthetic division on host ints
        want, acc = [], 0
        for c in reversed(coeffs[1:]):
            acc = (acc * x + c) % R
            want.append(acc)
        assert q.to_ints() == want[::-1]


@pytest.fixture(scope="module")
def batched():
    """The batched_2e8_k16 inputs: the generator consumed the coeff_2e10
    stream first (n coefficients and x), so replay it."""
    rng = random.Random(VEC["seed"])
    for _ in range(GOLD["n"] + 1):
        rng.randrange(R)
    coeffs = [rng.randrange(R) for _ in range(BATCHED["n"])]
    xs = [rng.randrange(R) for _ in range(BATCHED["k"])]
    assert [hex(x) for x in xs] == BATCHED["xs"]
    return coeffs, xs, [_eval(coeffs, x) for x in xs]


def test_golden_batched_2e8_k16(params, batched):
    """On the SRS built by the JAX package's host setup and carried across
    (its first 256 G1 and 17 G2 powers)."""
    coeffs, xs, ys = batched
    poly = Polynomial.from_ints(coeffs)
    prover = KZGProver(params)
    commitment = prover.commit(poly)
    assert g1_compressed(commitment).hex() == BATCHED["commit"]
    bw = prover.create_witness_batched(poly, xs, ys)
    assert g1_compressed(bw.w).hex() == BATCHED["witness"]
    assert bw.r.degree == len(xs) - 1
    assert [_eval(bw.r.to_ints(), x) for x in xs] == ys
    z = vanishing_poly(torch.from_numpy(FR.encode(xs)))
    hz = msm_g2(tuple(t[..., : z.num_coeffs()] for t in params.hs), z.trimmed())
    assert g2_compressed(hz).hex() == BATCHED["h_z"]
    gr = msm_g1(tuple(t[..., : bw.r.num_coeffs()] for t in params.gs), bw.r.trimmed())
    assert g1_compressed(gr).hex() == BATCHED["g_r"]
    verifier = KZGVerifier(params)
    assert verifier.verify_eval_batched(commitment, bw, xs)
    other = list(xs)
    other[3] = (other[3] + 1) % R
    assert not verifier.verify_eval_batched(commitment, bw, other)


def test_batched_errors(batched):
    coeffs, xs, ys = batched
    small = setup(SECRET, 4)
    poly = Polynomial.from_ints(coeffs[:4])
    ys4 = [_eval(coeffs[:4], x) for x in xs[:4]]
    bad = list(ys4)
    bad[2] = (bad[2] + 1) % R
    with pytest.raises(BatchedPointsNotOnPolynomial):
        KZGProver(small).create_witness_batched(poly, xs[:4], bad)
    # 4 points need 5 G2 powers; this setup has 4 (checked before any MSM)
    bw = KZGProver(small).create_witness_batched(poly, xs[:4], ys4, check=False)
    with pytest.raises(PolynomialDegreeTooLarge):
        KZGVerifier(small).verify_eval_batched(G1.infinity(), bw, xs[:4])


def test_exact_div_on_coset_fallback():
    """One batch point on the coset 7 * <omega_64> forces the long-division
    fallback (39 quotient terms: the Newton branch); the coset-division path
    and the device-side coset test give the same quotient when no point is
    on the coset."""
    rs = np.random.default_rng(22)
    f = [int.from_bytes(rs.bytes(32), "little") % R for _ in range(40)]
    dom = Domain(6)  # 40 coefficients -> the 2^6 domain
    for xs in ([7 * pow(dom.omega, 5, R) % R, 12345], [54321, 12345]):
        ys = [_eval(f, x) for x in xs]
        xs_d = torch.from_numpy(FR.encode(xs))
        numerator = Polynomial.from_ints(f) - lagrange_interpolation(
            xs_d, torch.from_numpy(FR.encode(ys))
        )
        z = vanishing_poly(xs_d)
        want = [_eval(numerator.to_ints(), t) * pow(_eval(z.to_ints(), t), -1, R) % R
                for t in (3, 5)]
        for xs_int in (xs, None):
            q = KZGProver._exact_div(numerator, z, xs_int=xs_int)
            assert q.degree == 37
            assert [_eval(q.to_ints(), t) for t in (3, 5)] == want
