"""The evaluation-form slice of the port as a whole (kzg_tpu_torch.kzg.
eval_form, plain kernel twins on CPU): in-domain division, commit, witness,
verification, the all-points opening, and the `eval_2e7` golden vector.
Tolerance 0.

  * `_div_by_omega_i` against monomial division (interpolate, divide by
    X - omega^m, evaluate) at m = 0, a middle index and d - 1, which
    depends on batch_inv(0) == 0; against the JAX package's jitted function
    in the `slow` tier;
  * `eval_2e7` of tests/vectors.json: commitment and witness bytes on the
    Lagrange SRS built from the secret; verify_eval accepts, and rejects a
    tampered evaluation and a wrong index;
  * at d = 8: commit, verify_poly (iNTT + monomial MSM), a witness at the
    last index, create_witness_all + verify_eval_all.
Every MSM here is below small_msm_threshold, so it runs the 256-step ladder
on the plain twins (~12 s over G1, ~30 s over G2): the rejecting twin of
verify_eval_all and further witnesses are `slow`. The Lagrange SRS's trusted route is in tests/test_torch_lagrange.py.
"""

import json
import os
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kzg_tpu.fields import FR as JFR
from kzg_tpu.kzg import eval_form as jef
from kzg_tpu_torch import config
from kzg_tpu_torch.constants import R
from kzg_tpu_torch.curve import G1
from kzg_tpu_torch.fields import FR
from kzg_tpu_torch.fields.limb import unpack16
from kzg_tpu_torch.kzg import (
    KZGBatchWitnessEvalForm,
    KZGProver,
    KZGProverEvalForm,
    KZGVerifierEvalForm,
    compute_lagrange_basis_from_secret,
    setup,
)
from kzg_tpu_torch.kzg.coeff_form import g1_compressed
from kzg_tpu_torch.kzg.eval_form import _div_by_omega_i
from kzg_tpu_torch.ntt import Domain
from kzg_tpu_torch.poly import Polynomial

VEC = json.load(open(os.path.join(os.path.dirname(__file__), "vectors.json")))
SECRET = int(VEC["secret"], 16)
GOLD = VEC["configs"]["eval_2e7"]
EXP = 3
D = 1 << EXP


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


def _evals(seed, d):
    rs = np.random.default_rng(seed)
    return [int.from_bytes(rs.bytes(32), "little") % R for _ in range(d)]


def _words(ints):
    return torch.from_numpy(FR.encode(ints))


def _horner(coeffs, x):
    y = 0
    for c in reversed(coeffs):
        y = (y * x + c) % R
    return y


@pytest.mark.parametrize("exp,m", [(3, 0), (3, 5), (3, 7), (5, 17)])
def test_div_by_omega_i_matches_monomial_division(exp, m):
    d = 1 << exp
    dom = Domain(exp)
    evals = _evals(exp * 100 + m, d)
    numer = [(e - evals[m]) % R for e in evals]
    got = FR.decode(_div_by_omega_i(exp, _words(numer), m))
    # host ints: interpolate f, divide by (X - omega^m) synthetically,
    # evaluate the quotient over the domain
    coeffs = FR.decode(dom.intt(_words(evals)))
    wm = pow(dom.omega, m, R)
    quotient, acc = [], 0
    for c in reversed(coeffs[1:]):
        acc = (acc * wm + c) % R
        quotient.append(acc)
    quotient = quotient[::-1]
    assert got == [_horner(quotient, pow(dom.omega, j, R)) for j in range(d)]


@pytest.mark.slow
def test_div_by_omega_i_matches_jax():
    evals = _evals(9, D)
    for m in (0, 5, D - 1):
        numer = [(e - evals[m]) % R for e in evals]
        got = _div_by_omega_i(EXP, _words(numer), m)
        want = jef._div_by_omega_i_jit(EXP, jnp.asarray(JFR.encode(numer)), jnp.int32(m))
        np.testing.assert_array_equal(unpack16(got).numpy().astype(np.uint32), np.asarray(want))


@pytest.fixture(scope="module")
def golden():
    """The eval_2e7 inputs: the generator drew the coeff_2e10 and
    batched_2e8_k16 streams first, so replay them."""
    rng = random.Random(VEC["seed"])
    c1, c3 = VEC["configs"]["coeff_2e10"], VEC["configs"]["batched_2e8_k16"]
    for _ in range(c1["n"] + 1 + c3["n"] + c3["k"]):
        rng.randrange(R)
    d = 1 << GOLD["exp"]
    evals = [rng.randrange(R) for _ in range(d)]
    assert hex(evals[GOLD["index"]]) == GOLD["y"]
    params = setup(SECRET, d)
    lagrange = compute_lagrange_basis_from_secret(SECRET, GOLD["exp"])
    prover = KZGProverEvalForm(params, lagrange)
    assert prover.d == d
    evals_d = _words(evals)
    return (evals, KZGVerifierEvalForm(params, lagrange), prover.commit(evals_d),
            prover.create_witness(evals_d, GOLD["index"]))


def test_golden_eval_2e7_bytes(golden):
    _, _, commitment, witness = golden
    assert g1_compressed(commitment).hex() == GOLD["commit"]
    assert g1_compressed(witness).hex() == GOLD["witness"]


def test_golden_eval_2e7_verify_and_reject(golden):
    evals, verifier, commitment, witness = golden
    i = GOLD["index"]
    assert verifier.verify_eval((i, evals[i]), commitment, witness)
    assert not verifier.verify_eval((i, (evals[i] + 1) % R), commitment, witness)
    assert not verifier.verify_eval((i + 1, evals[i]), commitment, witness)
    assert not verifier.verify_eval((i, evals[i]), witness, commitment)
    assert KZGVerifierEvalForm(verifier.params, verifier.lagrange, engine="oracle")._engine() \
        == "oracle"


@pytest.fixture(scope="module")
def small():
    params = setup(SECRET, D)
    lagrange = compute_lagrange_basis_from_secret(SECRET, EXP)
    evals = _evals(77, D)
    prover = KZGProverEvalForm(params, lagrange)
    return params, lagrange, evals, prover, prover.commit(_words(evals))


def test_commit_and_verify_poly(small):
    params, lagrange, evals, _, commitment = small
    # C = g^{f(s)}: against host ints through the coefficient form
    coeffs = FR.decode(Domain(EXP).intt(_words(evals)))
    from kzg_tpu_torch import native
    from kzg_tpu_torch.curve import g1_from_device
    from kzg_tpu_torch.oracle import g1_generator

    assert g1_from_device(tuple(t[..., None] for t in commitment))[0] == native.g1_mul(
        g1_generator(), _horner(coeffs, SECRET))
    assert KZGVerifierEvalForm(params, lagrange).verify_poly(commitment, _words(evals))


def test_witness_at_the_last_index(small):
    params, lagrange, evals, prover, commitment = small
    i = D - 1
    witness = prover.create_witness(_words(evals), i)
    verifier = KZGVerifierEvalForm(params, lagrange)
    assert verifier.verify_eval((i, evals[i]), commitment, witness)
    assert not verifier.verify_eval((0, evals[i]), commitment, witness)


def test_open_all_points(small):
    params, lagrange, evals, prover, commitment = small
    w = prover.create_witness_all()
    assert bool(G1.is_inf(w))  # identity (eval_form.rs:142-146)
    bw = KZGBatchWitnessEvalForm(r=_words(evals), w=w)
    assert KZGVerifierEvalForm(params, lagrange).verify_eval_all(commitment, bw)


def test_tampered_evaluation_rejected_and_coeff_form_commit(small):
    params, lagrange, evals, _, commitment = small
    tampered = _words(evals).clone()
    tampered[:, 3] = FR.one(())
    assert not KZGVerifierEvalForm(params, lagrange).verify_poly(commitment, tampered)
    # committing evaluations over the Lagrange SRS == committing the
    # interpolated coefficients over the monomial SRS
    coeffs = Domain(EXP).intt(_words(evals))
    assert bool(G1.eq(commitment, KZGProver(params).commit(Polynomial(coeffs, D - 1))))


@pytest.mark.slow
def test_more_rejections_and_witnesses(small):
    params, lagrange, evals, prover, commitment = small
    verifier = KZGVerifierEvalForm(params, lagrange)
    other = _words(_evals(78, D))
    assert not verifier.verify_poly(commitment, other)
    w = prover.create_witness_all()
    assert not verifier.verify_eval_all(commitment, KZGBatchWitnessEvalForm(r=other, w=w))
    for i in (0, 4):
        witness = prover.create_witness(_words(evals), i)
        assert verifier.verify_eval((i, evals[i]), commitment, witness)
