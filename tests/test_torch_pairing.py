"""The device pairing (`kzg_tpu_torch/pairing/`) and its engine
(`kzg/engines.py`) on the CPU, where every tower operation runs K1's plain
twin and every inverse the plain `field_pow` loop:

  * the tower ops (f2 / f6 / f12 mul, sqr, inv, conj, frobenius and the
    cyclotomic squaring) equal the JAX package's `tower` functions, called
    eagerly, word for word, and the oracle's (`oracle/field.py`);
  * the joint Frobenius ladder at small exponents equals the oracle's
    powers, and the subset table's stacked products their one-by-one form;
  * one Miller step (tangent, then chord) from f = 1, T = Q, and the easy
    part of the final exponentiation equal the oracle's;
  * `slow` (the plain `field_pow` inverses, ~0.7 s each, 69 a pairing):
    the full pairing equals the oracle's `pairing`, and `verify_eval` /
    `verify_eval_batched` with `engine="device"` give the host engine's
    verdicts on a small proof, true and tampered.

Tolerance 0: exact integer arithmetic. Elements and scalars from numpy
seeds. The same checks run on the card in `tests/test_torch_cuda.py` and
`chip_smoke.py`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kzg_tpu.pairing import tower as jtw
from kzg_tpu_torch import config, native
from kzg_tpu_torch.constants import P, R
from kzg_tpu_torch.curve import g1_to_device, g2_to_device
from kzg_tpu_torch.fields import FR
from kzg_tpu_torch.fields.limb import unpack16
from kzg_tpu_torch.oracle import g1_generator, g2_generator, pairing
from kzg_tpu_torch.oracle.curve import _line, untwist
from kzg_tpu_torch.oracle.field import Fp, Fp2, Fp6, Fp12
from kzg_tpu_torch.pairing import pairing as pmod
from kzg_tpu_torch.pairing import tower as tw


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


def _rand_f12(rs):
    f2 = lambda: Fp2(Fp(int.from_bytes(rs.bytes(48), "little") % P),  # noqa: E731
                     Fp(int.from_bytes(rs.bytes(48), "little") % P))
    return Fp12(Fp6(f2(), f2(), f2()), Fp6(f2(), f2(), f2()))


def _batch(elems):
    """Oracle Fp12 elements -> (12, 12, k) words."""
    return torch.stack([tw.f12_from_oracle(e) for e in elems], dim=-1)


def _oracle(x):
    """(12, 12, k) words -> oracle elements."""
    return [tw.f12_to_oracle(x[..., i]) for i in range(x.shape[-1])]


def _jax(x):
    return jnp.asarray(unpack16(x).numpy().astype(np.uint32))


def _same_as_jax(got, want):
    np.testing.assert_array_equal(unpack16(got).numpy().astype(np.uint32), np.asarray(want))


@pytest.fixture(scope="module")
def elems():
    rs = np.random.default_rng(12)
    a = [_rand_f12(rs) for _ in range(2)]
    b = [_rand_f12(rs) for _ in range(2)]
    return a, b


def _level(x, level):
    """The Fp2 (component 0 of c0), Fp6 (c0) or Fp12 slice of (12, 12, k)."""
    return {"f2": x[:, 0:2], "f6": x[:, 0:6], "f12": x}[level]


def _oracle_level(e, level):
    return {"f2": e.c0.c0, "f6": e.c0, "f12": e}[level]


OPS = {
    # name: (level, port, jax, oracle, operands)
    "f2_mul": ("f2", tw.f2_mul, jtw.f2_mul, lambda a, b: a * b, 2),
    "f2_sqr": ("f2", tw.f2_sqr, jtw.f2_sqr, lambda a: a.square(), 1),
    "f2_inv": ("f2", tw.f2_inv, jtw.f2_inv, lambda a: a.inv(), 1),
    "f2_conj": ("f2", tw.f2_conj, jtw.f2_conj, lambda a: a.conj(), 1),
    "f2_mul_xi": ("f2", tw.f2_mul_xi, jtw.f2_mul_xi, lambda a: a.mul_xi(), 1),
    "f6_mul": ("f6", tw.f6_mul, jtw.f6_mul, lambda a, b: a * b, 2),
    "f6_sqr": ("f6", tw.f6_sqr, jtw.f6_sqr, lambda a: a.square(), 1),
    "f6_inv": ("f6", tw.f6_inv, jtw.f6_inv, lambda a: a.inv(), 1),
    "f6_mul_v": ("f6", tw.f6_mul_v, jtw.f6_mul_v, lambda a: a.mul_v(), 1),
    "f6_frobenius": ("f6", tw.f6_frobenius, jtw.f6_frobenius, lambda a: a.frobenius(), 1),
    "f12_mul": ("f12", tw.f12_mul, jtw.f12_mul, lambda a, b: a * b, 2),
    "f12_sqr": ("f12", tw.f12_sqr, jtw.f12_sqr, lambda a: a.square(), 1),
    "f12_inv": ("f12", tw.f12_inv, jtw.f12_inv, lambda a: a.inv(), 1),
    "f12_conj": ("f12", tw.f12_conj, jtw.f12_conj, lambda a: a.conj(), 1),
    "f12_frobenius": ("f12", tw.f12_frobenius, jtw.f12_frobenius, lambda a: a.frobenius(), 1),
}


@pytest.mark.parametrize("name", list(OPS))
def test_tower_op_matches_jax_and_oracle(elems, name):
    level, port_fn, jax_fn, oracle_fn, arity = OPS[name]
    a, b = elems
    xs = [_level(_batch(a), level), _level(_batch(b), level)][:arity]
    got = port_fn(*xs)
    _same_as_jax(got, jax_fn(*[_jax(x) for x in xs]))
    for i in range(2):
        operands = [_oracle_level(a[i], level), _oracle_level(b[i], level)][:arity]
        full = tw.f12_zero((), "cpu")
        full[:, :got.shape[1]] = got[..., i]
        assert _oracle_level(tw.f12_to_oracle(full), level) == oracle_fn(*operands), i


def _cyclotomic(e):
    """The easy part of the final exponentiation by the oracle: an element
    of the cyclotomic subgroup."""
    e = e.conj() * e.inv()
    return e.frobenius().frobenius() * e


def test_cyclotomic_sqr_matches_jax_and_oracle(elems):
    cyc = [_cyclotomic(e) for e in elems[0]]
    x = _batch(cyc)
    got = tw.f12_cyclotomic_sqr(x)
    _same_as_jax(got, jtw.f12_cyclotomic_sqr(_jax(x)))
    assert _oracle(got) == [e.square() for e in cyc]
    assert torch.equal(got, tw.f12_sqr(x))


def test_joint_pow_frobenius_small_exponents(elems):
    """prod (f^(p^i))^(e_i) at small exponents (a zero bit column inside)
    against the oracle, cyclotomic and generic squarings."""
    cyc = _cyclotomic(elems[0][0])
    exps = [0b1011, 0b0110, 0b1001, 0b0001]
    want = Fp12.one()
    fi = cyc
    for e in exps:
        want = want * fi.pow(e)
        fi = fi.frobenius()
    x = tw.f12_from_oracle(cyc)
    for cyclo in (True, False):
        assert tw.f12_to_oracle(tw.f12_joint_pow_frobenius(x, exps, cyclo)) == want
    assert tw.f12_to_oracle(tw.f12_pow_static(x, 0b1011)) == cyc.pow(0b1011)


def test_subset_table_matches_products(elems):
    fs = [tw.f12_from_oracle(e) for e in elems[0] + elems[1]]
    table = tw._subset_table(fs)
    os = elems[0] + elems[1]
    for mask in range(1, 16):
        want = Fp12.one()
        for i in range(4):
            if mask >> i & 1:
                want = want * os[i]
        assert tw.f12_to_oracle(table[mask]) == want, mask


def test_f12_is_one_and_select():
    one = tw.f12_one((2,), "cpu")
    other = one.clone()
    other[0, 3, 1] = 5
    assert tw.f12_is_one(other).tolist() == [True, False]
    sel = tw.f12_select(torch.tensor([False, True]), one, other)
    assert tw.f12_is_one(sel).tolist() == [True, True]


def _points(k):
    rs = np.random.default_rng(77)
    ps = [native.g1_mul(g1_generator(), int.from_bytes(rs.bytes(32), "little") % R)
          for _ in range(k)]
    qs = [native.g2_mul(g2_generator(), int.from_bytes(rs.bytes(32), "little") % R)
          for _ in range(k)]
    return ps, qs


def _affine(points, to_device):
    x, y, _ = to_device(points, device="cpu")
    return x, y


def test_miller_steps_match_oracle():
    """From f = 1 and T = Q untwisted: one tangent step, then one chord
    step, each against the oracle's f^2 l_{T,T}(P), 2T and f l_{T,Q}(P),
    T + Q, for two pairs in lanes."""
    from kzg_tpu_torch.oracle import ec_add

    ps, qs = _points(2)
    p_aff = _affine(ps, g1_to_device)
    q = pmod.untwist_device(*_affine(qs, g2_to_device))
    p = (pmod._fp_to_f12(p_aff[0]), pmod._fp_to_f12(p_aff[1]))
    f = tw.f12_one((2,), "cpu")
    f, t = pmod._line_step(f, q, p)
    f2, t2 = pmod._line_step(f, t, p, q)
    for i in range(2):
        uq = untwist(qs[i])
        up = (Fp12.from_fp(ps[i][0]), Fp12.from_fp(ps[i][1]))
        assert _oracle(q[0])[i] == uq[0] and _oracle(q[1])[i] == uq[1]
        want_f = _line(uq, uq, up)
        want_t = ec_add(uq, uq)
        assert _oracle(f)[i] == want_f
        assert (_oracle(t[0])[i], _oracle(t[1])[i]) == want_t
        assert _oracle(f2)[i] == want_f * _line(want_t, uq, up)
        assert (_oracle(t2[0])[i], _oracle(t2[1])[i]) == ec_add(want_t, uq)


def test_final_exp_easy_matches_oracle(elems):
    got = pmod.final_exp_easy(_batch(elems[0]))
    assert _oracle(got) == [_cyclotomic(e) for e in elems[0]]


def test_loop_bits_and_hard_digits():
    n = sum(b << i for i, b in enumerate(reversed((1,) + pmod.LOOP_BITS)))
    assert -n == pmod.BLS_X
    assert sum(h * P ** i for i, h in enumerate(pmod.HARD_BASE_P)) == (P ** 4 - P ** 2 + 1) // R


@pytest.mark.slow
def test_pairing_device_matches_oracle():
    ps, qs = _points(2)
    got = pmod.pairing_device(_affine(ps, g1_to_device), _affine(qs, g2_to_device))
    assert _oracle(got) == [pairing(p, q) for p, q in zip(ps, qs)]


@pytest.mark.slow
def test_device_engine_verdicts_match_host():
    """verify_eval and verify_eval_batched with engine="device" against the
    host engine on a 16-coefficient proof, true and tampered."""
    from kzg_tpu_torch.kzg import setup
    from kzg_tpu_torch.kzg.coeff_form import KZGProver, KZGVerifier
    from kzg_tpu_torch.poly import Polynomial

    rs = np.random.default_rng(16)
    coeffs = [int.from_bytes(rs.bytes(32), "little") % R for _ in range(16)]
    x = int.from_bytes(rs.bytes(32), "little") % R
    y = sum(c * pow(x, i, R) for i, c in enumerate(coeffs)) % R
    params = setup(0xC0FFEE, 16)
    prover = KZGProver(params)
    poly = Polynomial.from_ints(coeffs)
    c, w = prover.commit(poly), prover.create_witness(poly, (x, y))
    host, dev = KZGVerifier(params, engine="host"), KZGVerifier(params, engine="device")
    for yy in (y, (y + 1) % R):
        assert dev.verify_eval((x, yy), c, w) == host.verify_eval((x, yy), c, w) == (yy == y)
    xs = [x, (x + 5) % R]
    ys = [sum(k * pow(t, i, R) for i, k in enumerate(coeffs)) % R for t in xs]
    bw = prover.create_witness_batched(poly, xs, ys)
    other = [xs[0], (xs[1] + 1) % R]
    for pts in (xs, other):
        assert (dev.verify_eval_batched(c, bw, pts) == host.verify_eval_batched(c, bw, pts)
                == (pts == xs))


def test_device_engine_routes_every_verifier(monkeypatch):
    """configure(pairing_engine="device") sends verify_eval,
    verify_eval_batched and both evaluation-form verifiers to
    `kzg/engines.py`, and none of them to the host pairing (the engine
    and the MSMs before it are stubbed: this checks the routing only)."""
    from kzg_tpu_torch.curve import G1, G2
    from kzg_tpu_torch.kzg import coeff_form, eval_form, setup
    from kzg_tpu_torch.kzg.eval_form import (
        KZGBatchWitnessEvalForm, KZGVerifierEvalForm, compute_lagrange_basis_from_secret)
    from kzg_tpu_torch.poly import Polynomial

    calls = []

    def stub(name):
        def fn(*args):
            calls.append(name)
            return True
        return fn

    def host(*args, **kwargs):
        raise AssertionError("a host pairing ran under pairing_engine='device'")

    for mod in (coeff_form, eval_form):
        monkeypatch.setattr(mod, "verify_eval_device", stub(f"{mod.__name__}.eval"))
        monkeypatch.setattr(mod, "verify_batched_device", stub(f"{mod.__name__}.batched"))
        monkeypatch.setattr(mod, "multi_pairing_check", host)
        monkeypatch.setattr(mod, "msm_g1", lambda *a: G1.infinity((), "cpu"))
        monkeypatch.setattr(mod, "msm_g2", lambda *a: G2.infinity((), "cpu"))
    params = setup(5, 4)
    lag = compute_lagrange_basis_from_secret(5, 1)
    inf = G1.infinity((), "cpu")
    old = config.get_config()
    try:
        config.configure(pairing_engine="device")
        coeff_v = coeff_form.KZGVerifier(params)
        assert coeff_v.verify_eval((3, 4), inf, inf)
        bw = coeff_form.KZGBatchWitness(r=Polynomial.from_ints([1, 2]), w=inf)
        assert coeff_v.verify_eval_batched(inf, bw, [3, 4])
        eval_v = KZGVerifierEvalForm(params, lag)
        assert eval_v.verify_eval((1, 4), inf, inf)
        assert eval_v.verify_eval_all(inf, KZGBatchWitnessEvalForm(r=FR.zeros((2,), "cpu"), w=inf))
    finally:
        config.set_config(old)
    assert calls == ["kzg_tpu_torch.kzg.coeff_form.eval", "kzg_tpu_torch.kzg.coeff_form.batched",
                     "kzg_tpu_torch.kzg.eval_form.eval", "kzg_tpu_torch.kzg.eval_form.batched"]

