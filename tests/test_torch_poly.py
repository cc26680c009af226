"""Port polynomial layer (kzg_tpu_torch.poly: NTT products, long division on
its schoolbook and Newton branches, subproduct trees, interpolation) on CPU
tensors (plain kernel twins) against host-int polynomial arithmetic over Fr,
exact. The `slow` cases hold the same functions against the JAX package's
(`kzg_tpu.poly`), limb for limb, as tests/test_poly.py and test_newton.py
are marked: their XLA compiles take minutes on a CPU.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kzg_tpu_torch import config
from kzg_tpu_torch.constants import R
from kzg_tpu_torch.fields import FR
from kzg_tpu_torch.fields.limb import unpack16
from kzg_tpu_torch.poly import (
    Polynomial,
    SubProductTree,
    inv_series,
    lagrange_interpolation,
    lagrange_interpolation_with_tree,
    multi_eval_tree,
    newton_divmod,
    op_tree,
    poly_derivative,
    vanishing_poly,
)
from kzg_tpu_torch.poly.polynomial import _mul_naive, _mul_ntt


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


def _ints(seed, n):
    rs = np.random.default_rng(seed)
    return [int.from_bytes(rs.bytes(32), "little") % R for _ in range(n)]


def _t(ints):
    return torch.from_numpy(FR.encode(ints))


def _mul(a, b):
    out = [0] * (len(a) + len(b) - 1)
    for i, x in enumerate(a):
        for j, y in enumerate(b):
            out[i + j] = (out[i + j] + x * y) % R
    return out


def _divmod(f, d):
    """Schoolbook f / d over Fr: (quotient, remainder of len(d) - 1)."""
    f = list(f)
    inv = pow(d[-1], -1, R)
    q = [0] * (len(f) - len(d) + 1)
    for i in range(len(q) - 1, -1, -1):
        c = f[i + len(d) - 1] * inv % R
        q[i] = c
        for j, y in enumerate(d):
            f[i + j] = (f[i + j] - c * y) % R
    return q, f[: len(d) - 1]


def _eval(c, x):
    y = 0
    for a in reversed(c):
        y = (y * x + a) % R
    return y


def _vanishing(xs):
    z = [1]
    for x in xs:
        z = _mul(z, [(-x) % R, 1])
    return z


@pytest.mark.parametrize("na,nb", [(1, 1), (3, 5), (17, 9), (64, 64)])
def test_mul_ntt_and_naive_match_host(na, nb):
    a, b = _ints(na, na), _ints(100 + nb, nb)
    want = _mul(a, b)
    assert FR.decode(_mul_ntt(_t(a), _t(b), na + nb - 1)) == want
    assert FR.decode(_mul_naive(_t(a), _t(b))) == want
    pa, pb = Polynomial.from_ints(a), Polynomial.from_ints(b)
    assert (pa * pb).to_ints() == want and pa.naive_mul(pb).to_ints() == want


def test_mul_ntt_batched():
    a = [_ints(1, 4), _ints(2, 4), _ints(3, 4)]
    b = [_ints(4, 4), _ints(5, 4), _ints(6, 4)]
    ta = torch.stack([_t(v) for v in a], dim=1)  # (8, 3, 4)
    tb = torch.stack([_t(v) for v in b], dim=1)
    got = _mul_ntt(ta, tb, 7)
    for i in range(3):
        assert FR.decode(got[:, i]) == _mul(a[i], b[i])


@pytest.mark.parametrize("nf,nd", [(20, 4), (40, 3), (70, 9)])
def test_long_division_both_branches(nf, nd):
    """20/4 takes the schoolbook loop (17 quotient terms <= 32), 40/3 and
    70/9 Newton division; each also divides an exact multiple."""
    assert config.get_config().newton_div_threshold == 32
    f, d = _ints(nf, nf), _ints(200 + nd, nd)
    q, r = Polynomial.from_ints(f).long_division(Polynomial.from_ints(d))
    wq, wr = _divmod(f, d)
    assert q.to_ints() == wq and r is not None and r.to_ints() == wr
    exact = _mul(wq, d)
    q2, r2 = Polynomial.from_ints(exact).long_division(Polynomial.from_ints(d))
    assert q2.to_ints() == wq and r2 is None


def test_newton_divmod_and_inv_series():
    f, d = _ints(7, 45), _ints(8, 6)
    q, r = newton_divmod(_t(f), _t(d), 45, 6)
    wq, wr = _divmod(f, d)
    assert FR.decode(q) == wq and FR.decode(r) == wr
    g = inv_series(_t(d), 10)
    assert _mul(d, FR.decode(g))[:10] == [1] + [0] * 9


def test_vanishing_and_derivative():
    for k in (1, 2, 5, 16):
        xs = _ints(300 + k, k)
        z = vanishing_poly(_t(xs))
        want = _vanishing(xs)
        assert z.to_ints() == want
        assert poly_derivative(z).to_ints() == [i * c % R for i, c in enumerate(want)][1:]


@pytest.mark.parametrize("k", [1, 2, 7])
def test_lagrange_interpolation(k):
    xs, ys = _ints(400 + k, k), _ints(500 + k, k)
    r = lagrange_interpolation(_t(xs), _t(ys))
    if k == 1:
        # the reference's quirk: X + (y0 - x0), not the constant y0
        assert r.degree == 1 and r.to_ints() == [(ys[0] - xs[0]) % R, 1]
        return
    assert r.degree == k - 1
    assert [_eval(r.to_ints(), x) for x in xs] == ys


def test_subproduct_tree_and_multi_eval(monkeypatch):
    xs = _ints(600, 8)
    f = _ints(601, 30)
    tree = SubProductTree.from_points(_t(xs))
    assert tree.product.to_ints() == _vanishing(xs)
    want = [_eval(f, x) for x in xs]
    poly = Polynomial.from_ints(f)
    assert FR.decode(tree.eval_points(poly)) == want  # direct branch
    monkeypatch.setattr(
        config, "_config", dataclasses.replace(config.get_config(), tree_eval_threshold=2)
    )
    assert FR.decode(tree.eval_points(poly)) == want  # remainder tree
    ys = _ints(602, 8)
    r = lagrange_interpolation_with_tree(_t(xs), _t(ys), tree)
    assert [_eval(r.to_ints(), x) for x in xs] == ys
    xs5 = xs[:5]
    assert FR.decode(multi_eval_tree(poly, _t(xs5))) == want[:5]  # k padded to 8
    assert FR.decode(poly.eval_many(_t(xs5))) == want[:5]


def test_polynomial_constructors_and_bookkeeping():
    assert Polynomial.new_zero().is_zero()
    assert Polynomial.from_scalar(5).to_ints() == [5]
    assert Polynomial.new_monic_of_degree(3).to_ints() == [1, 1, 1, 1]
    assert Polynomial.new_single_term(3).to_ints() == [0, 0, 0, 1]
    assert Polynomial.new_zero_with_size(4).coeffs.shape == (FR.W, 4)
    c = _ints(700, 6)
    p = Polynomial.from_ints(c + [0, 0], degree=7)
    assert p.fixup_degree().degree == 5 and p.lead() == c[-1] and p.constant() == c[0]
    assert p.reverse().to_ints() == c[::-1]
    assert p.truncate(2).to_ints() == c[:3] and p.truncate(99).degree == 7  # clamped to storage
    q = Polynomial.from_ints(_ints(701, 3))
    assert (p + q).to_ints() == [(a + b) % R for a, b in zip(c, q.to_ints() + [0] * 3)]
    assert (p - p).shrink_degree().degree == 0 and (p - p).is_zero()
    assert p.scalar_mul(3).to_ints() == [3 * a % R for a in c]
    assert p == Polynomial.from_ints(c) and not p == q
    parts = [Polynomial.from_ints([(-x) % R, 1]) for x in _ints(702, 5)]
    prod = op_tree(5, lambda i: parts[i], lambda a, b: a * b)
    assert prod.to_ints() == _vanishing(_ints(702, 5))


# ---- against the JAX package (XLA compiles: slow) --------------------------------------

def _j(ints):
    from kzg_tpu.fields import FR as JFR

    return jnp.asarray(JFR.encode(ints))


def _same(port, jax):
    np.testing.assert_array_equal(unpack16(port).numpy().astype(np.uint32), np.asarray(jax))


@pytest.mark.slow
def test_poly_matches_jax():
    from kzg_tpu import poly as jpoly
    from kzg_tpu.poly.polynomial import _mul_ntt as jmul_ntt

    a, b = _ints(800, 13), _ints(801, 7)
    _same(_mul_ntt(_t(a), _t(b), 19), jmul_ntt(_j(a), _j(b), 19))
    f, d = _ints(802, 50), _ints(803, 5)
    q, r = Polynomial.from_ints(f).long_division(Polynomial.from_ints(d))
    jq, jr = jpoly.Polynomial.from_ints(f).long_division(jpoly.Polynomial.from_ints(d))
    _same(q.trimmed(), jq.trimmed())
    _same(r.trimmed(), jr.trimmed())
    xs, ys = _ints(804, 6), _ints(805, 6)
    _same(vanishing_poly(_t(xs)).trimmed(), jpoly.vanishing_poly(_j(xs)).trimmed())
    _same(lagrange_interpolation(_t(xs), _t(ys)).trimmed(),
          jpoly.lagrange_interpolation(_j(xs), _j(ys)).trimmed())
    xs8 = _ints(806, 8)
    poly, jp = Polynomial.from_ints(f), jpoly.Polynomial.from_ints(f)
    _same(multi_eval_tree(poly, _t(xs8)), jpoly.multi_eval_tree(jp, _j(xs8)))
