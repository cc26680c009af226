"""Port G2 (kzg_tpu_torch.curve over Fp2, the plain twins of the G2 point
kernels on CPU) against the pure-Python oracle and the native engine, exact.

  * Fp2Adapter mul / sqr / add / sub / neg / batch_inv against the
    oracle's Fp2;
  * G2 add / dbl on lanes with infinity, P + P (under another Z) and
    P + (-P), against oracle point sums;
  * G2 madd (the plain twin of K6 over Fp2) on the same lanes under skip
    masks, G2 madd_multi (the plain twin of K7 over Fp2: three steps with
    skip and neg masks), and the G2 digit ladder `scalar_mul_digits` at
    c = 3, 4, 5, against the oracle / the native engine;
  * msm_g2 on the ladder (17 points, one at infinity, one zero scalar)
    against `native.g2_msm`; g2_from_device of Jacobian batches; msm_g2 at
    small_msm_threshold points takes the bucket route (G2 Pippenger is in
    tests/test_torch_msm_g2.py).
The `slow` case holds add / dbl / madd / madd_multi limb for limb, and msm_g2 in affine
form, against the JAX package's G2 (its XLA compiles take minutes on a CPU).
"""

import numpy as np
import pytest
import torch

from kzg_tpu_torch import config, native
from kzg_tpu_torch.constants import P, R
from kzg_tpu_torch.curve import (
    FP2,
    G2,
    cuda_ops,
    g2_from_device,
    g2_generator_device,
    g2_to_device,
)
from kzg_tpu_torch.fields import FP, FR
from kzg_tpu_torch.fields.limb import unpack16
from kzg_tpu_torch.msm import msm_g2
from kzg_tpu_torch.oracle import ec_add, ec_mul, ec_neg, g2_generator
from kzg_tpu_torch.oracle.field import Fp2

N = 8

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


def _rand(rs, mod, k):
    return [int.from_bytes(rs.bytes(48), "little") % (mod - 1) + 1 for _ in range(k)]


def _fp2_tensor(pairs):
    """[(c0, c1)] -> (12, 2, n) Montgomery words."""
    return torch.from_numpy(
        np.stack([FP.encode([a for a, _ in pairs]), FP.encode([b for _, b in pairs])], axis=1)
    )


def _fp2_ints(t):
    return list(zip(FP.decode(t[:, 0]), FP.decode(t[:, 1])))


def _points(rs, k):
    return [native.g2_mul(g2_generator(), s) for s in _rand(rs, R, k)]


def _jacobian(pts, zs):
    """Oracle points at the Fp2 Z values zs (None -> (1, 1, 0))."""
    cols = ([], [], [])
    for pt, z in zip(pts, zs):
        if pt is None:
            vals = (Fp2.from_ints(1, 0), Fp2.from_ints(1, 0), Fp2.from_ints(0, 0))
        else:
            z2 = z * z
            vals = (pt[0] * z2, pt[1] * z2 * z, z)
        for c, v in zip(cols, vals):
            c.append((v.a.n, v.b.n))
    return tuple(_fp2_tensor(c) for c in cols)


def test_fp2_ops_match_oracle():
    rs = np.random.default_rng(1)
    xs = list(zip(_rand(rs, P, 6), _rand(rs, P, 6)))
    ys = list(zip(_rand(rs, P, 6), _rand(rs, P, 6)))
    xs[0], ys[1] = (0, 0), (P - 1, 0)
    a, b = _fp2_tensor(xs), _fp2_tensor(ys)
    ox = [Fp2.from_ints(*v) for v in xs]
    oy = [Fp2.from_ints(*v) for v in ys]

    def ints(vals):
        return [(v.a.n, v.b.n) for v in vals]

    assert _fp2_ints(FP2.mul(a, b)) == ints([x * y for x, y in zip(ox, oy)])
    assert _fp2_ints(FP2.sqr(a)) == ints([x * x for x in ox])
    assert _fp2_ints(FP2.add(a, b)) == ints([x + y for x, y in zip(ox, oy)])
    assert _fp2_ints(FP2.sub(a, b)) == ints([x - y for x, y in zip(ox, oy)])
    assert _fp2_ints(FP2.neg(a)) == ints([-x for x in ox])
    inv = _fp2_ints(FP2.batch_inv(a))
    assert inv[0] == (0, 0)  # inv(0) = 0
    for got, x in zip(inv[1:], ox[1:]):
        assert Fp2.from_ints(*got) * x == Fp2.from_ints(1, 0)
    assert FP2.is_zero(a).tolist() == [True] + [False] * 5
    assert FP2.eq(a, a).all() and not FP2.eq(a, b).any()
    assert _fp2_ints(FP2.one((2,))) == [(1, 0), (1, 0)]


@pytest.fixture(scope="module")
def operands():
    """P and Q batches: lane 0 P = inf, 1 Q = inf, 2 both, 3 Q = P under
    another Z, 4 Q = -P, 5.. generic."""
    rs = np.random.default_rng(2)
    ps, qs = _points(rs, N), _points(rs, N)
    ps[0] = None
    qs[1] = None
    ps[2] = qs[2] = None
    qs[3] = ps[3]
    qs[4] = ec_neg(ps[4])

    def zs():
        return [Fp2.from_ints(a, b) for a, b in zip(_rand(rs, P, N), _rand(rs, P, N))]

    return _jacobian(ps, zs()), _jacobian(qs, zs()), ps, qs


def test_g2_add_dbl_match_oracle(operands):
    p, q, ps, qs = operands
    out = cuda_ops.g2_add(p, q)  # CPU: the plain twin
    assert g2_from_device(out) == [ec_add(a, b) for a, b in zip(ps, qs)]
    assert [bool(v) for v in G2.is_inf(out)] == [False, False, True, False, True] + [False] * 3
    assert g2_from_device(cuda_ops.g2_dbl(p)) == [ec_add(a, a) for a in ps]
    assert g2_from_device(G2.add(p, q)) == g2_from_device(out)
    assert G2.eq(G2.add(p, q), G2.add(q, p)).all()


def test_msm_g2_ladder_matches_native():
    rs = np.random.default_rng(3)
    n = 17
    pts = _points(rs, n)
    pts[5] = None
    scal = [int.from_bytes(rs.bytes(32), "little") % R for _ in range(n)]
    scal[9] = 0
    x, y, z = g2_to_device(pts)
    inf = (z == 0).all(dim=0).all(dim=0)
    got = msm_g2((x, y, inf), torch.from_numpy(FR.encode(scal)))
    assert got[0].shape == (FP.W, 2)  # one Jacobian point
    assert g2_from_device(tuple(t[..., None] for t in got))[0] == native.g2_msm(pts, scal)


def test_g2_from_device_and_generator():
    g = g2_generator_device(3)
    assert g2_from_device(g) == [g2_generator()] * 3
    two = G2.dbl(g)  # Jacobian, Z != 1
    assert g2_from_device(two) == [ec_mul(g2_generator(), 2)] * 3
    x, y, inf = G2.to_affine(two)
    assert g2_from_device((x, y, inf)) == g2_from_device(two)


def test_msm_g2_at_bucket_threshold_raises():
    """At small_msm_threshold points msm_g2 used to raise for want of the
    Fp2 bucket kernels; it now takes the bucket route and returns the sum:
    512 copies of the generator under scalars 0, ..., 0, 3, 5 give 8 g."""
    g = g2_generator_device(512)
    inf = torch.zeros(512, dtype=torch.bool)
    scal = torch.from_numpy(FR.encode([0] * 510 + [3, 5]))
    got = msm_g2((g[0], g[1], inf), scal)
    assert got[0].shape == (FP.W, 2)
    assert g2_from_device(tuple(t[..., None] for t in got))[0] == ec_mul(g2_generator(), 8)


def _affine(pts):
    """Oracle points -> affine (x, y) Fp2 tensors; None -> (1, 1)."""
    one = Fp2.from_ints(1, 0)
    xs = [(one if pt is None else pt[0]) for pt in pts]
    ys = [(one if pt is None else pt[1]) for pt in pts]
    return (_fp2_tensor([(v.a.n, v.b.n) for v in xs]), _fp2_tensor([(v.a.n, v.b.n) for v in ys]))


@pytest.mark.parametrize("mask", ["q-infinite", "all", "even", "none-but-inf"])
def test_g2_madd_matches_oracle(operands, mask):
    p, _, ps, qs = operands
    q_inf = np.array([pt is None for pt in qs])
    skip = {"q-infinite": q_inf, "all": np.ones(N, dtype=bool),
            "even": q_inf | (np.arange(N) % 2 == 0),
            "none-but-inf": q_inf | (np.arange(N) == 4)}[mask]
    out = G2.madd(p, _affine(qs), torch.from_numpy(skip))  # CPU: the plain twin
    assert all(torch.equal(a, b) for a, b in zip(
        out, cuda_ops.g2_madd_plain(p, _affine(qs), torch.from_numpy(skip))))
    assert g2_from_device(out) == [a if s else ec_add(a, b) for a, b, s in zip(ps, qs, skip)]
    for i in np.nonzero(skip)[0]:  # skipped lanes keep p word for word
        assert all(torch.equal(o[..., i], t[..., i]) for o, t in zip(out, p))


def _madd_multi_case(operands):
    """Three steps over the operand lanes: + Q (lane 3 doubles, lane 4
    cancels), - Q on two lanes in three, + P; (points, skip, neg)."""
    _, _, ps, qs = operands
    steps = (qs, qs, ps)
    inf = np.array([[pt is None for pt in pts] for pts in steps])
    skip = inf | np.array([np.zeros(N, bool), np.arange(N) % 3 == 0, np.arange(N) == 6])
    neg = np.array([np.zeros(N, bool), np.ones(N, bool), np.arange(N) % 2 == 1])
    q = tuple(torch.stack([_affine(pts)[i] for pts in steps], dim=2) for i in range(2))
    return steps, q, skip, neg


@pytest.mark.parametrize("use_neg", [True, False], ids=["neg", "no-neg"])
def test_g2_madd_multi_matches_oracle(operands, use_neg):
    """The fused bucket-loop step over Fp2 (plain twin of K7): (12, 2, S, n)
    points, (S, n) masks, against oracle sums and the step-by-step madds."""
    p, _, ps, _ = operands
    steps, q, skip, neg = _madd_multi_case(operands)
    neg_t = torch.from_numpy(neg) if use_neg else None
    out = G2.madd_multi(p, q, torch.from_numpy(skip), neg_t)  # CPU: the plain twin
    assert all(torch.equal(a, b) for a, b in zip(
        out, cuda_ops.g2_madd_multi_plain(p, q, torch.from_numpy(skip), neg_t)))
    want = list(ps)
    for pts, sk, ng in zip(steps, skip, neg if use_neg else np.zeros_like(neg)):
        want = [a if s else ec_add(a, ec_neg(b) if n_ else b)
                for a, b, s, n_ in zip(want, pts, sk, ng)]
    assert g2_from_device(out) == want


@pytest.mark.parametrize("c", [3, 4, 5])
def test_g2_scalar_mul_digits_matches_native(c):
    """4 windows of c bits over 4 lanes: a point at infinity, a zero scalar,
    an all-ones scalar. The table axis sits after the two word axes:
    (12, 2, T, n)."""
    rs = np.random.default_rng(50 + c)
    w_count = 4
    pts = _points(rs, 4)
    pts[1] = None
    scal = [int(rs.integers(1, 1 << (c * w_count))) for _ in range(4)]
    scal[2] = 0
    scal[3] = (1 << (c * w_count)) - 1
    zs = [Fp2.from_ints(a, b) for a, b in zip(_rand(rs, P, 4), _rand(rs, P, 4))]
    rows = [[(k >> (c * w)) & ((1 << c) - 1) for k in scal] for w in range(w_count - 1, -1, -1)]
    got = g2_from_device(G2.scalar_mul_digits(_jacobian(pts, zs), torch.tensor(rows), c))
    assert got == [None if pt is None or k == 0 else native.g2_mul(pt, k)
                   for pt, k in zip(pts, scal)]


def _same(port_pt, jax_pt):
    for a, b in zip(port_pt, jax_pt):
        np.testing.assert_array_equal(unpack16(a).numpy().astype(np.uint32), np.asarray(b))


@pytest.mark.slow
def test_g2_matches_jax_limb_for_limb(operands):
    import jax.numpy as jnp

    from kzg_tpu import curve as jcurve
    from kzg_tpu.msm import msm_g2 as jmsm_g2
    from kzg_tpu.fields import FR as JFR

    p, q, _, _ = operands
    jp = tuple(jnp.asarray(unpack16(t).numpy().astype(np.uint32)) for t in p)
    jq = tuple(jnp.asarray(unpack16(t).numpy().astype(np.uint32)) for t in q)
    _same(cuda_ops.g2_add(p, q), jcurve.G2.add(jp, jq))
    _same(cuda_ops.g2_dbl(p), jcurve.G2.dbl(jp))
    _, _, _, qs = operands
    skip = np.array([pt is None for pt in qs]) | (np.arange(N) == 6)
    jqa = tuple(jnp.asarray(unpack16(t).numpy().astype(np.uint32)) for t in _affine(qs))
    _same(cuda_ops.g2_madd(p, _affine(qs), torch.from_numpy(skip)),
          jcurve.G2.madd(jp, jqa, jnp.asarray(skip)))
    _, qm, skip, neg = _madd_multi_case(operands)
    jqm = tuple(jnp.asarray(unpack16(t).numpy().astype(np.uint32)) for t in qm)
    jacc = jp
    for st in range(3):  # the step loop the Pallas madd_multi is held to
        jy = jnp.where(jnp.asarray(neg[st])[None, None], jcurve.FP2A.neg(jqm[1][:, :, st]),
                       jqm[1][:, :, st])
        jacc = jcurve.G2.madd(jacc, (jqm[0][:, :, st], jy), jnp.asarray(skip[st]))
    _same(cuda_ops.g2_madd_multi(p, qm, torch.from_numpy(skip), torch.from_numpy(neg)), jacc)
    rs = np.random.default_rng(4)
    pts = _points(rs, 5)
    scal = [int.from_bytes(rs.bytes(32), "little") % R for _ in range(5)]
    x, y, z = g2_to_device(pts)
    inf = (z == 0).all(dim=0).all(dim=0)
    got = msm_g2((x, y, inf), torch.from_numpy(FR.encode(scal)))
    jx, jy, jz = jcurve.g2_to_device(pts)
    want = jmsm_g2((jx, jy, jnp.asarray(inf.numpy())), jnp.asarray(JFR.encode(scal)))
    # Jacobian Z depends on the summation order (tree here, scan in the
    # JAX package's CPU path): compare the affine words
    _same(G2.to_affine(tuple(t[..., None] for t in got))[:2],
          jcurve.G2.to_affine(tuple(t[..., None] for t in want))[:2])
