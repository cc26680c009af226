"""Port G1 point formulas (plain twins of kernels K2-K4, on CPU) against the
JAX package's XLA `CurveOps`, limb for limb, and the bucket accumulation
twin against per-bucket sums from the native engine. Tolerance 0.

Batches include points at infinity, P + P (the same point under another
Z) and P + (-P). Inputs come from a numpy seed.

`madd` (the plain twin of K6) also runs with live lanes skip-masked, and
`scalar_mul_digits` (the digit ladder over add / dbl / madd) is held against
the native engine's scalar multiplication at windows c = 3, 4, 5; the `slow`
case holds it limb for limb against the JAX function, whose loop bodies
compile for minutes on a CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kzg_tpu import curve as jcurve
from kzg_tpu.fields import FP as JFP
from kzg_tpu_torch import config, native
from kzg_tpu_torch.constants import P, R
from kzg_tpu_torch.curve import G1, cuda_ops, g1_from_device
from kzg_tpu_torch.fields import FP, FR
from kzg_tpu_torch.fields.limb import unpack16
from kzg_tpu_torch.msm import pippenger
from kzg_tpu_torch.oracle import ec_add, g1_generator

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


def _points(rs, k):
    return [native.g1_mul(g1_generator(), s) for s in _rand(rs, R, k)]


def _jacobian_ints(pts, zs):
    """(X, Y, Z) int lists: affine points at random Z; None -> (1, 1, 0)."""
    out = ([], [], [])
    for pt, z in zip(pts, zs):
        if pt is None:
            vals = (1, 1, 0)
        else:
            x, y = pt[0].n, pt[1].n
            vals = (x * z * z % P, y * z * z * z % P, z)
        for o, v in zip(out, vals):
            o.append(v)
    return out


def _both(coords):
    port = tuple(torch.from_numpy(FP.encode(c)) for c in coords)
    jax = tuple(jnp.asarray(JFP.encode(c)) for c in coords)
    return port, jax


def _same(port_pt, jax_pt):
    for a, b in zip(port_pt, jax_pt):
        np.testing.assert_array_equal(unpack16(a).numpy().astype(np.uint32), np.asarray(b))


@pytest.fixture(scope="module")
def operands():
    """P and Q batches: lane 0 P = inf, 1 Q = inf, 2 both inf, 3 Q = P under
    another Z, 4 Q = -P, 5.. generic."""
    rs = np.random.default_rng(11)
    ps = _points(rs, N)
    qs = _points(rs, N)
    ps[0] = None
    qs[1] = None
    ps[2] = qs[2] = None
    qs[3] = ps[3]
    qs[4] = (ps[4][0], -ps[4][1])
    zp, zq = _rand(rs, P, N), _rand(rs, P, N)
    return _both(_jacobian_ints(ps, zp)), _both(_jacobian_ints(qs, zq)), ps, qs


def test_add_matches_jax(operands):
    (p, jp), (q, jq), ps, qs = operands
    out = cuda_ops.add(p, q)
    _same(out, jcurve.G1.add(jp, jq))
    assert g1_from_device(out) == [ec_add(a, b) for a, b in zip(ps, qs)]


def test_dbl_matches_jax(operands):
    (p, jp), _, _, _ = operands
    _same(cuda_ops.dbl(p), jcurve.G1.dbl(jp))


def test_madd_matches_jax(operands):
    (p, jp), (q, jq), ps, qs = operands
    # q in affine form (z = 1 rows; the infinity lanes are skip-masked)
    qa = ([1 if pt is None else pt[0].n for pt in qs], [1 if pt is None else pt[1].n for pt in qs])
    skip = np.array([pt is None for pt in qs])
    port_q = tuple(torch.from_numpy(FP.encode(c)) for c in qa)
    jax_q = tuple(jnp.asarray(JFP.encode(c)) for c in qa)
    out = G1.madd(p, port_q, torch.from_numpy(skip))
    _same(out, jcurve.G1.madd(jp, jax_q, jnp.asarray(skip)))
    assert g1_from_device(out) == [ec_add(a, b) for a, b in zip(ps, qs)]


def test_madd_skip_mask_matches_jax(operands):
    """Every case under the skip mask: skipped lanes keep p whatever q is
    (precedence skip > p infinite > same > opposite)."""
    (p, jp), (q, jq), ps, qs = operands
    qa = ([1 if pt is None else pt[0].n for pt in qs], [1 if pt is None else pt[1].n for pt in qs])
    port_q = tuple(torch.from_numpy(FP.encode(c)) for c in qa)
    jax_q = tuple(jnp.asarray(JFP.encode(c)) for c in qa)
    q_inf = np.array([pt is None for pt in qs])  # their (1, 1) stand-ins are never added
    for skip in (np.ones(N, dtype=bool), q_inf | (np.arange(N) % 2 == 0),
                 q_inf | (np.arange(N) == 3)):
        out = cuda_ops.madd(p, port_q, torch.from_numpy(skip))
        _same(out, jcurve.G1.madd(jp, jax_q, jnp.asarray(skip)))
        assert all(torch.equal(a, b) for a, b in zip(
            out, cuda_ops.madd_plain(p, port_q, torch.from_numpy(skip))))
        want = [a if s else ec_add(a, b) for a, b, s in zip(ps, qs, skip)]
        assert g1_from_device(out) == want


def test_madd_multi_matches_jax(operands):
    """The fused bucket-loop step (plain twin of K7) against the JAX
    package's step loop of `CurveOps.madd` (the reference its own tests hold
    the Pallas `madd_multi` to), limb for limb: three steps over the operand
    lanes with skip and neg masks; step 0 adds Q (lane 3 doubles, lane 4
    cancels), step 1 adds -Q, step 2 adds P."""
    (p, jp), _, ps, qs = operands

    def affine(pts):
        return ([1 if pt is None else pt[0].n for pt in pts],
                [1 if pt is None else pt[1].n for pt in pts])

    steps = [affine(qs), affine(qs), affine(ps)]
    inf = np.array([[pt is None for pt in pts] for pts in (qs, qs, ps)])
    skip = inf | np.array([np.zeros(N, bool), np.arange(N) % 3 == 0, np.arange(N) == 6])
    neg = np.array([np.zeros(N, bool), np.ones(N, bool), np.arange(N) % 2 == 1])
    port_q = tuple(torch.stack([torch.from_numpy(FP.encode(st[i])) for st in steps], dim=1)
                   for i in range(2))
    jax_q = tuple(jnp.stack([jnp.asarray(JFP.encode(st[i])) for st in steps], axis=1)
                  for i in range(2))
    for use_neg in (True, False):
        out = G1.madd_multi(p, port_q, torch.from_numpy(skip),
                            torch.from_numpy(neg) if use_neg else None)
        jacc = jp
        for st in range(3):
            jy = jax_q[1][:, st]
            if use_neg:
                jy = jnp.where(jnp.asarray(neg[st])[None], jcurve.FPA.neg(jy), jy)
            jacc = jcurve.G1.madd(jacc, (jax_q[0][:, st], jy), jnp.asarray(skip[st]))
        _same(out, jacc)
        want = list(ps)
        for pts, sk, ng in zip((qs, qs, ps), skip, neg if use_neg else np.zeros_like(neg)):
            want = [a if s else ec_add(a, (b[0], -b[1]) if n_ else b)
                    for a, b, s, n_ in zip(want, pts, sk, ng)]
        assert g1_from_device(out) == want


@pytest.mark.slow
def test_madd_multi_matches_pallas_interpret():
    """The twin against the Pallas `madd_multi` kernel itself in interpret
    mode (one 1024-lane block, two steps, skip and neg masks)."""
    from kzg_tpu.curve.pallas_ops import _PointKernels

    rs = np.random.default_rng(15)
    lanes, steps = 1024, 2
    base = _points(rs, 6)
    pts = [base[i % 6] for i in range(lanes)]
    pts[0] = None
    (p, jp) = _both(_jacobian_ints(pts, _rand(rs, P, lanes)))
    qpts = [[base[(i + 1 + st) % 6] for i in range(lanes)] for st in range(steps)]
    qpts[0][3] = pts[3]  # a doubling
    qa = [([pt[0].n for pt in row], [pt[1].n for pt in row]) for row in qpts]
    port_q = tuple(torch.stack([torch.from_numpy(FP.encode(r[i])) for r in qa], dim=1)
                   for i in range(2))
    jax_q = tuple(jnp.stack([jnp.asarray(JFP.encode(r[i])) for r in qa], axis=1)
                  for i in range(2))
    skip = rs.random((steps, lanes)) < 0.3
    neg = rs.random((steps, lanes)) < 0.3
    skip[0, 3] = neg[0, 3] = False
    got = cuda_ops.madd_multi(p, port_q, torch.from_numpy(skip), torch.from_numpy(neg))
    kern = _PointKernels(JFP, ncomp=1, interpret=True)
    want = kern.madd_multi(jp, jax_q[0], jax_q[1], jnp.asarray(skip).astype(jnp.uint32),
                           jnp.asarray(neg).astype(jnp.uint32))
    _same(got, want)


def _digit_rows(scalars, c, w_count):
    """MSB-first base-2^c digit rows of host ints."""
    return [[(k >> (c * w)) & ((1 << c) - 1) for k in scalars]
            for w in range(w_count - 1, -1, -1)]


@pytest.mark.parametrize("c", [3, 4, 5])
def test_scalar_mul_digits_matches_native(c):
    """6 windows of c bits over 5 lanes: a point at infinity, a zero scalar,
    a scalar whose digits are all 2^c - 1."""
    rs = np.random.default_rng(30 + c)
    w_count = 6
    pts = _points(rs, 5)
    pts[1] = None
    scal = [int(rs.integers(1, 1 << (c * w_count))) for _ in range(5)]
    scal[2] = 0
    scal[3] = (1 << (c * w_count)) - 1
    (p, _) = _both(_jacobian_ints(pts, _rand(rs, P, 5)))
    digits = torch.tensor(_digit_rows(scal, c, w_count), dtype=torch.int32)
    got = g1_from_device(G1.scalar_mul_digits(p, digits, c))
    assert got == [None if pt is None or k == 0 else native.g1_mul(pt, k)
                   for pt, k in zip(pts, scal)]


@pytest.mark.slow
def test_scalar_mul_digits_matches_jax():
    rs = np.random.default_rng(40)
    c, w_count = 4, 3
    pts = _points(rs, 4)
    pts[0] = None
    scal = [int(rs.integers(0, 1 << (c * w_count))) for _ in range(4)]
    (p, jp) = _both(_jacobian_ints(pts, _rand(rs, P, 4)))
    rows = _digit_rows(scal, c, w_count)
    got = G1.scalar_mul_digits(p, torch.tensor(rows), c)
    want = jcurve.G1.scalar_mul_digits(jp, jnp.asarray(rows, dtype=jnp.int32), c)
    _same(got, want)


def test_horner_join_matches_jax_window_join():
    rs = np.random.default_rng(12)
    pts = _points(rs, 5)
    pts[2] = None
    coords = _jacobian_ints(pts, _rand(rs, P, 5))
    (s, js) = _both(coords)
    c = 3
    got = cuda_ops.horner_join(s, c)
    want = jcurve.G1.window_join(js, c)
    assert g1_from_device(tuple(t[..., None] for t in got)) == jcurve.g1_from_device(
        tuple(t[..., None] for t in want)
    )
    # and against host math: sum_w 2^(c w) S_w
    acc = None
    for w, pt in enumerate(pts):
        if pt is not None:
            acc = ec_add(acc, native.g1_mul(pt, 1 << (c * w)))
    assert g1_from_device(tuple(t[..., None] for t in got))[0] == acc


@pytest.mark.parametrize("fuse", [1, 4, 16])
def test_bucket_loop_equals_bucket_accumulate(fuse):
    """The bucket loop over `madd_multi` gives K3's bucket sums limb for
    limb (both fold a bucket's run in ascending order), whatever the number
    of fused steps; an infinite point and a zero scalar are in the batch."""
    rs = np.random.default_rng(14)
    n, c = 40, 3
    pts = _points(rs, n)
    xs = torch.from_numpy(FP.encode([pt[0].n for pt in pts]))
    ys = torch.from_numpy(FP.encode([pt[1].n for pt in pts]))
    inf = torch.zeros(n, dtype=torch.bool)
    inf[7] = True
    scal = [int.from_bytes(rs.bytes(32), "little") % R for _ in range(n)]
    scal[3] = 0
    inputs = pippenger.bucket_inputs(xs, ys, inf, torch.from_numpy(FR.from_ints(scal)), c)
    old = config.get_config()
    config.configure(msm_fuse_steps=fuse)
    try:
        got = pippenger._bucket_loop(G1, *inputs)
    finally:
        config.set_config(old)
    assert all(torch.equal(a, b) for a, b in zip(got, cuda_ops.bucket_accumulate(*inputs)))


def test_bucket_accumulate_plain_sums_each_run():
    rs = np.random.default_rng(13)
    n, c = 40, 3
    pts = _points(rs, n)
    xs = torch.from_numpy(FP.encode([pt[0].n for pt in pts]))
    ys = torch.from_numpy(FP.encode([pt[1].n for pt in pts]))
    inf = torch.zeros(n, dtype=torch.bool)
    inf[7] = True
    scal = [int.from_bytes(rs.bytes(32), "little") % R for _ in range(n)]
    scal[3] = 0
    std = torch.from_numpy(FR.from_ints(scal))
    rows, order, start, count = pippenger.bucket_inputs(xs, ys, inf, std, c)
    acc = cuda_ops.bucket_accumulate(rows, order, start, count)
    digits = pippenger._digits(std, c)
    got = g1_from_device(tuple(t.reshape(FP.W, -1) for t in acc))
    windows, buckets = start.shape
    for w in range(windows):
        for b in range(buckets):
            want = None
            if b:
                for i in range(n):
                    if int(digits[w, i]) == b and not bool(inf[i]):
                        want = ec_add(want, pts[i])
            assert got[w * buckets + b] == want, (w, b)
