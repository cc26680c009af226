"""Port G1 point formulas (plain twins of kernels K2-K4, on CPU) against the
JAX package's XLA `CurveOps`, limb for limb, and the bucket accumulation
twin against per-bucket sums from the native engine. Tolerance 0.

Batches include points at infinity, P + P (the same point under another
Z) and P + (-P). Inputs come from a numpy seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kzg_tpu import curve as jcurve
from kzg_tpu.fields import FP as JFP
from kzg_tpu_torch import native
from kzg_tpu_torch.constants import P, R
from kzg_tpu_torch.curve import G1, cuda_ops, g1_from_device
from kzg_tpu_torch.fields import FP, FR
from kzg_tpu_torch.fields.limb import unpack16
from kzg_tpu_torch.msm import pippenger
from kzg_tpu_torch.oracle import ec_add, g1_generator

N = 8


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
