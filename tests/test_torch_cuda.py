"""Kernels K1-K7 (G1 and G2) on the card against their plain PyTorch twins,
exact; the default device; and no fallback when the kernel build fails.

Needs a CUDA device and nvcc; skips elsewhere. This file imports no JAX, so
it runs where JAX is absent:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda
"""

import dataclasses

import numpy as np
import pytest
import torch

from kzg_tpu_torch import config, kernels, native
from kzg_tpu_torch.constants import P, R
from kzg_tpu_torch.curve import G1, G2, cuda_ops, g2_from_device, g2_generator_device
from kzg_tpu_torch.fields import FP, FR, cuda_field
from kzg_tpu_torch.msm import msm_g2, pippenger
from kzg_tpu_torch.ntt import Domain

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _ints(seed, mod, n):
    rs = np.random.default_rng(seed)
    vals = [int.from_bytes(rs.bytes(48), "little") % mod for _ in range(n)]
    vals[:3] = [0, 1, mod - 1]
    return vals


def _equal(a, b):
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("field,mod", [(FR, R), (FP, P)], ids=["Fr", "Fp"])
@pytest.mark.parametrize("op", [cuda_field.ADD, cuda_field.SUB, cuda_field.MUL])
def test_k1_binary(dev, field, mod, op):
    a = torch.from_numpy(field.encode(_ints(1, mod, 1000))).to(dev)
    b = torch.from_numpy(field.encode(_ints(2, mod, 1000)[::-1])).to(dev)
    assert _equal(cuda_field.binary(field, op, a, b), cuda_field.binary_plain(field, op, a, b))


@pytest.mark.parametrize("field,mod", [(FR, R), (FP, P)], ids=["Fr", "Fp"])
def test_k1_mul_const(dev, field, mod):
    a = torch.from_numpy(field.encode(_ints(3, mod, 777))).to(dev)
    for c in (field.r2_words, field.one_std_words):
        assert _equal(cuda_field.mul_const(field, a, c), cuda_field.mul_const_plain(field, a, c))


def _points(dev, n, seed):
    """Jacobian points k_i * G (16-bit k_i) built on the card with the
    plain twins."""
    fplain = FP.as_plain()
    rs = np.random.default_rng(seed)
    from kzg_tpu_torch.curve import g1_generator_device

    g = tuple(t.to(dev) for t in g1_generator_device(n))
    bits = torch.from_numpy(rs.integers(0, 2, size=(16, n))).to(dev)
    pts = cuda_ops.PLAIN.scalar_mul_bits(g, bits)  # zero bits give infinity
    return tuple(t.contiguous() for t in pts), fplain


def test_k2_add_dbl(dev):
    p, fplain = _points(dev, 256, 4)
    q = tuple(t.roll(1, dims=-1) for t in p)
    q = tuple(t.clone() for t in q)
    for i in range(3):
        q[i][:, 5] = p[i][:, 5]  # P + P
    q[1][:, 6] = fplain.neg(p[1][:, 6])  # P + (-P)
    q[0][:, 6], q[2][:, 6] = p[0][:, 6], p[2][:, 6]
    q[2][:, 7] = 0  # Q at infinity
    assert _equal(cuda_ops.add(p, q), cuda_ops.add_plain(p, q))
    assert _equal(cuda_ops.dbl(p), cuda_ops.dbl_plain(p))


def test_k3_k4_msm_buckets(dev):
    n, c = 700, 6
    p, _ = _points(dev, n, 5)
    x, y, inf = G1.to_affine(p)
    scal = torch.from_numpy(FR.from_ints(_ints(6, R, n))).to(dev)
    inputs = pippenger.bucket_inputs(x, y, inf, scal, c)
    acc = cuda_ops.bucket_accumulate(*inputs)
    assert _equal(acc, cuda_ops.bucket_accumulate_plain(*inputs))
    s_all = pippenger.weighted_bucket_sum(G1, acc)
    assert _equal(cuda_ops.horner_join(s_all, c), cuda_ops.horner_join_plain(s_all, c))


def _fr_words(dev, seed, shape):
    rs = np.random.default_rng(seed)
    vals = [int.from_bytes(rs.bytes(32), "little") % R for _ in range(int(np.prod(shape)))]
    return torch.from_numpy(FR.encode(vals)).reshape((FR.W,) + shape).to(dev)


def test_k5_ntt_stage_layouts(dev):
    for nb, m, bt in ((1, 2, 1), (3, 32, 1), (2, 16, 5)):
        x = _fr_words(dev, 7 + m, (nb, m, bt))
        tw = _fr_words(dev, 8, (m // 2,))
        for s in range(m.bit_length() - 1):
            assert _equal(cuda_field.ntt_stage(x, tw, s),
                          cuda_field.ntt_stage_layout_plain(x, tw, s))


def test_k5_domains(dev, monkeypatch):
    """Pease transforms of the tiny domains 2^1-2^5 (batched) and a
    four-step domain, against the domain's plain twin."""
    for exp in range(1, 6):
        dom = Domain(exp)
        x = _fr_words(dev, 20 + exp, (3, dom.d))
        for name in ("ntt", "intt", "coset_ntt", "coset_intt"):
            assert _equal(getattr(dom, name)(x), getattr(dom.as_plain(), name)(x))
    monkeypatch.setattr(
        config, "_config", dataclasses.replace(config.get_config(), ntt_four_step_min_exp=4)
    )
    dom = Domain(9)
    x = _fr_words(dev, 30, (dom.d,))
    for name in ("ntt", "intt"):
        assert _equal(getattr(dom, name)(x), getattr(dom.as_plain(), name)(x))


def _g2_points(dev, n, seed):
    """Jacobian G2 points k_i * G (12-bit k_i) built with the plain twins."""
    rs = np.random.default_rng(seed)
    g = tuple(t.to(dev) for t in g2_generator_device(n))
    bits = torch.from_numpy(rs.integers(0, 2, size=(12, n))).to(dev)
    return tuple(t.contiguous() for t in cuda_ops.PLAIN2.scalar_mul_bits(g, bits))


def test_g2_add_dbl(dev):
    p = _g2_points(dev, 64, 9)
    q = tuple(t.roll(1, dims=-1).clone() for t in p)
    for i in range(3):
        q[i][:, :, 5] = p[i][:, :, 5]  # P + P
    q[0][:, :, 6], q[2][:, :, 6] = p[0][:, :, 6], p[2][:, :, 6]
    q[1][:, :, 6] = cuda_ops.PLAIN2.f.neg(p[1][:, :, 6])  # P + (-P)
    q[2][:, :, 7] = 0  # Q at infinity
    assert _equal(cuda_ops.g2_add(p, q), cuda_ops.g2_add_plain(p, q))
    assert _equal(cuda_ops.g2_dbl(p), cuda_ops.g2_dbl_plain(p))


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_k6_madd_and_digit_ladder(dev, group):
    """madd against its twin with skip, infinite, same and opposite lanes;
    the digit ladder through the kernels against the ladder on the twins."""
    if group == "g1":
        p, _ = _points(dev, 200, 11)
        q, _ = _points(dev, 200, 12)
        curve, plain, kfn, pfn = G1, cuda_ops.PLAIN, cuda_ops.madd, cuda_ops.madd_plain
    else:
        p, q = _g2_points(dev, 200, 11), _g2_points(dev, 200, 12)
        curve, plain, kfn, pfn = G2, cuda_ops.PLAIN2, cuda_ops.g2_madd, cuda_ops.g2_madd_plain
    qx, qy, q_inf = plain.to_affine(q)
    px, py, _ = plain.to_affine(p)
    qx[..., 5], qy[..., 5] = px[..., 5], py[..., 5]  # P + P
    qx[..., 6], qy[..., 6] = px[..., 6], plain.f.neg(py[..., 6])  # P + (-P)
    skip = q_inf | (torch.arange(200, device=dev) % 7 == 3)
    got = kfn(p, (qx, qy), skip)
    assert _equal(got, pfn(p, (qx, qy), skip))
    assert bool(curve.is_inf(got)[6]) or bool(curve.is_inf(p)[6])
    rs = np.random.default_rng(13)
    digits = torch.from_numpy(rs.integers(0, 8, size=(4, 200))).to(dev)
    a = curve.scalar_mul_digits(p, digits, 3)
    b = plain.scalar_mul_digits(p, digits, 3)
    assert bool(curve.eq(a, b).all())


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_k7_madd_multi_and_bucket_loop(dev, group):
    """madd_multi against its twin: 5 steps over 200 lanes with skip and neg
    masks, an infinite accumulator lane, a same-point and an opposite-point
    step; then the bucket loop on it against K3 on the same inputs."""
    if group == "g1":
        p, _ = _points(dev, 200, 21)
        qs = [_points(dev, 200, 22 + s)[0] for s in range(5)]
        curve, plain = G1, cuda_ops.PLAIN
        kfn, pfn = cuda_ops.madd_multi, cuda_ops.madd_multi_plain
    else:
        p = _g2_points(dev, 200, 21)
        qs = [_g2_points(dev, 200, 22 + s) for s in range(5)]
        curve, plain = G2, cuda_ops.PLAIN2
        kfn, pfn = cuda_ops.g2_madd_multi, cuda_ops.g2_madd_multi_plain
    bd = plain.f.bdim
    aff = [plain.to_affine(q) for q in qs]
    px, py, _ = plain.to_affine(p)
    aff[0][0][..., 5], aff[0][1][..., 5] = px[..., 5], py[..., 5]  # step 0: P + P
    aff[0][0][..., 6], aff[0][1][..., 6] = px[..., 6], py[..., 6]  # negated below: P + (-P)
    qx = torch.stack([a[0] for a in aff], dim=bd)
    qy = torch.stack([a[1] for a in aff], dim=bd)
    rs = np.random.default_rng(27)
    skip = torch.stack([a[2] for a in aff]) | torch.from_numpy(rs.random((5, 200)) < 0.3).to(dev)
    neg = torch.from_numpy(rs.random((5, 200)) < 0.3).to(dev)
    skip[0, 5:7] = False
    neg[0, 5], neg[0, 6] = False, True
    p[2][..., 8] = 0  # an accumulator at infinity
    for masks in ((skip, neg), (skip, None)):
        assert _equal(kfn(p, (qx, qy), *masks), pfn(p, (qx, qy), *masks))
    n, c = 700, 6
    x, y, inf = plain.to_affine(_points(dev, n, 28)[0] if group == "g1" else _g2_points(dev, n, 28))
    scal = torch.from_numpy(FR.from_ints(_ints(29, R, n))).to(dev)
    inputs = pippenger.bucket_inputs(x, y, inf, scal, c)
    assert _equal(pippenger._bucket_loop(curve, *inputs), cuda_ops.bucket_accumulate(*inputs))


def test_g2_pippenger_kernels_and_msm(dev):
    """K3 / K4 over Fp2 against their twins, and msm_g2 on both bucket
    routes (the bucket loop on K7 below 1024 buckets a window, K3 from
    there) against the native engine (also the [-1, 0, ..., 0, 1] vector)."""
    n, c = 600, 5
    x, y, inf = cuda_ops.PLAIN2.to_affine(_g2_points(dev, n, 14))
    ints = _ints(15, R, n)
    inputs = pippenger.bucket_inputs(x, y, inf, torch.from_numpy(FR.from_ints(ints)).to(dev), c)
    assert inputs[0].shape == (n, 48)
    acc = cuda_ops.bucket_accumulate(*inputs)
    assert _equal(acc, cuda_ops.bucket_accumulate_plain(*inputs))
    s_all = pippenger.weighted_bucket_sum(G2, acc)
    assert _equal(cuda_ops.horner_join(s_all, c), cuda_ops.horner_join_plain(s_all, c))
    host = g2_from_device((x, y, inf))
    for scal, window, kernel in ((ints, None, "g2_madd_multi"),
                                 ([R - 1] + [0] * (n - 2) + [1], None, "g2_madd_multi"),
                                 (ints, 10, "g2_bucket_accumulate")):
        before = kernels.launch_counts()
        got = msm_g2((x, y, inf), torch.from_numpy(FR.encode(scal)).to(dev), window)
        after = kernels.launch_counts()
        assert g2_from_device(tuple(t[..., None] for t in got))[0] == native.g2_msm(host, scal)
        assert after[kernel] > before[kernel]
        assert after["g2_horner_join"] == before["g2_horner_join"] + 1


def test_default_device_is_the_card(dev):
    from kzg_tpu_torch.kzg import setup
    from kzg_tpu_torch.poly import Polynomial

    assert config.get_config().device == "cuda"
    params = setup(5, 4)
    assert all(t.is_cuda for t in params.gs + params.hs)
    assert Polynomial.from_ints([1, 2, 3]).coeffs.is_cuda and FR.one((2,)).is_cuda


def test_no_fallback_when_the_build_fails(dev, monkeypatch):
    def failed_build():
        raise kernels.KernelError("build failed")

    monkeypatch.setattr(kernels, "_lib", None)
    monkeypatch.setattr(kernels, "build", failed_build)
    x = _fr_words(dev, 40, (1, 8, 1))
    p = tuple(t.to(dev) for t in g2_generator_device(4))
    with pytest.raises(kernels.KernelError):
        cuda_field.ntt_stage(x, x[:, 0, :4, 0], 0)
    with pytest.raises(kernels.KernelError):
        cuda_ops.g2_add(p, p)
    with pytest.raises(kernels.KernelError):
        cuda_ops.g2_dbl(p)
    skip = torch.zeros(4, dtype=torch.bool, device=dev)
    with pytest.raises(kernels.KernelError):
        cuda_ops.g2_madd(p, p[:2], skip)
    g1p = tuple(t[:, 0].contiguous() for t in p)  # (12, 4) words stand in for G1 points
    with pytest.raises(kernels.KernelError):
        cuda_ops.madd(g1p, g1p[:2], skip)
    q3 = tuple(t[:, :, None].expand(-1, -1, 3, -1).contiguous() for t in p[:2])
    with pytest.raises(kernels.KernelError):
        cuda_ops.g2_madd_multi(p, q3, torch.zeros(3, 4, dtype=torch.bool, device=dev))
    # G2 Pippenger (512 points take the bucket route) raises too: no ladder
    # and no twin stands in for the missing kernels
    inf = torch.zeros(512, dtype=torch.bool, device=dev)
    g = tuple(t.to(dev) for t in g2_generator_device(512))
    with pytest.raises(kernels.KernelError):
        msm_g2((g[0], g[1], inf), FR.one((512,), dev))
