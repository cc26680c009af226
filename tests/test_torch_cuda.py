"""Kernels K1-K5 and the G2 point kernels on the card against their plain
PyTorch twins, exact; and no fallback when the kernel build fails.

Needs a CUDA device and nvcc; skips elsewhere. This file imports no JAX, so
it runs where JAX is absent:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda
"""

import dataclasses

import numpy as np
import pytest
import torch

from kzg_tpu_torch import config, kernels
from kzg_tpu_torch.constants import P, R
from kzg_tpu_torch.curve import G1, cuda_ops, g2_generator_device
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
    inf = torch.zeros(512, dtype=torch.bool, device=dev)
    g = tuple(t.to(dev) for t in g2_generator_device(512))
    with pytest.raises(NotImplementedError):
        msm_g2((g[0], g[1], inf), FR.zeros((512,), dev))
