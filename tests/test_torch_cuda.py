"""Kernels K1-K4 on the card against their plain PyTorch twins, exact.

Needs a CUDA device and nvcc; skips elsewhere. This file imports no JAX, so
it runs where JAX is absent:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from kzg_tpu_torch.constants import P, R
from kzg_tpu_torch.curve import G1, cuda_ops
from kzg_tpu_torch.fields import FP, FR, cuda_field
from kzg_tpu_torch.msm import pippenger

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
