"""Port field layer (kzg_tpu_torch.fields, plain path on CPU) against the JAX
package's LimbField, word for word. Tolerance 0: all of it is integer math.

The JAX side runs on the CPU backend (tests/conftest.py); both sides get the
same inputs, drawn from a numpy seed, and their outputs are compared in the
JAX package's 16-bit-limb layout.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kzg_tpu import fields as jf
from kzg_tpu.fields import pallas_field as jpf
from kzg_tpu_torch import config, kernels
from kzg_tpu_torch.constants import P, R
from kzg_tpu_torch.fields import FP, FR, cuda_field
from kzg_tpu_torch.fields.limb import pack16, unpack16

FIELDS = [(FR, jf.FR, R), (FP, jf.FP, P)]
IDS = ["Fr", "Fp"]
N = 16

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


def _ints(seed, mod, n=N):
    """n field elements from a numpy seed, with the edges 0, 1, mod - 1."""
    rs = np.random.default_rng(seed)
    words = rs.integers(0, 1 << 32, size=(n, 12), dtype=np.uint64)
    vals = [int(sum(int(w) << (32 * i) for i, w in enumerate(row))) % mod for row in words]
    vals[:3] = [0, 1, mod - 1]
    return vals


def _both(field, jfield, xs):
    return torch.from_numpy(field.encode(xs)), jnp.asarray(jfield.encode(xs))


def _same(port_words, jax_limbs):
    got = unpack16(port_words).numpy().astype(np.uint32)
    want = np.asarray(jax_limbs)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("field,jfield,mod", FIELDS, ids=IDS)
def test_encode_matches_jax_layout(field, jfield, mod):
    xs = _ints(1, mod)
    a, ja = _both(field, jfield, xs)
    _same(a, ja)
    assert field.decode(a) == xs


@pytest.mark.parametrize("field,jfield,mod", FIELDS, ids=IDS)
def test_ring_ops_match_jax(field, jfield, mod):
    xs, ys = _ints(2, mod), _ints(3, mod)[::-1]
    a, ja = _both(field, jfield, xs)
    b, jb = _both(field, jfield, ys)
    _same(field.add(a, b), jfield.add(ja, jb))
    _same(field.sub(a, b), jfield.sub(ja, jb))
    _same(field.neg(a), jfield.neg(ja))
    _same(field.mul(a, b), jfield.mul(ja, jb))
    _same(field.sqr(a), jfield.sqr(ja))
    assert field.decode(field.mul(a, b)) == [x * y % mod for x, y in zip(xs, ys)]


@pytest.mark.parametrize("field,jfield,mod", FIELDS, ids=IDS)
def test_montgomery_conversions_match_jax(field, jfield, mod):
    xs = _ints(4, mod)
    a, ja = _both(field, jfield, xs)
    _same(field.to_mont(a), jfield.to_mont(ja))
    _same(field.from_mont(a), jfield.from_mont(ja))
    _same(field.mul_const(a, field.r2_words), jfield.mul_const(ja, jfield.r2_np))


@pytest.mark.parametrize("field,jfield,mod", FIELDS, ids=IDS)
def test_inverses_and_powers_match_jax(field, jfield, mod):
    xs = _ints(5, mod)
    xs[5] = 0  # zeros interleaved
    xs[9] = 0
    a, ja = _both(field, jfield, xs)
    _same(field.batch_inv(a), jfield.batch_inv(ja))
    _same(field.inv(a[:, :4]), jfield.inv(ja[:, :4]))
    e = 0xDEADBEEF12345
    _same(field.pow_static(a[:, :4], e), jfield.pow_static(ja[:, :4], e))
    assert field.decode(field.batch_inv(a)) == [pow(x, -1, mod) if x else 0 for x in xs]


@pytest.mark.parametrize("field,jfield,mod", FIELDS, ids=IDS)
@pytest.mark.parametrize("reverse", [False, True])
def test_prefix_scans_match_jax(field, jfield, mod, reverse):
    xs = _ints(6, mod, n=13)  # not a power of two
    a, ja = _both(field, jfield, xs)
    _same(field.prefix_mul(a, reverse), jfield.prefix_mul(ja, reverse))
    _same(field.prefix_add(a, reverse), jfield.prefix_add(ja, reverse))


@pytest.mark.parametrize("field,jfield,mod", FIELDS, ids=IDS)
def test_sum_last_matches_jax(field, jfield, mod):
    xs = _ints(7, mod, n=3 * 7)
    a, ja = _both(field, jfield, xs)
    a, ja = a.reshape(field.W, 3, 7), ja.reshape(jfield.L, 3, 7)
    _same(field.sum_last(a), jfield.sum_last(ja))


@pytest.mark.parametrize("field,jfield,mod", FIELDS, ids=IDS)
@pytest.mark.parametrize("k", [1, 2, 5])
def test_mul_chain_plain_matches_pallas_interpret_and_ints(field, jfield, mod, k):
    """The plain version of kernel K8 against the Pallas `make_mul_chain`
    in interpret mode (one 1024-lane block) and against Python ints:
    a * b^k * R^-k."""
    xs, ys = _ints(20 + k, mod, n=1024), _ints(30 + k, mod, n=1024)[::-1]
    a, ja = _both(field, jfield, xs)
    b, jb = _both(field, jfield, ys)
    got = cuda_field.mul_chain_plain(field, k, a, b)
    _same(got, jpf.make_mul_chain(jfield, k, interpret=True)(ja, jb))
    assert torch.equal(got, cuda_field.make_mul_chain(field, k)(a, b))  # the CPU wrapper
    assert field.decode(got[:, :8]) == [x * pow(y, k, mod) % mod for x, y in zip(xs[:8], ys[:8])]


def test_mul_chain_edges():
    a = torch.from_numpy(FR.encode(_ints(40, R)))
    b = torch.from_numpy(FR.encode(_ints(41, R)))
    assert torch.equal(cuda_field.mul_chain(FR, 0, a, b), a)
    assert torch.equal(cuda_field.mul_chain(FR, 1, a, b), FR.mul(a, b))
    assert torch.equal(cuda_field.mul_chain(FR, 3, a, b[:, :1]),  # broadcast operand
                       FR.mul(FR.mul(FR.mul(a, b[:, :1]), b[:, :1]), b[:, :1]))
    with pytest.raises(ValueError):
        cuda_field.mul_chain(FR, -1, a, b)
    with pytest.raises(kernels.KernelError):
        cuda_field.mul_chain(FR, 1, a.to("meta"), b.to("meta"))


def test_pack_unpack_round_trip_high_words():
    rs = np.random.default_rng(8)
    w = torch.from_numpy(rs.integers(-(1 << 31), 1 << 31, size=(12, 257), dtype=np.int64)
                         .astype(np.int32))
    w[:, 0] = -1  # 0xffffffff
    w[:, 1] = -(1 << 31)  # 0x80000000
    limbs = unpack16(w)
    assert limbs.dtype == torch.int64
    assert int(limbs.min()) >= 0 and int(limbs.max()) <= 0xFFFF
    assert limbs[:, 0].tolist() == [0xFFFF] * 24
    assert limbs[:2, 1].tolist() == [0, 0x8000]
    assert torch.equal(pack16(limbs), w)


def test_kernel_header_constants():
    """The Montgomery constants written into csrc/field.cuh are the ones the
    fields derive (the kernels cannot be compiled here to check them)."""
    src = (Path(kernels.CSRC) / "field.cuh").read_text()

    def words(name):
        body = re.search(rf"{name}\[\d+\] = \{{([^}}]*)\}}", src).group(1)
        macro = re.search(rf"#define {body.strip()}((?:.*\\\n)*.*)", src)
        if macro:  # an initializer list the header #defines once for two uses
            body = macro.group(1).replace("\\", " ")
        return [int(v.strip().rstrip("u"), 16) for v in body.split(",")]

    def nprime(tag):
        block = re.search(rf"struct {tag} \{{(.*?)\}};", src, re.S).group(1)
        return int(re.search(r"NPRIME = (0x[0-9a-f]+)u", block).group(1), 16)

    for f, tag, pre in ((FR, "Fr", "FR"), (FP, "Fp", "FP")):
        as_u32 = lambda a: [int(v) & 0xFFFFFFFF for v in a]  # noqa: E731
        assert words(f"{pre}_MOD") == as_u32(f.mod_words)
        assert words(f"{pre}_R2") == as_u32(f.r2_words)
        assert words(f"{pre}_ONE") == as_u32(f.one_mont_words)
        assert nprime(tag) == f.nprime32
        assert f.mod_words.shape == (f.W,)


def test_wrappers_refuse_other_devices():
    a = torch.zeros((FP.W, 4), dtype=torch.int32, device="meta")
    with pytest.raises(kernels.KernelError):
        FP.mul(a, a)
    with pytest.raises(kernels.KernelError):
        FP.to_mont(a)
