"""K1's Fermat chain (`cuda_field.field_pow`, behind `LimbField.pow_static`
and `inv`) on the CPU, against the JAX package and lane by lane.

  * `LimbField.inv` / `pow_static` (the plain version on CPU tensors)
    equal `kzg_tpu.fields.limb`'s for Fr and Fp, word for word, at seeded
    inputs with the edges 0, 1 and m - 1, over batch shapes (1,), (16,)
    and (2, 3);
  * the kernel's step, its two products on the two half-warps of
    `csrc/coop.cuh` (acc * base on lanes 0-15, base^2 on lanes 16-31,
    every vote over the whole warp), emulated lane by lane
    (`tests/coop_model.py`) over the whole exponent, equals the plain
    version, for e = m - 2 and a random e.

Tolerance 0: all of it is exact integer arithmetic. Inputs from numpy
seeds. The kernel itself runs on the card in `tests/test_torch_cuda.py`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kzg_tpu import fields as jf
from kzg_tpu_torch import config
from kzg_tpu_torch.constants import P, R
from kzg_tpu_torch.fields import FP, FR, cuda_field
from kzg_tpu_torch.fields.limb import unpack16

from coop_model import LANES, Coop, value, words

FIELDS = [(FR, jf.FR, R), (FP, jf.FP, P)]
IDS = ["Fr", "Fp"]
SHAPES = [(1,), (16,), (2, 3)]


@pytest.fixture(scope="module", autouse=True)
def _cpu_device():
    """The port places tensors on the card by default; these tests run its
    plain versions, so they ask for the CPU."""
    old, threads = config.get_config(), torch.get_num_threads()
    config.configure(device="cpu")
    torch.set_num_threads(1)  # the twins' ops are tiny; test files run side by side
    yield
    torch.set_num_threads(threads)
    config.set_config(old)


def _ints(seed, mod, n):
    """n field elements from a numpy seed; the first three 0, 1, mod - 1."""
    rs = np.random.default_rng(seed)
    vals = [int.from_bytes(rs.bytes(48), "little") % mod for _ in range(n)]
    vals[:3] = [0, 1, mod - 1][:n]
    return vals


def _exponent(seed, mod):
    rs = np.random.default_rng(seed)
    return int.from_bytes(rs.bytes(48), "little") % mod


def _same(port_words, jax_limbs):
    got = unpack16(port_words).numpy().astype(np.uint32)
    want = np.asarray(jax_limbs)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", SHAPES, ids=["1", "16", "2x3"])
@pytest.mark.parametrize("field,jfield,mod", FIELDS, ids=IDS)
def test_inv_and_pow_static_match_jax(field, jfield, mod, shape):
    n = int(np.prod(shape))
    xs = _ints(30 + n, mod, n)
    a = torch.from_numpy(field.encode(xs)).reshape((field.W,) + shape)
    ja = jnp.asarray(jfield.encode(xs)).reshape((2 * field.W,) + shape)
    got = field.inv(a)
    _same(got, jfield.inv(ja))
    assert field.decode(got) == [pow(x, -1, mod) if x else 0 for x in xs]
    e = _exponent(40 + n, mod)
    got = field.pow_static(a, e)
    _same(got, jfield.pow_static(ja, e))
    assert field.decode(got) == [pow(x, e, mod) for x in xs]


@pytest.mark.parametrize("field,mod", [(FR, R), (FP, P)], ids=IDS)
def test_pow_small_exponents_and_the_k1_chain(field, mod):
    """e = 0 gives one (also at 0), e = 1 the input; the K1 chain route
    (`field_pow_chain`, the plain twin on CPU tensors) gives the same words."""
    xs = _ints(5, mod, 8)
    a = torch.from_numpy(field.encode(xs))
    for e in (0, 1, 2, 3, 1 << 64, mod - 1):
        got = field.pow_static(a, e)
        assert field.decode(got) == [pow(x, e, mod) for x in xs], e
        assert torch.equal(cuda_field.field_pow_chain(field, a, e), got)
        assert torch.equal(cuda_field.field_pow(field, a, e), got)
    with pytest.raises(ValueError):
        cuda_field.field_pow(field, a, -1)
    with pytest.raises(ValueError):
        cuda_field.field_pow(field, a, 1 << (32 * field.W))


def _pow_emulated(field, mod, x_mont, e):
    """pow_coop_kernel's loop over one element, lane by lane: each step one
    paired product, acc * base (half 0) and base^2 (half 1); bit s of e
    picks acc's new value."""
    coop = Coop(mod, field.W, halves=2)
    acc = words(field.mont_r % mod)
    base = words(x_mont)
    for s in range(e.bit_length()):
        r = coop.mul(acc + base, base + base)
        assert r[field.W:LANES] == [0] * (LANES - field.W) and r[LANES + field.W:] == [0] * (
            LANES - field.W)
        if (e >> s) & 1:
            acc = r[:LANES]
        base = r[LANES:]
    return value(acc)


@pytest.mark.parametrize("field,mod", [(FR, R), (FP, P)], ids=IDS)
def test_pow_step_emulated_equals_plain(field, mod):
    xs = _ints(9, mod, 5)
    a = torch.from_numpy(field.encode(xs))
    mont = [x * field.mont_r % mod for x in xs]
    for e in (mod - 2, _exponent(11, mod), 5):
        want = field.to_ints(cuda_field.field_pow_plain(field, a, e))  # Montgomery words
        assert [_pow_emulated(field, mod, m, e) for m in mont] == want, e
