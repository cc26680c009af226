"""The port's matmul-DFT NTT (kzg_tpu_torch.ntt.mxu, the plain versions of
the product and of kernel K9 on the CPU) against the JAX package's
`ntt/mxu.py` and against the port's own butterfly path. Inputs come from a
numpy seed; every comparison is exact (tolerance 0: integer math).

  * `mxu_reduce_plain` against the Pallas reduce kernel in interpret mode,
    on random and on extreme digit sums, and against Python ints;
  * the block-banded table `_w_big_np` against the JAX one;
  * `dft_axis2` against the JAX `dft_axis2` and the port's butterfly
    `_ntt_axis2`, both directions;
  * `Domain` transforms under `ntt_mxu="force"` against `"off"`, at an
    exponent that takes the balanced split and, with the block edge
    lowered, one that takes the pinned split and recurses;
  * the plane split, the exact product and `mxu_available`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kzg_tpu.fields import FR as JFR
from kzg_tpu.ntt import mxu as jmxu
from kzg_tpu_torch import config, kernels
from kzg_tpu_torch.constants import R
from kzg_tpu_torch.fields import FR
from kzg_tpu_torch.fields.limb import unpack16, words_to_ints
from kzg_tpu_torch.ntt import Domain, mxu


@pytest.fixture(scope="module", autouse=True)
def _cpu_device():
    """The port places tensors on the card by default; these tests run the
    plain versions, so they ask for the CPU."""
    old, threads = config.get_config(), torch.get_num_threads()
    config.configure(device="cpu")
    torch.set_num_threads(1)  # the twins' ops are tiny; test files run side by side
    yield
    torch.set_num_threads(threads)
    config.set_config(old)


@pytest.fixture
def mxu_mode():
    """Set config.ntt_mxu inside a test; restored afterwards."""
    old = config.get_config()
    yield lambda mode: config.configure(ntt_mxu=mode)
    config.set_config(old)


def _ints(seed, n):
    rs = np.random.default_rng(seed)
    return [int.from_bytes(rs.bytes(32), "little") % R for _ in range(n)]


def _both(ints, shape):
    port = torch.from_numpy(FR.encode(ints)).reshape((FR.W,) + shape)
    jax = jnp.asarray(JFR.encode(ints)).reshape((JFR.L,) + shape)
    return port, jax


def _same(port, jax):
    np.testing.assert_array_equal(unpack16(port).numpy().astype(np.uint32), np.asarray(jax))


def _digit_sums(kind, b=1024):
    """(64, b) int32 digit sums as a product can give them: row d is at
    most 255^2 * 128 times the number of plane pairs (a, b) with a + b = d
    (none for the padding row 63). "extreme" sets every row to that
    maximum (a value just below 2^519), "random" draws below it."""
    pairs = [min(mxu.PLANES - 1, d) - max(0, d - mxu.PLANES + 1) + 1
             for d in range(mxu.OUT_DIGITS - 1)] + [0]
    top = np.repeat(np.array(pairs)[:, None] * (255 * 255 * 128), b, axis=1)
    if kind == "random":
        top = np.random.default_rng(11).integers(0, top + 1)
    return top.astype(np.int32)


def test_constants_match_jax():
    assert (mxu.PLANES, mxu.OUT_DIGITS, mxu.FOLD_DIGIT, mxu._MAX_EXP) == (
        jmxu.PLANES, jmxu.OUT_DIGITS, jmxu.FOLD_DIGIT, jmxu._MAX_EXP)
    assert mxu._K_FOLD == jmxu._K_FOLD


@pytest.mark.parametrize("kind", ["random", "extreme"])
def test_reduce_plain_matches_pallas_interpret(kind):
    y = _digit_sums(kind)
    want = jmxu._make_reduce_kernel(True)(jnp.asarray(y))
    got = mxu.mxu_reduce_plain(torch.from_numpy(y))
    assert got.dtype == torch.int32 and tuple(got.shape) == (FR.W, y.shape[1])
    _same(got, want)


@pytest.mark.parametrize("kind", ["random", "extreme"])
def test_reduce_plain_matches_python_ints(kind):
    y = _digit_sums(kind, b=16)
    rinv = pow(1 << 256, -1, R)
    want = [sum(int(v) << (8 * d) for d, v in enumerate(col)) * rinv % R for col in y.T]
    assert words_to_ints(mxu.mxu_reduce(torch.from_numpy(y))) == want


@pytest.mark.parametrize("exp", [3, 4])
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_w_big_matches_jax(exp, inverse):
    got = mxu._w_big_np(exp, inverse)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, jmxu._w_big_np(exp, inverse))


def test_planes_and_exact_product():
    """to_planes lays out row p C + j = byte p of block row j, and the
    float64 product equals the integer product."""
    exp, bt = 3, 5
    C = 1 << exp
    ints = _ints(3, 2 * C * bt)
    x = torch.from_numpy(FR.encode(ints)).reshape(FR.W, 2, C, bt)
    planes = mxu.to_planes(x, exp)
    assert planes.dtype == torch.uint8 and tuple(planes.shape) == (mxu.PLANES * C, 2 * bt)
    want = mxu._to_planes_np(x.numpy())  # (32, 2, C, bt)
    np.testing.assert_array_equal(
        planes.numpy(), np.moveaxis(want, 2, 1).reshape(mxu.PLANES * C, 2 * bt))
    y = mxu.digit_sums(exp, False, planes)
    assert y.dtype == torch.int32
    w = mxu._w_big_np(exp, False).astype(np.int64)
    np.testing.assert_array_equal(y.numpy(), w @ planes.numpy().astype(np.int64))


@pytest.mark.parametrize("exp,bt", [(4, 8), (6, 4)])
def test_dft_axis2_matches_jax_and_butterflies(exp, bt, mxu_mode):
    m = 1 << exp
    x, jx = _both(_ints(exp, m * bt), (m, bt))
    mxu_mode("off")
    dom = Domain(exp)
    for inverse in (False, True):
        got = mxu.dft_axis2(exp, inverse, x)
        _same(got, jmxu.dft_axis2(exp, inverse, jx))
        assert torch.equal(got, dom._ntt_axis2(x, inverse))
        assert torch.equal(got, mxu.dft_axis2(exp, inverse, x, plain=True))


def test_dft_axis2_with_lead_axes_and_block_limit():
    x = torch.from_numpy(FR.encode(_ints(5, 3 * 8 * 2))).reshape(FR.W, 3, 8, 2)
    got = mxu.dft_axis2(3, False, x)
    for i in range(3):
        assert torch.equal(got[:, i], mxu.dft_axis2(3, False, x[:, i]))
    with pytest.raises(ValueError):
        mxu.dft_axis2(mxu._MAX_EXP + 1, False, torch.zeros((FR.W, 256, 1), dtype=torch.int32))


def _transforms(dom):
    return (dom.ntt, dom.intt, dom.coset_ntt, dom.coset_intt)


def test_domain_force_equals_off_balanced_split(mxu_mode):
    """2^9 under "force": the gate drops to 8, the split stays balanced
    (4, 5) and every block is a matmul leaf."""
    dom = Domain(9)
    x = torch.from_numpy(FR.encode(_ints(9, 2 * dom.d))).reshape(FR.W, 2, dom.d)
    mxu_mode("off")
    want = [f(x) for f in _transforms(dom)]
    mxu_mode("force")
    assert dom._fs_split("cpu") == (4, 5)
    for f, w in zip(_transforms(dom), want):
        assert torch.equal(f(x), w)
    assert torch.equal(dom.as_plain().ntt(x), want[0])
    mxu_mode("off")  # the tables are keyed by the split: no stale read
    assert torch.equal(dom.ntt(x), want[0])


def test_domain_force_equals_off_pinned_split(mxu_mode, monkeypatch):
    """With the block edge lowered to 2^2, 2^7 takes the pinned split
    (2, 5) and 2^5 recurses through _four_step_axis2 to 2^2 / 2^1 leaves."""
    monkeypatch.setattr(Domain, "_cache", {})
    dom = Domain(7)
    x = torch.from_numpy(FR.encode(_ints(7, dom.d))).reshape(FR.W, dom.d)
    mxu_mode("off")
    want = [f(x) for f in _transforms(dom)]
    assert dom._fs_split("cpu") == (3, 4)
    monkeypatch.setattr(mxu, "_MAX_EXP", 2)
    mxu_mode("force")
    assert dom._fs_split("cpu") == (2, 5)
    calls = []
    real = mxu.dft_axis2
    monkeypatch.setattr(mxu, "dft_axis2",
                        lambda exp, *a, **k: calls.append(exp) or real(exp, *a, **k))
    for f, w in zip(_transforms(dom), want):
        assert torch.equal(f(x), w)
    assert set(calls) == {1, 2} and len(calls) == 4 * 4


def test_mxu_available_modes(mxu_mode):
    mxu_mode("off")
    assert not mxu.mxu_available("cpu") and not mxu.mxu_available("cuda")
    mxu_mode("auto")
    assert not mxu.mxu_available("cpu") and mxu.mxu_available(torch.device("cuda", 0))
    mxu_mode("force")
    assert mxu.mxu_available("cpu") and mxu.mxu_available("cuda")


def test_wrappers_refuse_other_devices():
    with pytest.raises(kernels.KernelError):
        mxu.mxu_reduce(torch.zeros((mxu.OUT_DIGITS, 4), dtype=torch.int32, device="meta"))
    with pytest.raises(kernels.KernelError):
        mxu.digit_sums(1, False, torch.zeros((mxu.PLANES * 2, 4), dtype=torch.uint8,
                                             device="meta"))
