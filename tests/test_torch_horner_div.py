"""The Horner kernel `fr_horner` (behind `_div_by_linear`, `_eval_many`,
`Polynomial.div_by_linear` and `eval`) on the CPU, against the JAX package
and against its own schedule.

  * `simulate_horner` (tests/scan_model.py: the kernel's tiles, runs, warp
    shuffles of the carries, the warps' carries, the second scan from the
    true carry, and the wrapper's tile passes, on residues, with the tile
    constants read from `csrc/scan.cuh`) equals Python's Horner division at
    ragged sizes, at 3 points one of them 0, with and without a carry in,
    for the division and the remainder alone, and takes the launches the
    wrapper counts;
  * `fr_horner` on CPU tensors (its plain twin) equals Python's division,
    carry in included;
  * `_div_by_linear` (k = 1 and 3) and `_eval_many` (k = 1, 3, 17, 63)
    equal `kzg_tpu/poly/polynomial.py`'s word for word.

Tolerance 0: all of it is exact integer arithmetic. Inputs from numpy
seeds. The kernel itself runs on the card in `tests/test_torch_cuda.py`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kzg_tpu.fields import FR as JFR
from kzg_tpu.poly import polynomial as jpoly
from kzg_tpu_torch import config
from kzg_tpu_torch.constants import R
from kzg_tpu_torch.fields import FR
from kzg_tpu_torch.fields.limb import unpack16
from kzg_tpu_torch.poly import Polynomial, horner
from kzg_tpu_torch.poly.polynomial import _div_by_linear, _eval_many

import scan_model
from scan_model import simulate_horner

SIZES = [1, 2, 3, 31, 32, 33, 255, 1000, 4097]


@pytest.fixture(scope="module", autouse=True)
def _cpu_device():
    """The port places tensors on the card by default; these tests run its
    plain versions, so they ask for the CPU. The plain scans run many tiny
    ops: one intra-op thread keeps workers side by side from stalling."""
    old, threads = config.get_config(), torch.get_num_threads()
    config.configure(device="cpu")
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    config.set_config(old)


def _ints(seed, n):
    rs = np.random.default_rng(seed)
    vals = [int.from_bytes(rs.bytes(32), "little") % R for _ in range(n)]
    vals[:3] = [0, 1, R - 1][:n]
    return vals


def _same(port_words, jax_limbs):
    got = unpack16(port_words).numpy().astype(np.uint32)
    want = np.asarray(jax_limbs)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _divide(f, x, carry=0):
    """Python's Horner division: (q_0 .. q_{n-2}, rem)."""
    h, hs = carry, []
    for c in reversed(f):
        h = (c + x * h) % R
        hs.append(h)
    hs.reverse()
    return hs[1:], hs[0]


def _launches(n, carry, rem_only):
    tiles = -(-(n + carry) // scan_model.TILE)
    return 1 if tiles == 1 else (2 if rem_only else 3)


@pytest.mark.parametrize("n", SIZES + [1023, 1024])
def test_simulated_schedule_equals_python_division(n):
    f = _ints(300 + n, n)
    xs = [_ints(301, 2)[1], 0, 5]
    cin = _ints(302, 3)
    for carry in (None, cin):
        q, rem, launches = simulate_horner(f, xs, R, carry)
        assert launches == _launches(n, carry is not None, False)
        for i, x in enumerate(xs):
            assert (q[i], rem[i]) == _divide(f, x, carry[i] if carry else 0)
        got_q, got_rem, launches = simulate_horner(f, xs, R, carry, rem_only=True)
        assert got_q is None and got_rem == rem
        assert launches == _launches(n, carry is not None, True)


@pytest.mark.parametrize("n", [1, 2, 33, 1000])
def test_fr_horner_plain_equals_python_division(n):
    f = _ints(400 + n, n)
    xs = [_ints(401, 2)[1], 0, 3]
    cin = _ints(402, 3)
    ft = torch.from_numpy(FR.encode(f))
    xt = torch.from_numpy(FR.encode(xs))
    for carry in (None, cin):
        ct = None if carry is None else torch.from_numpy(FR.encode(carry))
        q, rem = horner.fr_horner(ft, xt, ct)
        _, rem2 = horner.fr_horner(ft, xt, ct, rem_only=True)
        assert torch.equal(rem, rem2)
        for i, x in enumerate(xs):
            wq, wr = _divide(f, x, carry[i] if carry else 0)
            assert FR.decode(q[:, i]) == wq if n > 1 else q.shape == (FR.W, 3, 0)
            assert FR.decode(rem[:, i:i + 1]) == [wr]


@pytest.mark.parametrize("n,k", [(1, 1), (2, 3), (33, 3), (255, 3), (1000, 1), (4097, 1)])
def test_div_by_linear_matches_jax(n, k):
    f = _ints(500 + n, n)
    xs = _ints(501 + k, k + 1)[1:]
    if k > 1:
        xs[1] = 0
    q, rem = _div_by_linear(torch.from_numpy(FR.encode(f)), torch.from_numpy(FR.encode(xs)))
    jq, jrem = jpoly._div_by_linear(jnp.asarray(JFR.encode(f)), jnp.asarray(JFR.encode(xs)))
    _same(q, jq)
    _same(rem, jrem)


@pytest.mark.parametrize("n,k", [(1, 1), (33, 3), (1000, 1), (4097, 3),
                                 (255, 17), (33, 63)])
def test_eval_many_matches_jax(n, k):
    f = _ints(600 + n, n)
    xs = _ints(601 + k, k + 1)[1:]
    xs[0] = 0
    got = _eval_many(torch.from_numpy(FR.encode(f)), torch.from_numpy(FR.encode(xs)))
    _same(got, jpoly._eval_many(jnp.asarray(JFR.encode(f)), jnp.asarray(JFR.encode(xs))))
    assert FR.decode(got) == [_divide(f, x)[1] for x in xs]


def test_polynomial_entry_points():
    f = _ints(700, 77)
    poly = Polynomial.from_ints(f, device="cpu")
    x = _ints(701, 4)[3]
    q, rem = poly.div_by_linear(x)
    wq, wr = _divide(f, x)
    assert rem == wr and q.to_ints() == wq and poly.eval(x) == wr
