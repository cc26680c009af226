"""The scan kernel `field_scan` (behind `LimbField.prefix_mul`,
`prefix_add`, `powers`, `sum_last` and `batch_inv`) on the CPU, against the
JAX package and against its own schedule.

  * `simulate_scan` (tests/scan_model.py: the kernel's tiles, runs, warp
    shuffles, warps' carries and the wrapper's tile passes, on residues,
    with the tile constants and flags read from `csrc/scan.cuh`) equals a
    plain fold at ragged sizes, rows 1 and 3, forward and reverse, in the
    array, column, total and pair modes, and takes the launches the wrapper
    counts;
  * the port's prefix_mul / prefix_add (both directions), powers, sum_last
    and the pair scan on CPU tensors (the plain version) equal
    `kzg_tpu.fields`' word for word over Fr and Fp;
  * the scan-based `batch_inv` equals `kzg_tpu`'s product-tree batch_inv,
    zeros interleaved, over Fr, Fp and Fp2, with rows > 1.

Tolerance 0: all of it is exact integer arithmetic. Inputs from numpy
seeds. The kernel itself runs on the card in `tests/test_torch_cuda.py`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kzg_tpu import fields as jf
from kzg_tpu.curve import FP2A as JFP2
from kzg_tpu_torch import config
from kzg_tpu_torch.constants import P, R
from kzg_tpu_torch.curve import FP2
from kzg_tpu_torch.fields import FP, FR, cuda_field
from kzg_tpu_torch.fields.limb import unpack16

import scan_model
from scan_model import simulate_scan

FIELDS = [(FR, jf.FR, R), (FP, jf.FP, P)]
IDS = ["Fr", "Fp"]
SIZES = [1, 2, 3, 31, 32, 33, 255, 1000, 4097]
JAX_SIZES = [1, 2, 3, 32, 33, 255, 1000, 4097]


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


def _ints(seed, mod, n):
    """n field elements from a numpy seed; the first three 0, 1, mod - 1."""
    rs = np.random.default_rng(seed)
    vals = [int.from_bytes(rs.bytes(48), "little") % mod for _ in range(n)]
    vals[:3] = [0, 1, mod - 1][:n]
    return vals


def _same(port_words, jax_limbs):
    got = unpack16(port_words).numpy().astype(np.uint32)
    want = np.asarray(jax_limbs)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _fold(op, mod, seq):
    acc = 1 if op == scan_model.MUL else 0
    out = []
    for v in seq:
        acc = acc * v % mod if op == scan_model.MUL else (acc + v) % mod
        out.append(acc)
    return out


def test_tile_constants_match_the_header():
    assert (scan_model.THREADS, scan_model.RUN) == (cuda_field.SCAN_THREADS,
                                                    cuda_field.SCAN_RUN)
    assert scan_model.TILE == cuda_field.SCAN_TILE
    assert (scan_model.REVERSE, scan_model.PAIR, scan_model.EXCLUSIVE) == (
        cuda_field.SCAN_REVERSE, cuda_field.SCAN_PAIR, cuda_field.SCAN_EXCLUSIVE)


@pytest.mark.parametrize("rows", [1, 3])
@pytest.mark.parametrize("n", SIZES)
def test_simulated_schedule_equals_a_plain_fold(n, rows):
    for mod in (R, P):
        vals = [_ints(100 * rows + n + i, mod, n) for i in range(rows)]
        passes = 1 if n <= scan_model.TILE else 3
        for op in (scan_model.ADD, scan_model.MUL):
            for reverse in (False, True):
                got, launches = simulate_scan(vals, op, mod, reverse)
                assert launches == passes
                for row, v in zip(got, vals):
                    want = _fold(op, mod, v[::-1] if reverse else v)
                    assert row == (want[::-1] if reverse else want)
            got, launches = simulate_scan(vals, op, mod, mode="total")
            assert got == [_fold(op, mod, v)[-1] for v in vals]
            assert launches == (1 if n <= scan_model.TILE else 2)
            cols = [v[-1] for v in vals]
            got, _ = simulate_scan(cols, op, mod, mode="column", n=n)
            assert got == [_fold(op, mod, [c] * n) for c in cols]
            got, launches = simulate_scan(vals, op, mod, mode="pair")
            assert launches == passes
            ident = 1 if op == scan_model.MUL else 0
            assert got[:rows] == [[ident] + _fold(op, mod, v)[:-1] for v in vals]
            assert got[rows:] == [_fold(op, mod, v[::-1])[-2::-1] + [ident] for v in vals]


def test_simulated_schedule_three_levels():
    """More than one tile of tile totals: the totals' own scan takes three
    passes, five in all."""
    n = scan_model.TILE * (scan_model.TILE + 1)
    got, launches = simulate_scan([7], scan_model.ADD, R, mode="column", n=n)
    assert launches == 5
    assert got[0][:3] == [7, 14, 21] and got[0][-1] == 7 * n % R


@pytest.mark.parametrize("n", JAX_SIZES)
@pytest.mark.parametrize("field,jfield,mod", FIELDS, ids=IDS)
def test_scans_match_jax(field, jfield, mod, n):
    xs = _ints(7 + n, mod, 3 * n)
    a = torch.from_numpy(field.encode(xs)).reshape(field.W, 3, n)
    ja = jnp.asarray(jfield.encode(xs)).reshape(2 * field.W, 3, n)
    for reverse in (False, True):
        _same(field.prefix_mul(a, reverse), jfield.prefix_mul(ja, reverse))
        _same(field.prefix_add(a, reverse), jfield.prefix_add(ja, reverse))
    pre, suf = cuda_field.field_scan(field, cuda_field.MUL, a, mode="pair")
    _same(pre[..., 1:], jfield.prefix_mul(ja)[..., :-1])
    _same(suf[..., :-1], jfield.prefix_mul(ja, True)[..., 1:])
    assert field.decode(pre[..., 0]) == field.decode(suf[..., -1]) == [1] * 3
    _same(field.sum_last(a), jfield.sum_last(ja))
    got = field.powers(a[..., 0], n)
    _same(got, jfield.prefix_mul(jnp.broadcast_to(ja[..., :1], ja.shape)))
    assert field.decode(got[:, 1]) == [pow(xs[n], i, mod) for i in range(1, n + 1)]


@pytest.mark.parametrize("shape", [(1,), (33,), (3, 255), (2, 1000)],
                         ids=["1", "33", "3x255", "2x1000"])
@pytest.mark.parametrize("field,jfield,mod", FIELDS, ids=IDS)
def test_batch_inv_matches_jax(field, jfield, mod, shape):
    n = int(np.prod(shape))
    xs = _ints(20 + n, mod, n)
    xs[n // 2] = 0
    a = torch.from_numpy(field.encode(xs)).reshape((field.W,) + shape)
    ja = jnp.asarray(jfield.encode(xs)).reshape((2 * field.W,) + shape)
    got = field.batch_inv(a)
    _same(got, jfield.batch_inv(ja))
    assert field.decode(got) == [pow(x, -1, mod) if x else 0 for x in xs]


@pytest.mark.parametrize("shape", [(5,), (3, 33)], ids=["5", "3x33"])
def test_fp2_batch_inv_matches_jax(shape):
    n = int(np.prod(shape))
    c0, c1 = _ints(90 + n, P, n), _ints(91 + n, P, n)
    c0[1] = c1[1] = 0  # the zero of Fp2
    c1[2] = 0
    a = torch.stack([torch.from_numpy(FP.encode(c)) for c in (c0, c1)], dim=1)
    a = a.reshape((FP.W, 2) + shape)
    ja = jnp.stack([jnp.asarray(jf.FP.encode(c)) for c in (c0, c1)], axis=1)
    ja = ja.reshape((2 * FP.W, 2) + shape)
    got = FP2.batch_inv(a)
    _same(got, JFP2.batch_inv(ja))
