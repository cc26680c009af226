"""The digit ladder kernel (`cuda_ops.ladder`, the rounds of
`CurveOps.scalar_mul_digits` in one launch) on the CPU, against the JAX
package and the host's oracle.

  * The ladder kernel's program (`curve.horner_schedule`: the doubling and
    the new mixed addition, run with Python integers through the kernel's
    control flow by `simulate_ladder`) against the plain twin (the rounds
    of `CurveOps.scalar_mul_digits` on the plain point formulas), word for
    word in Jacobian form, over G1 and G2, a few lanes, c = 1, 4 and 8;
    and both against the oracle in affine form. Lanes: a generic one, p at
    infinity, all-zero digits, a zero digit between others.
  * The edge cases of `bench.ladder.EDGE_DIGITS`, crafted tables whose
    entries meet the accumulator as P == Q and P == -Q, or meet it at
    infinity: program, twin and oracle.
  * The ladder's table (`ladder_table`, K2 adds and one `to_affine`)
    against the oracle's multiples.
  * `scalar_mul_digits` (table and rounds) against the JAX package's, in
    affine form, and the program on the port's table, at c = 1, 4 and 8
    (over G2, c = 4 and 8 are `slow`: each JAX G2 ladder compiles ~2 min);
    G1 at c = 8 and G2 in test_torch_ladder_jax.py.

Tolerance 0: all of it is exact integer arithmetic. Inputs from numpy
seeds. The kernel itself runs on the card in `tests/test_torch_cuda.py`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kzg_tpu import curve as jcurve
from kzg_tpu_torch import config
from kzg_tpu_torch.bench import ladder as lbench
from kzg_tpu_torch.curve import (
    G1, G2, cuda_ops, g1_from_device, g2_from_device, horner_schedule,
)
from kzg_tpu_torch.fields.limb import unpack16

MASK32 = (1 << 32) - 1
CURVES = {"g1": (G1, g1_from_device, 1), "g2": (G2, g2_from_device, 2)}


@pytest.fixture(scope="module", autouse=True)
def _cpu_device():
    """The port places tensors on the card by default; these tests run its
    plain twins, so they ask for the CPU. The twins' ops are tiny, so one
    intra-op thread is as fast as many."""
    old, threads = config.get_config(), torch.get_num_threads()
    config.configure(device="cpu")
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    config.set_config(old)


def _ints(t):
    """(12, ...) int32 words -> the integers of the flattened batch."""
    w = t.reshape(12, -1).to(torch.int64) & MASK32
    return [sum(int(w[l, i]) << (32 * l) for l in range(12)) for i in range(w.shape[1])]


def _comps(t, ncomp):
    """A (12[, 2], *batch) coordinate -> per batch position a tuple of ncomp
    integers (component-major for G2, c0 then c1)."""
    if ncomp == 1:
        return [(v,) for v in _ints(t)]
    c0, c1 = _ints(t[:, 0]), _ints(t[:, 1])
    return list(zip(c0, c1))


def _simulate(ncomp, tx, ty, p_inf, digits, c):
    """simulate_ladder on every lane of a table (12[, 2], T, lanes)."""
    prog = horner_schedule.expand(ncomp)
    lanes = p_inf.numel()
    xs, ys = _comps(tx, ncomp), _comps(ty, ncomp)  # entry-major, then lane
    out = []
    for lane in range(lanes):
        entries = [(xs[t * lanes + lane], ys[t * lanes + lane]) for t in range((1 << c) - 1)]
        out.append(horner_schedule.simulate_ladder(
            prog, entries, [int(d) for d in digits[:, lane]], bool(p_inf[lane]), c))
    return out


def _assert_program_equals(ncomp, sim, got):
    """Each lane's simulated (X, Y, Z) equals the twin's words."""
    cols = [_comps(t, ncomp) for t in got]
    assert [tuple(col[lane] for col in cols) for lane in range(len(sim))] == sim


WINDOWS = {1: 12, 4: 6, 8: 3}


@pytest.mark.parametrize("c", sorted(WINDOWS))
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_ladder_program_matches_twin_and_oracle(group, c):
    curve, from_device, ncomp = CURVES[group]
    rs = np.random.default_rng([7, c, ncomp])
    pts = lbench.random_points(group, 4, rs)
    pts[1] = None  # p at infinity
    tx, ty = lbench.host_table(group, pts, c, "cpu")
    p_inf = torch.tensor([p is None for p in pts])
    digits = torch.from_numpy(rs.integers(1, 1 << c, size=(WINDOWS[c], 4))).to(torch.int32)
    digits[:, 2] = 0  # every round skipped
    digits[WINDOWS[c] // 2, 3] = 0
    got = cuda_ops.ladder(tx, ty, p_inf, digits, c)
    assert torch.equal(got[0], curve.ladder_rounds(tx, ty, p_inf, digits, c)[0])
    _assert_program_equals(ncomp, _simulate(ncomp, tx, ty, p_inf, digits, c), got)
    ks = lbench.ladder_value(digits, c)
    assert from_device(got) == [None if p is None else lbench._mul(p, k) for p, k in zip(pts, ks)]


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_ladder_edge_cases(group):
    """P == Q (doubled), P == -Q (infinity), all-zero digits, p infinite, an
    entry met by the accumulator at infinity, a generic lane: the program
    equals the twin word for word, and the twin the oracle."""
    _, from_device, ncomp = CURVES[group]
    tx, ty, p_inf, digits, c, want = lbench.edge_case(group, "cpu")
    got = cuda_ops.ladder(tx, ty, p_inf, digits, c)
    _assert_program_equals(ncomp, _simulate(ncomp, tx, ty, p_inf, digits, c), got)
    assert from_device(got) == want
    lanes = list(lbench.EDGE_DIGITS)
    assert want[lanes.index("same")] is not None and want[lanes.index("opposite")] is None


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_ladder_table_matches_host(group):
    curve, _, _ = CURVES[group]
    rs = np.random.default_rng([8, int(group == "g2")])
    pts = lbench.random_points(group, 3, rs)
    pts[1] = None
    tx, ty, p_inf = curve.ladder_table(lbench.jacobian_points(group, pts, rs, "cpu"), 3)
    hx, hy = lbench.host_table(group, pts, 3, "cpu")
    assert p_inf.tolist() == [False, True, False]
    for got, want in ((tx, hx), (ty, hy)):
        assert torch.equal(got[..., 0], want[..., 0]) and torch.equal(got[..., 2], want[..., 2])


def _jax(t):
    return jnp.asarray(unpack16(t).numpy().astype(np.uint32))


# each (group, c) compiles the JAX ladder anew: ~50 s over G1, ~130 s over G2
# on a CPU, so two of the G2 windows run with the compile-heavy tier; G1 at
# c = 8 and the G2 windows sit in test_torch_ladder_jax.py, so that a
# parallel run gives the two halves two workers
@pytest.mark.parametrize("group,c", [("g1", 1), ("g1", 4)])
def test_scalar_mul_digits_matches_jax(group, c):
    check_scalar_mul_digits(group, c)


def check_scalar_mul_digits(group, c):
    """The port's ladder (table on K2's twin, rounds on the ladder's twin)
    against the JAX package's `scalar_mul_digits` in affine form; the
    program on the port's table gives the port's words."""
    curve, _, ncomp = CURVES[group]
    jgroup = jcurve.G1 if group == "g1" else jcurve.G2
    rs = np.random.default_rng([9, c, ncomp])
    pts = lbench.random_points(group, 3, rs)
    pts[1] = None
    p = lbench.jacobian_points(group, pts, rs, "cpu")
    digits = torch.from_numpy(rs.integers(0, 1 << c, size=(4, 3))).to(torch.int32)
    digits[:, 2] = 0
    got = curve.scalar_mul_digits(p, digits, c)
    want = jgroup.to_affine(jgroup.scalar_mul_digits(
        tuple(_jax(t) for t in p), jnp.asarray(digits.numpy()), c))
    ax, ay, ainf = curve.to_affine(got)
    np.testing.assert_array_equal(np.asarray(ainf), np.asarray(want[2]))
    for a, b in ((ax, want[0]), (ay, want[1])):
        np.testing.assert_array_equal(unpack16(a).numpy().astype(np.uint32), np.asarray(b))
    tx, ty, p_inf = curve.ladder_table(p, c)
    _assert_program_equals(ncomp, _simulate(ncomp, tx, ty, p_inf, digits, c), got)
