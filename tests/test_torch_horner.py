"""Kernel K4, the window join, on the CPU, against the JAX package.

  * `cuda_ops.horner_join` on CPU tensors (the plain twin) and K4's program
    (`curve.horner_schedule`, the tables the kernel runs, executed with
    Python integers through the kernel's control flow) against
    `kzg_tpu.curve` G1 `window_join` (G2: test_torch_horner_g2.py), word
    for word, at the join's
    edge cases (`bench.horner.CASES`): empty top windows, every S_w at
    infinity, S_w equal to the running accumulator (the add's P == Q
    branch) and to its negation (P == -Q), W = 1, c = 1, and c = 16 at
    W = 2;
  * the cooperative field arithmetic of `csrc/coop.cuh` (16 lanes a
    product, carries resolved by warp votes), emulated lane by lane
    (`tests/coop_model.py`), against Python integers on edge and random
    operands;
  * the committed header `csrc/horner_schedule.cuh` is the generator's
    output, and the program's stages are what the kernel's design counts.

Tolerance 0: all of it is exact integer arithmetic. Inputs from numpy
seeds. The kernel itself runs on the card in `tests/test_torch_cuda.py`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kzg_tpu import curve as jcurve
from kzg_tpu_torch import config
from kzg_tpu_torch.bench import horner as hbench
from kzg_tpu_torch.constants import P, R
from kzg_tpu_torch.curve import cuda_ops, horner_schedule
from kzg_tpu_torch.fields.limb import unpack16

from coop_model import LANES, Coop, value, words

MASK32 = (1 << 32) - 1


@pytest.fixture(scope="module", autouse=True)
def _cpu_device():
    """The port places tensors on the card by default; these tests run its
    plain twins, so they ask for the CPU. The twins' ops are tiny, so one
    intra-op thread is as fast as many, and test processes side by side do
    not stall each other's thread pools."""
    old, threads = config.get_config(), torch.get_num_threads()
    config.configure(device="cpu")
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    config.set_config(old)


def _ints(t):
    """(12, n) int32 Montgomery words -> n integers."""
    w = t.reshape(12, -1).to(torch.int64) & MASK32
    return [sum(int(w[l, i]) << (32 * l) for l in range(12)) for i in range(w.shape[1])]


def _program_sums(s_all, ncomp):
    """Window sums as `simulate_join` takes them: per window (x, y, z), each
    a tuple of ncomp integers."""
    windows = s_all[0].shape[-1]
    cols = [_ints(t) for t in s_all]  # G2: component-major, c0 then c1
    return [tuple(tuple(col[k * windows + w] for k in range(ncomp)) for col in cols)
            for w in range(windows)]


def _jax(t):
    return jnp.asarray(unpack16(t).numpy().astype(np.uint32))


def check_edge_case(group, case):
    """The twin and K4's program against the JAX package's window_join at
    one edge case, word for word (G2's cases are in
    test_torch_horner_g2.py, a file of their own: each JAX G2 join traces
    and compiles for about a minute on a CPU)."""
    s_all, c = hbench.edge_case_sums(group, case, "cpu")
    ncomp = 1 if group == "g1" else 2
    got = cuda_ops.horner_join(s_all, c)
    jgroup = jcurve.G1 if group == "g1" else jcurve.G2
    want = jgroup.window_join(tuple(_jax(t) for t in s_all), c)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(unpack16(a).numpy().astype(np.uint32), np.asarray(b))
    prog = horner_schedule.expand(ncomp)
    sim = horner_schedule.simulate_join(prog, _program_sums(s_all, ncomp), c)
    assert [list(v) for v in sim] == [_ints(t) for t in got]


@pytest.mark.parametrize("case", list(hbench.CASES))
def test_horner_join_edge_cases_match_jax(case):
    check_edge_case("g1", case)


# ---- coop.cuh, lane by lane ------------------------------------------------------------

@pytest.mark.parametrize("op", ["mul", "add", "sub"])
@pytest.mark.parametrize("field", ["Fr", "Fp"])
def test_coop_arithmetic_emulated(field, op):
    mod, nwords = (R, 8) if field == "Fr" else (P, 12)
    coop = Coop(mod, nwords)
    rs = np.random.default_rng(7 + nwords)
    edge = [0, 1, 2, mod - 1, mod - 2, (1 << 32) - 1, (1 << (32 * (nwords - 1))) - 1,
            mod >> 1, (mod + 1) >> 1]
    vals = edge + [int.from_bytes(rs.bytes(48), "little") % mod for _ in range(24)]
    r_inv = pow(1 << (32 * nwords), -1, mod)
    for x in vals:
        for y in vals[:12] + vals[-6:]:
            got = getattr(coop, op)(words(x), words(y))
            want = {"mul": x * y * r_inv, "add": x + y, "sub": x - y}[op] % mod
            assert value(got) == want and got[nwords:] == [0] * (LANES - nwords), (x, y)


# ---- the program and its header -------------------------------------------------------

def test_schedule_header_is_current():
    assert horner_schedule.HEADER.read_text() == horner_schedule.render()


@pytest.mark.parametrize("ncomp,dbl,add,products", [(1, 3, 6, 24), (2, 3, 8, 60)],
                         ids=["g1", "g2"])
def test_schedule_critical_path(ncomp, dbl, add, products):
    """The doubling runs three dependent products over Fp and over Fp2 (its
    Karatsuba products side by side); the addition six over Fp, eight over
    Fp2 (twelve products of its second level on eight warps). All the
    products of a doubling and an addition: 7 + 17 over Fp (one thread ran
    7 + 16 in a row), 16 + 44 over Fp2 (two a square, three a product)."""
    prog = horner_schedule.expand(ncomp)
    assert horner_schedule.critical_products(prog, "dbl") == dbl
    assert horner_schedule.critical_products(prog, "add") == add
    assert max(len(s) for s in prog.stages[:prog.dbl_end]) <= prog.warps
    assert products == sum(op[0] == horner_schedule.MUL
                           for stage in prog.stages for chain in stage for op in chain)
