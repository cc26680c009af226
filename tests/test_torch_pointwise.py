"""Kernel K2 (`cuda_ops.add` / `dbl`, G1 and G2) on the CPU: its narrow
mode's program and control flow, its twin, the JAX package and the oracle;
and the rule that picks the mode.

  * The narrow kernel's add (`csrc/pointwise.cuh`, run on Python integers
    by `horner_schedule.simulate_add`: two points a block, the addition's
    stages on both when either adds, the doubling on the half whose point
    has P == Q) against the plain twin (`CurveOps.add`) word for word in
    Jacobian form, and the twin against the oracle, for every pair of
    cases in a block, both ways round (`bench.pointwise.edge_pairs`):
    generic, p infinite, q infinite, both infinite, P == Q, P == -Q.
  * The narrow dbl (`simulate_dbl`) against the twin and the oracle on the
    same points, infinity included.
  * The twin's add and dbl against the JAX package's `CurveOps.add` / `dbl`
    on the same numpy-seeded inputs, word for word.
  * `pointwise_mode` as a pure function of the width, the SM count, the
    narrow kernel's blocks an SM and the waves; the registry's K2 records
    and their counts by mode.

Tolerance 0: all of it is exact integer arithmetic. The kernels themselves
run on the card in `tests/test_torch_cuda.py`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kzg_tpu import curve as jcurve
from kzg_tpu_torch import config, kernels
from kzg_tpu_torch.bench import pointwise as pw
from kzg_tpu_torch.curve import cuda_ops, g1_from_device, g2_from_device, horner_schedule
from kzg_tpu_torch.fields.limb import unpack16
from kzg_tpu_torch.oracle import ec_add

MASK32 = (1 << 32) - 1
GROUPS = {"g1": (cuda_ops.add, cuda_ops.dbl, g1_from_device, jcurve.G1, 1),
          "g2": (cuda_ops.g2_add, cuda_ops.g2_dbl, g2_from_device, jcurve.G2, 2)}


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


@pytest.fixture(scope="module")
def edges():
    """Per group: the edge pairs, the twin's sums and doubles, and the
    points as per-point tuples of per-coordinate integer tuples."""
    out = {}
    for group, (add, dbl, _, _, ncomp) in GROUPS.items():
        p, q, want, pairs = pw.edge_pairs(group, "cpu")
        out[group] = {"p": p, "q": q, "want": want, "pairs": pairs, "sum": add(p, q),
                      "double": dbl(p), "ps": _points(p, ncomp), "qs": _points(q, ncomp)}
    return out


def _ints(t):
    """(12, ...) int32 words -> the integers of the flattened batch."""
    w = t.reshape(12, -1).to(torch.int64) & MASK32
    return [sum(int(w[l, i]) << (32 * l) for l in range(12)) for i in range(w.shape[1])]


def _points(coords, ncomp):
    """A Jacobian batch -> per point (X, Y, Z), each a tuple of ncomp
    integers (c0 then c1 for G2)."""
    cols = [[(v,) for v in _ints(t)] if ncomp == 1 else list(zip(_ints(t[:, 0]), _ints(t[:, 1])))
            for t in coords]
    return list(zip(*cols))


@pytest.mark.parametrize("case", pw.CASES)
@pytest.mark.parametrize("group", list(GROUPS))
def test_narrow_add_program_matches_twin_and_oracle(edges, group, case):
    """Every block that pairs `case` with another case, both ways round:
    the program's two points equal the twin's words, the twin the oracle."""
    _, _, from_device, _, ncomp = GROUPS[group]
    e = edges[group]
    prog = horner_schedule.expand(ncomp)
    got = _points(e["sum"], ncomp)
    blocks = [k for k, pair in enumerate(e["pairs"]) if case in pair]
    assert len(blocks) == 2 * len(pw.CASES) - 1
    for k in blocks:
        lanes = slice(2 * k, 2 * k + 2)
        sim = horner_schedule.simulate_add(prog, e["ps"][lanes], e["qs"][lanes])
        assert sim == got[lanes], f"block {k}: {e['pairs'][k]}"
    want = from_device(e["sum"])
    assert all(want[i] == e["want"][i] for k in blocks for i in (2 * k, 2 * k + 1))


@pytest.mark.parametrize("group", list(GROUPS))
def test_narrow_add_alone_in_its_block(edges, group):
    """A block's last point alone (an odd width): the program on one point
    gives the twin's words for every case."""
    _, _, _, _, ncomp = GROUPS[group]
    e = edges[group]
    prog = horner_schedule.expand(ncomp)
    got = _points(e["sum"], ncomp)
    for i in range(0, len(got), 2 * len(pw.CASES) + 1):
        assert horner_schedule.simulate_add(prog, e["ps"][i:i + 1], e["qs"][i:i + 1]) == [got[i]]


@pytest.mark.parametrize("group", list(GROUPS))
def test_narrow_dbl_program_matches_twin_and_oracle(edges, group):
    _, _, from_device, _, ncomp = GROUPS[group]
    e = edges[group]
    prog = horner_schedule.expand(ncomp)
    assert horner_schedule.simulate_dbl(prog, e["ps"]) == _points(e["double"], ncomp)
    pts = from_device(e["p"])
    assert from_device(e["double"]) == [ec_add(a, a) for a in pts]


def _jax(t):
    return jnp.asarray(unpack16(t).numpy().astype(np.uint32))


def _same(port_pt, jax_pt):
    for a, b in zip(port_pt, jax_pt):
        np.testing.assert_array_equal(unpack16(a).numpy().astype(np.uint32), np.asarray(b))


@pytest.mark.parametrize("group", list(GROUPS))
def test_add_dbl_match_jax(edges, group):
    """The port's add and dbl (the twins the kernels equal) against the JAX
    package's on the edge pairs, word for word (each compiles ~10-75 s on a
    CPU)."""
    jgroup = GROUPS[group][3]
    e = edges[group]
    jp, jq = tuple(_jax(t) for t in e["p"]), tuple(_jax(t) for t in e["q"])
    _same(e["sum"], jgroup.add(jp, jq))
    _same(e["double"], jgroup.dbl(jp))


@pytest.mark.parametrize("n,sms,blocks,waves,mode", [
    (1, 132, 16, 4, "narrow"),
    (4 * 132 * 16 * 2, 132, 16, 4, "narrow"),       # exactly four waves of G1 blocks
    (4 * 132 * 16 * 2 + 1, 132, 16, 4, "wide"),
    (1 << 20, 132, 16, 4, "wide"),
    (2 * 132 * 8 * 2, 132, 8, 2, "narrow"),         # G2: 8 blocks an SM
    (2 * 132 * 8 * 2 + 1, 132, 8, 2, "wide"),
    (2 * 114 * 16 * 2 + 1, 114, 16, 2, "wide"),     # fewer SMs, fewer points a wave
    (2 * 132 * 16 * 2 - 1, 132, 16, 2, "narrow"),
    (5, 132, 16, 0, "wide"),                        # no waves: the wide mode throughout
])
def test_pointwise_mode_rule(n, sms, blocks, waves, mode):
    assert cuda_ops.pointwise_mode(n, sms, blocks, waves) == mode


def test_narrow_blocks_an_sm():
    """The narrow kernel's blocks an SM are ladder.cuh's min_blocks: 32
    registers a thread over 4 warps (G1) or 8 (G2)."""
    assert cuda_ops.narrow_min_blocks(1) == 65536 // (32 * 32 * 4) == 16
    assert cuda_ops.narrow_min_blocks(2) == 65536 // (32 * 32 * 8) == 8
    assert horner_schedule.WARPS == {1: 4, 2: 8}


@pytest.mark.parametrize("op", ["add", "dbl"])
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_k2_mode_reads_the_sm_count(monkeypatch, group, op):
    """`width_mode` takes the device's SM count and the kernel's waves: narrow
    up to NARROW_WAVES waves, wide one point above."""
    monkeypatch.setattr(cuda_ops, "_sm_count", lambda index: 132)
    g = cuda_ops._G1K if group == "g1" else cuda_ops._G2K
    waves = cuda_ops.NARROW_WAVES[f"{group}_{op}"]
    assert waves >= 1
    top = waves * 132 * cuda_ops.narrow_min_blocks(g.ncomp) * 2
    dev = torch.device("cuda", 0)
    assert cuda_ops.width_mode(g, op, 1, dev) == "narrow"
    assert cuda_ops.width_mode(g, op, top, dev) == "narrow"
    assert cuda_ops.width_mode(g, op, top + 1, dev) == "wide"
    assert cuda_ops.width_mode(g, op, 1 << 20, dev) == "wide"


def test_unknown_mode_raises():
    p = cuda_ops.PLAIN.infinity((3,), "cpu")
    with pytest.raises(kernels.KernelError):
        cuda_ops._k2(cuda_ops._G1K, "add", (*p, *p), "medium")


def test_k2_records_count_by_mode():
    """One registry record per TPU kernel, each K2 record naming its two
    modes' sources (files of the build) and counting their launches apart."""
    for name in ("g1_add", "g1_dbl", "g2_add", "g2_dbl"):
        k = kernels.REGISTRY[name]
        assert set(k.modes) == {"narrow", "wide"}
        for src in k.modes.values():
            assert src.split("/")[-1] in kernels.SOURCES
    assert "pointwise_g2_kernels.cu" in kernels.SOURCES and "pointwise.cuh" in kernels.HEADERS
    k = kernels.REGISTRY["g2_add"]
    before = kernels.launch_counts()
    try:
        k.count("narrow")
        k.count("narrow")
        k.count("wide")
        assert kernels.mode_counts()["g2_add"]["narrow"] >= 2
        assert kernels.launch_counts()["g2_add"] == before["g2_add"] + 3
    finally:
        kernels.reset_launches()
    assert kernels.mode_counts()["g2_add"] == {"narrow": 0, "wide": 0}
    assert kernels.launch_counts()["g2_add"] == 0
