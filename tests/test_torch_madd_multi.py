"""Kernel K7 (`cuda_ops.madd_multi` / `g2_madd_multi`, the bucket loop's
fused madd step) on the CPU: its narrow mode's program and control flow,
its twin, the JAX package and the oracle; and the rule that picks the mode.

  * The narrow kernel (`csrc/madd_multi.cuh`, run on Python integers by
    `horner_schedule.simulate_madd_multi`: two lanes a block, the madd
    stages on both when either adds, the doubling on the half whose lane
    has P == Q, nothing where both skip) against the plain twin
    (`CurveOps.madd_multi`) word for word in Jacobian form, and the twin
    against the oracle, on random steps of curve points and at the edge
    cases: an infinite accumulator, P + P, P + (-P) under neg, a lane
    skipped at every step, a ragged pair (a block's second lane missing),
    S = 1 and S = 17; and on `bench.madd_multi.random_steps` (random field
    values, the planted lanes).
  * The twin against the JAX package's `madd_multi` (the step loop
    `PallasCurveOps.madd_multi` runs where no Pallas kernel applies) on the
    same numpy-seeded inputs, word for word (G1 compiles ~25 s on a CPU;
    G2 ~70 s, `slow`).
  * `width_mode` at K7's crossover in `cuda_ops.NARROW_WAVES` +- 1 lane for
    both groups, the registry's K7 records counted by mode, an unknown mode
    refused, and masks handed to the kernel at 4-byte aligned addresses.
  * K6 (`madd` / `g2_madd`), which runs K7's narrow kernel at S = 1: its
    twin against the JAX package's madd (G2 `slow`) and its registry
    record.

Tolerance 0: all of it is exact integer arithmetic. The kernels themselves
run on the card in `tests/test_torch_cuda.py`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kzg_tpu import curve as jcurve
from kzg_tpu.curve.pallas_ops import PallasCurveOps
from kzg_tpu_torch import config, kernels
from kzg_tpu_torch.bench import horner as hbench
from kzg_tpu_torch.bench import ladder as lbench
from kzg_tpu_torch.bench import madd_multi as mmbench
from kzg_tpu_torch.constants import P
from kzg_tpu_torch.curve import cuda_ops, g1_from_device, g2_from_device, horner_schedule
from kzg_tpu_torch.fields.limb import unpack16
from kzg_tpu_torch.oracle import ec_add, ec_neg

MASK32 = (1 << 32) - 1
GROUPS = {"g1": (cuda_ops.madd_multi, g1_from_device, 1),
          "g2": (cuda_ops.g2_madd_multi, g2_from_device, 2)}


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
    integers (c0 then c1 for G2)."""
    if ncomp == 1:
        return [(v,) for v in _ints(t)]
    return list(zip(_ints(t[:, 0]), _ints(t[:, 1])))


def _simulate(ncomp, acc, q, skip, neg):
    """simulate_madd_multi on every block of two lanes (the last alone where
    the lanes are odd); returns each lane's (X, Y, Z)."""
    prog = horner_schedule.expand(ncomp)
    steps, lanes = skip.shape
    a = list(zip(*(_comps(t, ncomp) for t in acc)))
    xs, ys = (_comps(t, ncomp) for t in q)  # step-major, then lane
    out = []
    for i0 in range(0, lanes, 2):
        hs = range(i0, min(i0 + 2, lanes))
        out += horner_schedule.simulate_madd_multi(
            prog, [a[h] for h in hs],
            [[(xs[s * lanes + h], ys[s * lanes + h]) for s in range(steps)] for h in hs],
            [[bool(skip[s, h]) for s in range(steps)] for h in hs],
            [[bool(neg[s, h]) for s in range(steps)] for h in hs])
    return out


def _assert_program_equals(ncomp, sim, got):
    cols = [_comps(t, ncomp) for t in got]
    assert [tuple(col[lane] for col in cols) for lane in range(len(sim))] == sim


def _affine(group, pts, device="cpu"):
    """Oracle points -> affine (x, y) batches (an infinite point's stand-in
    (1, 1) is never added: its steps are skipped)."""
    one = 1 if group == "g1" else (1, 0)
    cols = ([], [])
    for pt in pts:
        for k in range(2):
            if pt is None:
                cols[k].append(one)
            elif group == "g1":
                cols[k].append(pt[k].n)
            else:
                cols[k].append((pt[k].a.n, pt[k].b.n))
    return tuple(hbench._to_tensor(group, col, device) for col in cols)


def curve_steps(group, kind, steps, rs):
    """(acc, (qx, qy), skip, neg, start points, step points) on oracle
    points. kind "random": 5 lanes (the last alone in its block), random
    masks. kind "edges": lane 0 an infinite accumulator, 1 adds its own
    point at step 0 (P + P), 2 adds it under neg (P + (-P)) then takes the
    next step's point, 3 skipped at every step, 4 generic, 5 alone in its
    block, P + (-P) at its last step."""
    base = lbench.random_points(group, 4, rs)
    lanes = 5 if kind == "random" else 6
    start = [base[(i + 1) % 4] for i in range(lanes)]
    pts = [[lbench._mul(base[(i + s) % 4], s + 2) for i in range(lanes)] for s in range(steps)]
    skip = rs.random((steps, lanes)) < 0.3
    neg = rs.random((steps, lanes)) < 0.3
    if kind == "edges":
        start[0] = None
        skip[0, 0] = False
        for lane, negate in ((1, False), (2, True)):
            pts[0][lane] = start[lane]
            skip[:2, lane] = False
            neg[0, lane] = negate
        skip[:, 3] = True
        pts[-1][5] = start[5] if steps == 1 else None  # P + (-P) at the last step
        skip[:, 5] = False
        neg[:, 5] = False
        if steps > 1:  # the sum so far, negated
            acc = start[5]
            for s in range(steps - 1):
                acc = ec_add(acc, pts[s][5])
            pts[-1][5] = acc
        neg[-1, 5] = True
    for s in range(steps):
        for i in range(lanes):
            if pts[s][i] is None:
                skip[s, i] = True
    acc = lbench.jacobian_points(group, start, rs, "cpu")
    aff = [_affine(group, row) for row in pts]
    q = tuple(torch.stack([a[k] for a in aff], dim=-2) for k in range(2))
    return acc, q, torch.from_numpy(skip), torch.from_numpy(neg), start, pts


def _oracle(start, pts, skip, neg):
    out = []
    for i, a in enumerate(start):
        for s in range(len(pts)):
            if not skip[s, i]:
                a = ec_add(a, ec_neg(pts[s][i]) if neg[s, i] else pts[s][i])
        out.append(a)
    return out


@pytest.mark.parametrize("kind,steps", [("random", 5), ("edges", 1), ("edges", 3),
                                        ("edges", 17)])
@pytest.mark.parametrize("group", list(GROUPS))
def test_narrow_program_matches_twin_and_oracle(group, kind, steps):
    fn, from_device, ncomp = GROUPS[group]
    rs = np.random.default_rng([11, ncomp, steps, kind == "edges"])
    acc, q, skip, neg, start, pts = curve_steps(group, kind, steps, rs)
    got = fn(acc, q, skip, neg)
    _assert_program_equals(ncomp, _simulate(ncomp, acc, q, skip, neg), got)
    want = _oracle(start, pts, skip.numpy(), neg.numpy())
    assert from_device(got) == want
    if kind == "edges":
        assert want[0] is not None and want[3] == start[3] and want[5] is None
        if steps == 1:
            assert want[2] is None and want[1] == lbench._mul(start[1], 2)


@pytest.mark.parametrize("lanes", [1, 4, 7])
@pytest.mark.parametrize("group", list(GROUPS))
def test_narrow_program_on_planted_field_values(group, lanes):
    """`bench.madd_multi.random_steps` (random field values, the planted
    lanes), S = 3: the program equals the twin; lane 2 doubles at step 0,
    lane 3 is infinity after it."""
    fn, _, ncomp = GROUPS[group]
    gen = torch.Generator().manual_seed(lanes)
    acc, q, skip, neg = mmbench.random_steps(group, lanes, 3, gen)
    got = fn(acc, q, skip, neg)
    _assert_program_equals(ncomp, _simulate(ncomp, acc, q, skip, neg), got)
    one = cuda_ops._G1K if group == "g1" else cuda_ops._G2K
    after0 = one.plain.madd_multi(acc, tuple(t[..., :1, :] for t in q), skip[:1], neg[:1])
    inf = one.plain.is_inf(after0)
    assert not bool(inf[0]) and (lanes < 4 or bool(inf[3]))
    if lanes > 1:
        assert all(torch.equal(g[..., 1], a[..., 1]) for g, a in zip(got, acc))
    if lanes > 2:
        dbl = one.plain.dbl(tuple(t[..., 2:3] for t in acc))
        assert all(torch.equal(g[..., 2:3], d) for g, d in zip(after0, dbl))


def _jax(t):
    return jnp.asarray(unpack16(t).numpy().astype(np.uint32))


@pytest.mark.parametrize("group", ["g1", pytest.param("g2", marks=pytest.mark.slow)])
def test_twin_matches_jax(group):
    """The twin against the JAX package's `madd_multi` on the edge-case
    inputs (S = 3, neg mask), word for word."""
    fn, _, ncomp = GROUPS[group]
    rs = np.random.default_rng([12, ncomp])
    acc, q, skip, neg, _, _ = curve_steps(group, "edges", 3, rs)
    ops = PallasCurveOps(jcurve.FPA if group == "g1" else jcurve.FP2A, name=group)
    ops._kernels = None  # the step loop it runs where no Pallas kernel applies
    want = ops.madd_multi(tuple(_jax(t) for t in acc), tuple(_jax(t) for t in q),
                          jnp.asarray(skip.numpy()), jnp.asarray(neg.numpy()))
    for a, b in zip(fn(acc, q, skip, neg), want):
        np.testing.assert_array_equal(unpack16(a).numpy().astype(np.uint32), np.asarray(b))


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_k7_mode_at_the_crossover(monkeypatch, group):
    """`width_mode` for K7: narrow up to NARROW_WAVES waves of the narrow kernel
    (SMs x its blocks an SM x 2 lanes), wide one lane above."""
    monkeypatch.setattr(cuda_ops, "_sm_count", lambda index: 132)
    g = cuda_ops._G1K if group == "g1" else cuda_ops._G2K
    waves = cuda_ops.NARROW_WAVES[f"{group}_madd_multi"]
    assert waves >= 1
    top = waves * 132 * cuda_ops.narrow_min_blocks(g.ncomp) * 2
    dev = torch.device("cuda", 0)
    for n, mode in ((1, "narrow"), (top - 1, "narrow"), (top, "narrow"), (top + 1, "wide"),
                    (1 << 20, "wide")):
        assert cuda_ops.width_mode(g, "madd_multi", n, dev) == mode


@pytest.mark.parametrize("group", ["g1", pytest.param("g2", marks=pytest.mark.slow)])
def test_k6_twin_matches_jax(group):
    """K6 (`madd` / `g2_madd`, K7's narrow kernel at S = 1) on CPU
    tensors, its twin, against the JAX package's madd on the edge-case
    lanes of one step, word for word."""
    _, _, ncomp = GROUPS[group]
    fn = cuda_ops.madd if group == "g1" else cuda_ops.g2_madd
    rs = np.random.default_rng([13, ncomp])
    acc, q, skip, _, _, _ = curve_steps(group, "edges", 1, rs)
    q = tuple(t.select(-2, 0) for t in q)
    ops = PallasCurveOps(jcurve.FPA if group == "g1" else jcurve.FP2A, name=group)
    ops._kernels = None  # the group law it runs where no Pallas kernel applies
    want = ops.madd(tuple(_jax(t) for t in acc), tuple(_jax(t) for t in q),
                    jnp.asarray(skip[0].numpy()))
    for a, b in zip(fn(acc, q, skip[0]), want):
        np.testing.assert_array_equal(unpack16(a).numpy().astype(np.uint32), np.asarray(b))


def test_k6_record():
    """K6 has one registry record a group, without modes: it runs K7's
    narrow entry at S = 1 (no entry of its own) and counts apart."""
    for name in ("g1_madd", "g2_madd"):
        k = kernels.REGISTRY[name]
        assert not k.modes and k.source.endswith("csrc/madd_multi.cuh")
        assert f"kzg_{name}_multi_narrow" in kernels._SIGNATURES
        assert f"kzg_{name}" not in kernels._SIGNATURES
        assert name not in cuda_ops.NARROW_WAVES
    k = kernels.REGISTRY["g2_madd"]
    try:
        k.count()
        assert kernels.launch_counts()["g2_madd"] == 1
        assert kernels.launch_counts()["g2_madd_multi"] == 0
        assert "g2_madd" not in kernels.mode_counts()
    finally:
        kernels.reset_launches()


def test_unknown_mode_raises():
    with pytest.raises(kernels.KernelError):
        cuda_ops._pick_mode(cuda_ops._G1K, "madd_multi", 3, None, "medium")
    assert cuda_ops._pick_mode(cuda_ops._G2K, "madd_multi", 3, None, "wide") == "wide"


@pytest.mark.parametrize("offset", [0, 1, 2, 3, 4])
def test_mask_bytes_are_aligned(offset):
    """A mask sliced at any byte reaches the kernel as the same bytes at a
    4-byte aligned address (the narrow kernel copies 32-bit words)."""
    base = torch.rand((4, 7), generator=torch.Generator().manual_seed(offset)) < 0.5
    mask = base.reshape(-1)[offset:offset + 14].reshape(2, 7)
    b = cuda_ops._mask_bytes(mask)
    assert b.data_ptr() % 4 == 0 and b.dtype == torch.uint8
    assert torch.equal(b, mask.reshape(-1).view(torch.uint8))


def test_k7_records_count_by_mode():
    """K7 has one registry record a group, naming its two modes' sources
    (files of the build) and counting their launches apart."""
    assert "madd_multi.cuh" in kernels.HEADERS and "pair.cuh" in kernels.HEADERS
    for name in ("g1_madd_multi", "g2_madd_multi"):
        k = kernels.REGISTRY[name]
        assert set(k.modes) == {"narrow", "wide"}
        assert all(src.split("/")[-1] in kernels.SOURCES for src in k.modes.values())
        assert f"kzg_{name}_narrow" in kernels._SIGNATURES
    k = kernels.REGISTRY["g1_madd_multi"]
    try:
        k.count("narrow")
        k.count("wide")
        k.count("wide")
        assert kernels.mode_counts()["g1_madd_multi"] == {"narrow": 1, "wide": 2}
        assert kernels.launch_counts()["g1_madd_multi"] == 3
    finally:
        kernels.reset_launches()
    assert kernels.mode_counts()["g1_madd_multi"] == {"narrow": 0, "wide": 0}


def test_neg_keeps_zero():
    """A negated zero y stays 0 in the program, as in the twin (p - 0 would
    not be canonical)."""
    prog = horner_schedule.expand(1)
    one = (1 << 384) % P
    acc = ((one,), (one,), (0,))  # infinity: the step's point is taken as it is
    got = horner_schedule.simulate_madd_multi(prog, [acc], [[((5,), (0,))]], [[False]], [[True]])
    assert got == [((5,), (0,), (one,))]
