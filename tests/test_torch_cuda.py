"""Kernels K1-K9 (G1 and G2) on the card against their plain PyTorch twins,
exact, K2 in both modes (narrow and wide, at widths straddling the
crossover, its edge cases in both halves of a block), K3 and the bucket
loop also on skewed digits, K4 at the window join's edge cases, K8 also in its cooperative mode, K1's Fermat chain
(`field_pow`) and the digit ladder (G1 and G2, also at its edge cases);
the scan kernel `field_scan` (Fr and Fp, mul and add, forward and
reverse, array, column, total and pair modes) and the Horner kernel
`fr_horner` (division and remainder alone, a zero x, a carry in, no
points and more than a launch holds), at ragged sizes and 2^15, and their
refusals;
the matmul-DFT NTT and
device setup on the card; the default device; and no fallback when the
kernel build fails.

Needs a CUDA device and nvcc; skips elsewhere. This file imports no JAX, so
it runs where JAX is absent:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda
"""

import dataclasses

import numpy as np
import pytest
import torch

from kzg_tpu_torch import config, kernels, native
from kzg_tpu_torch.bench import horner as hbench
from kzg_tpu_torch.bench import ladder as lbench
from kzg_tpu_torch.bench import pointwise as pw
from kzg_tpu_torch.constants import P, R
from kzg_tpu_torch.curve import (
    G1, G2, cuda_ops, g1_from_device, g2_from_device, g2_generator_device,
)
from kzg_tpu_torch.fields import FP, FR, cuda_field
from kzg_tpu_torch.msm import msm_g1, msm_g2, pippenger
from kzg_tpu_torch.ntt import Domain, mxu
from kzg_tpu_torch.poly import horner

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


K2 = {"g1": (cuda_ops.add, cuda_ops.dbl, cuda_ops.add_plain, cuda_ops.dbl_plain, g1_from_device,
             cuda_ops._G1K),
      "g2": (cuda_ops.g2_add, cuda_ops.g2_dbl, cuda_ops.g2_add_plain, cuda_ops.g2_dbl_plain,
             g2_from_device, cuda_ops._G2K)}


def _k2_top(dev, group, op):
    """The most points K2 `op` sends to its narrow mode on this card."""
    return cuda_ops.NARROW_WAVES[f"{group}_{op}"] * 2 * (
        torch.cuda.get_device_properties(dev).multi_processor_count
        * cuda_ops.narrow_min_blocks(K2[group][5].ncomp))


@pytest.mark.parametrize("where", ["1", "3", "edges", "top", "top+1"])
@pytest.mark.parametrize("op", ["add", "dbl"])
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_k2_modes(dev, group, op, where):
    """Both modes of K2 add or dbl against the twin at widths straddling
    the crossover, the edge pairs in the first points (both halves of every
    narrow block); the width's own mode taken by default."""
    add, dbl, add_plain, dbl_plain, _, _ = K2[group]
    edges = pw.edge_pairs(group, dev)
    top = _k2_top(dev, group, op)
    n = {"1": 1, "3": 3, "edges": edges[0][0].shape[-1], "top": top, "top+1": top + 1}[where]
    p, q = pw.planted(group, n, torch.Generator(device=dev).manual_seed(n), edges[:2])
    fn, args = (add, (p, q)) if op == "add" else (dbl, (p,))
    want = add_plain(p, q) if op == "add" else dbl_plain(p)
    for mode in cuda_ops.K2_MODES:
        assert _equal(fn(*args, mode=mode), want)
    before = kernels.mode_counts()[f"{group}_{op}"]
    assert _equal(fn(*args), want)
    after = kernels.mode_counts()[f"{group}_{op}"]
    assert {m: after[m] - before[m] for m in after} == {"narrow": int(n <= top),
                                                        "wide": int(n > top)}


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_k2_edge_pairs_match_oracle(dev, group):
    add, dbl, _, _, from_device, _ = K2[group]
    p, q, want, _ = pw.edge_pairs(group, dev)
    for mode in cuda_ops.K2_MODES:
        assert from_device(add(p, q, mode=mode)) == want
        pts = from_device(p)
        assert from_device(dbl(p, mode=mode)) == [None if a is None else lbench._mul(a, 2)
                                                  for a in pts]


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


def _fr_words(dev, seed, shape):
    rs = np.random.default_rng(seed)
    vals = [int.from_bytes(rs.bytes(32), "little") % R for _ in range(int(np.prod(shape)))]
    return torch.from_numpy(FR.encode(vals)).reshape((FR.W,) + shape).to(dev)


def test_k5_ntt_stage_layouts(dev):
    for nb, m, bt in ((1, 2, 1), (3, 32, 1), (2, 16, 5)):
        x = _fr_words(dev, 7 + m, (nb, m, bt))
        tw = _fr_words(dev, 8, (m // 2,))
        for s in range(m.bit_length() - 1):
            assert _equal(cuda_field.ntt_stage(x, tw, s),
                          cuda_field.ntt_stage_layout_plain(x, tw, s))


def test_k5_domains(dev, monkeypatch):
    """Pease transforms of the tiny domains 2^1-2^5 (batched) and a
    four-step domain, against the domain's plain twin."""
    for exp in range(1, 6):
        dom = Domain(exp)
        x = _fr_words(dev, 20 + exp, (3, dom.d))
        for name in ("ntt", "intt", "coset_ntt", "coset_intt"):
            assert _equal(getattr(dom, name)(x), getattr(dom.as_plain(), name)(x))
    monkeypatch.setattr(
        config, "_config", dataclasses.replace(config.get_config(), ntt_four_step_min_exp=4)
    )
    dom = Domain(9)
    x = _fr_words(dev, 30, (dom.d,))
    for name in ("ntt", "intt"):
        assert _equal(getattr(dom, name)(x), getattr(dom.as_plain(), name)(x))


def _g2_points(dev, n, seed):
    """Jacobian G2 points k_i * G (12-bit k_i) built with the plain twins."""
    rs = np.random.default_rng(seed)
    g = tuple(t.to(dev) for t in g2_generator_device(n))
    bits = torch.from_numpy(rs.integers(0, 2, size=(12, n))).to(dev)
    return tuple(t.contiguous() for t in cuda_ops.PLAIN2.scalar_mul_bits(g, bits))


def test_g2_add_dbl(dev):
    p = _g2_points(dev, 64, 9)
    q = tuple(t.roll(1, dims=-1).clone() for t in p)
    for i in range(3):
        q[i][:, :, 5] = p[i][:, :, 5]  # P + P
    q[0][:, :, 6], q[2][:, :, 6] = p[0][:, :, 6], p[2][:, :, 6]
    q[1][:, :, 6] = cuda_ops.PLAIN2.f.neg(p[1][:, :, 6])  # P + (-P)
    q[2][:, :, 7] = 0  # Q at infinity
    assert _equal(cuda_ops.g2_add(p, q), cuda_ops.g2_add_plain(p, q))
    assert _equal(cuda_ops.g2_dbl(p), cuda_ops.g2_dbl_plain(p))


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_k6_madd_and_digit_ladder(dev, group):
    """madd against its twin with skip, infinite, same and opposite lanes;
    the digit ladder through the kernels against the ladder on the twins."""
    if group == "g1":
        p, _ = _points(dev, 200, 11)
        q, _ = _points(dev, 200, 12)
        curve, plain, kfn, pfn = G1, cuda_ops.PLAIN, cuda_ops.madd, cuda_ops.madd_plain
    else:
        p, q = _g2_points(dev, 200, 11), _g2_points(dev, 200, 12)
        curve, plain, kfn, pfn = G2, cuda_ops.PLAIN2, cuda_ops.g2_madd, cuda_ops.g2_madd_plain
    qx, qy, q_inf = plain.to_affine(q)
    px, py, _ = plain.to_affine(p)
    qx[..., 5], qy[..., 5] = px[..., 5], py[..., 5]  # P + P
    qx[..., 6], qy[..., 6] = px[..., 6], plain.f.neg(py[..., 6])  # P + (-P)
    skip = q_inf | (torch.arange(200, device=dev) % 7 == 3)
    got = kfn(p, (qx, qy), skip)
    assert _equal(got, pfn(p, (qx, qy), skip))
    assert bool(curve.is_inf(got)[6]) or bool(curve.is_inf(p)[6])
    rs = np.random.default_rng(13)
    digits = torch.from_numpy(rs.integers(0, 8, size=(4, 200))).to(dev)
    a = curve.scalar_mul_digits(p, digits, 3)
    b = plain.scalar_mul_digits(p, digits, 3)
    assert bool(curve.eq(a, b).all())


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_k7_madd_multi_and_bucket_loop(dev, group):
    """madd_multi against its twin: 5 steps over 200 lanes with skip and neg
    masks, an infinite accumulator lane, a same-point and an opposite-point
    step; then the bucket loop on it against K3 on the same inputs."""
    if group == "g1":
        p, _ = _points(dev, 200, 21)
        qs = [_points(dev, 200, 22 + s)[0] for s in range(5)]
        curve, plain = G1, cuda_ops.PLAIN
        kfn, pfn = cuda_ops.madd_multi, cuda_ops.madd_multi_plain
    else:
        p = _g2_points(dev, 200, 21)
        qs = [_g2_points(dev, 200, 22 + s) for s in range(5)]
        curve, plain = G2, cuda_ops.PLAIN2
        kfn, pfn = cuda_ops.g2_madd_multi, cuda_ops.g2_madd_multi_plain
    bd = plain.f.bdim
    aff = [plain.to_affine(q) for q in qs]
    px, py, _ = plain.to_affine(p)
    aff[0][0][..., 5], aff[0][1][..., 5] = px[..., 5], py[..., 5]  # step 0: P + P
    aff[0][0][..., 6], aff[0][1][..., 6] = px[..., 6], py[..., 6]  # negated below: P + (-P)
    qx = torch.stack([a[0] for a in aff], dim=bd)
    qy = torch.stack([a[1] for a in aff], dim=bd)
    rs = np.random.default_rng(27)
    skip = torch.stack([a[2] for a in aff]) | torch.from_numpy(rs.random((5, 200)) < 0.3).to(dev)
    neg = torch.from_numpy(rs.random((5, 200)) < 0.3).to(dev)
    skip[0, 5:7] = False
    neg[0, 5], neg[0, 6] = False, True
    p[2][..., 8] = 0  # an accumulator at infinity
    for masks in ((skip, neg), (skip, None)):
        assert _equal(kfn(p, (qx, qy), *masks), pfn(p, (qx, qy), *masks))
    n, c = 700, 6
    x, y, inf = plain.to_affine(_points(dev, n, 28)[0] if group == "g1" else _g2_points(dev, n, 28))
    scal = torch.from_numpy(FR.from_ints(_ints(29, R, n))).to(dev)
    inputs = pippenger.bucket_inputs(x, y, inf, scal, c)
    assert _equal(pippenger._bucket_loop(curve, *inputs), cuda_ops.bucket_accumulate(*inputs))


def test_g2_pippenger_kernels_and_msm(dev):
    """K3 / K4 over Fp2 against their twins, and msm_g2 on both bucket
    routes (the bucket loop on K7 below 1024 buckets a window, K3 from
    there) against the native engine (also the [-1, 0, ..., 0, 1] vector)."""
    n, c = 600, 5
    x, y, inf = cuda_ops.PLAIN2.to_affine(_g2_points(dev, n, 14))
    ints = _ints(15, R, n)
    inputs = pippenger.bucket_inputs(x, y, inf, torch.from_numpy(FR.from_ints(ints)).to(dev), c)
    assert inputs[0].shape == (n, 48)
    acc = cuda_ops.bucket_accumulate(*inputs)
    assert _equal(acc, cuda_ops.bucket_accumulate_plain(*inputs))
    s_all = pippenger.weighted_bucket_sum(G2, acc)
    assert _equal(cuda_ops.horner_join(s_all, c), cuda_ops.horner_join_plain(s_all, c))
    host = g2_from_device((x, y, inf))
    for scal, window, kernel in ((ints, None, "g2_madd_multi"),
                                 ([R - 1] + [0] * (n - 2) + [1], None, "g2_madd_multi"),
                                 (ints, 10, "g2_bucket_accumulate")):
        before = kernels.launch_counts()
        got = msm_g2((x, y, inf), torch.from_numpy(FR.encode(scal)).to(dev), window)
        after = kernels.launch_counts()
        assert g2_from_device(tuple(t[..., None] for t in got))[0] == native.g2_msm(host, scal)
        assert after[kernel] > before[kernel]
        assert after["g2_horner_join"] == before["g2_horner_join"] + 1


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_k3_and_bucket_loop_on_skewed_digits(dev, group):
    """All-equal scalars (every point of a window in one bucket) and
    [R - 1] + [1] * (n - 1): no sub-run longer than L; K3 on the sub-runs
    against its twin word for word; the K3 route against its twin and
    against the bucket loop on K7 and on the twins; both MSM routes against
    the native engine."""
    n = 600
    if group == "g1":
        pts = _points(dev, n, 41)[0]
        curve, plain, msm_fn = G1, cuda_ops.PLAIN, msm_g1
        from_dev, native_msm = g1_from_device, native.g1_msm
    else:
        pts = _g2_points(dev, n, 41)
        curve, plain, msm_fn = G2, cuda_ops.PLAIN2, msm_g2
        from_dev, native_msm = g2_from_device, native.g2_msm
    x, y, inf = plain.to_affine(pts)
    host = from_dev((x, y, inf))
    for scal in ([_ints(43, R, 4)[3]] * n, [R - 1] + [1] * (n - 1)):
        std = torch.from_numpy(FR.from_ints(scal)).to(dev)
        for c in (5, 10):
            inputs = pippenger.bucket_inputs(x, y, inf, std, c)
            runs = pippenger.split_runs(inputs[2], inputs[3], n)
            assert runs.longest <= runs.run_length < int(inputs[3].max())
            assert _equal(cuda_ops.bucket_runs(inputs[0], inputs[1], runs.pos, runs.length),
                          cuda_ops.bucket_runs_plain(inputs[0], inputs[1], runs.pos, runs.length))
            k3 = cuda_ops.bucket_accumulate(*inputs)
            assert _equal(k3, cuda_ops.bucket_accumulate_plain(*inputs))
            assert _equal(pippenger._bucket_loop(curve, *inputs), k3)
            assert _equal(pippenger._bucket_loop(plain, *inputs), k3)
        for window in (None, 10):  # the bucket loop (c = 4), K3
            got = msm_fn((x, y, inf), torch.from_numpy(FR.encode(scal)).to(dev), window)
            assert from_dev(tuple(t[..., None] for t in got))[0] == native_msm(host, scal)


@pytest.mark.parametrize("field,mod", [(FR, R), (FP, P)], ids=["Fr", "Fp"])
def test_k8_mul_chain(dev, field, mod):
    xs, ys = _ints(31, mod, 1000), _ints(32, mod, 1000)[::-1]
    a = torch.from_numpy(field.encode(xs)).to(dev)
    b = torch.from_numpy(field.encode(ys)).to(dev)
    for k in (0, 1, 2, 65):
        before = kernels.launch_counts()["mul_chain"]
        got = cuda_field.mul_chain(field, k, a, b)
        assert kernels.launch_counts()["mul_chain"] == before + 1
        assert _equal(got, cuda_field.mul_chain_plain(field, k, a, b))
        # the cooperative mode: each product over 16 lanes, as K4 runs it
        assert _equal(cuda_field.mul_chain(field, k, a, b, cooperative=True), got)
    assert field.decode(got[:, :4]) == [x * pow(y, 65, mod) % mod for x, y in zip(xs[:4], ys[:4])]


@pytest.mark.parametrize("case", list(hbench.CASES))
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_k4_edge_cases(dev, group, case):
    """K4 against its twin at the join's edge cases: empty top windows,
    every S_w at infinity, P == Q and P == -Q in the add, W = 1, c = 1 and
    c = 16; one launch a join."""
    s_all, c = hbench.edge_case_sums(group, case, dev)
    name = f"{group}_horner_join"
    before = kernels.launch_counts()[name]
    got = cuda_ops.horner_join(s_all, c)
    assert kernels.launch_counts()[name] == before + 1
    assert _equal(got, cuda_ops.horner_join_plain(s_all, c))


@pytest.mark.parametrize("n", [1, 2, 33, 4096])
@pytest.mark.parametrize("field,mod", [(FR, R), (FP, P)], ids=["Fr", "Fp"])
def test_field_pow(dev, field, mod, n):
    """K1's Fermat chain against its plain version, e = m - 2 (an inverse,
    0 -> 0) and a random e; one launch a power, also through inv."""
    xs = _ints(41 + n, mod, max(n, 3))[:n]
    a = torch.from_numpy(field.encode(xs)).to(dev)
    e_rand = int.from_bytes(np.random.default_rng(n).bytes(48), "little") % mod
    for e in (mod - 2, e_rand):
        before = kernels.launch_counts()["field_pow"]
        got = cuda_field.field_pow(field, a, e)
        assert kernels.launch_counts()["field_pow"] == before + 1
        assert _equal(got, cuda_field.field_pow_plain(field, a, e))
        assert field.decode(got[:, :3]) == [pow(x, e, mod) for x in xs[:3]]
    before = kernels.launch_counts()
    assert field.decode(field.inv(a)[:, :3]) == [pow(x, -1, mod) if x else 0 for x in xs[:3]]
    after = kernels.launch_counts()
    assert after["field_pow"] == before["field_pow"] + 1
    assert after["field_elementwise"] == before["field_elementwise"] + 1  # the decode


SCAN_SIZES = [1, 2, 3, 31, 32, 33, 255, 1000, 1024, 1025, 4097, 1 << 15]


def _scan_passes(n):
    """Tile passes of one scan: one tile, or totals, their scan and a pass."""
    return 1 if n <= cuda_field.SCAN_TILE else 3


@pytest.mark.parametrize("n", SCAN_SIZES)
@pytest.mark.parametrize("field,mod", [(FR, R), (FP, P)], ids=["Fr", "Fp"])
def test_field_scan(dev, field, mod, n):
    """The scan kernel against its plain version in every mode, rows 1 and
    3 (edges 0, 1, m - 1 first), with its launches a call."""
    x = torch.from_numpy(field.encode(_ints(50 + n, mod, 3 * max(n, 3))[:3 * n]))
    x = x.reshape(field.W, 3, n).to(dev)
    for rows in (x[:, :1], x):
        for op in (cuda_field.ADD, cuda_field.MUL):
            for reverse in (False, True):
                before = kernels.launch_counts()["field_scan"]
                got = cuda_field.field_scan(field, op, rows, reverse)
                assert kernels.launch_counts()["field_scan"] == before + _scan_passes(n)
                assert _equal(got, cuda_field.field_scan_plain(field, op, rows, reverse))
            assert _equal(cuda_field.field_scan(field, op, rows, mode="total"),
                          cuda_field.field_scan_plain(field, op, rows, mode="total"))
            col = rows[..., n // 2]
            assert _equal(cuda_field.field_scan(field, op, col, mode="column", n=n),
                          cuda_field.field_scan_plain(field, op, col, mode="column", n=n))
    assert field.decode(field.sum_last(x[:, 0])) == [sum(field.decode(x[:, 0])) % mod]


@pytest.mark.parametrize("field,mod", [(FR, R), (FP, P)], ids=["Fr", "Fp"])
def test_batch_inv_on_scans(dev, field, mod):
    vals = _ints(60, mod, 2 * 777)
    vals[5] = vals[700] = 0
    a = torch.from_numpy(field.encode(vals)).reshape(field.W, 2, 777).to(dev)
    got = field.batch_inv(a)
    assert field.decode(got) == [pow(v, -1, mod) if v else 0 for v in vals]
    assert _equal(got, field.as_plain().batch_inv(a))


HORNER_SIZES = [1, 2, 3, 33, 1000, 1023, 1024, 4097, 1 << 15]


@pytest.mark.parametrize("n", HORNER_SIZES)
def test_fr_horner(dev, n):
    """The Horner kernel against its plain version: division and remainder
    alone, 3 points (one of them 0), with and without a carry in."""
    f = _fr_words(dev, 70 + n, (n,))
    x = _fr_words(dev, 71, (3,))
    x[:, 1] = 0
    carry = _fr_words(dev, 72, (3,))
    for cin in (None, carry):
        for rem_only in (False, True):
            got = horner.fr_horner(f, x, cin, rem_only)
            want = horner.fr_horner_plain(f, x, cin, rem_only)
            assert got[0] is None if rem_only else _equal(got[0], want[0])
            assert _equal(got[1], want[1])
    before = kernels.launch_counts()["fr_horner"]
    horner.fr_horner(f, x[:, :1])
    assert kernels.launch_counts()["fr_horner"] == before + (1 if n <= cuda_field.SCAN_TILE else 3)


@pytest.mark.parametrize("k", [0, horner.MAX_POINTS + 2])
def test_fr_horner_points_beyond_one_launch(dev, k):
    """No points, and more points than a launch's grid holds (split into
    launches of MAX_POINTS): equal to the plain version."""
    f = _fr_words(dev, 73, (5,))
    x = _fr_words(dev, 74, (k,))
    for rem_only in (False, True):
        got = horner.fr_horner(f, x, rem_only=rem_only)
        want = horner.fr_horner_plain(f, x, rem_only=rem_only)
        assert got[0] is None if rem_only else _equal(got[0], want[0])
        assert _equal(got[1], want[1])


@pytest.mark.parametrize("n", [1, 2, 1000, 4097, 1 << 15])
@pytest.mark.parametrize("field,mod", [(FR, R), (FP, P)], ids=["Fr", "Fp"])
def test_field_scan_pair(dev, field, mod, n):
    """The pair mode (each row's exclusive prefix and suffix in one pass,
    batch_inv's scan) against its plain version at rows 1 and 3, with its
    launches a call."""
    x = torch.from_numpy(field.encode(_ints(90 + n, mod, 3 * max(n, 3))[:3 * n]))
    x = x.reshape(field.W, 3, n).to(dev)
    for rows in (x[:, :1], x):
        before = kernels.launch_counts()["field_scan"]
        got = cuda_field.field_scan(field, cuda_field.MUL, rows, mode="pair")
        assert kernels.launch_counts()["field_scan"] == before + _scan_passes(n)
        assert _equal(got, cuda_field.field_scan_plain(field, cuda_field.MUL, rows, mode="pair"))


def test_scan_and_horner_refuse_bad_operands(dev):
    f = _fr_words(dev, 80, (64,))
    x = _fr_words(dev, 81, (2,))
    with pytest.raises(kernels.KernelError):
        cuda_field.field_scan(FR, cuda_field.MUL, f.to(torch.int64))
    with pytest.raises(kernels.KernelError):
        cuda_field.field_scan(FP, cuda_field.MUL, f)  # 8 words are not an Fp element
    with pytest.raises(kernels.KernelError):
        cuda_field.field_scan(FR, cuda_field.ADD, f[:, :1, None].expand(FR.W, 70000, 1))
    with pytest.raises(ValueError):
        cuda_field.field_scan(FR, cuda_field.SUB, f)
    with pytest.raises(kernels.KernelError):
        horner.fr_horner(f.to(torch.int64), x)
    with pytest.raises(kernels.KernelError):
        horner.fr_horner(f, x.cpu())
    with pytest.raises(kernels.KernelError):
        horner.fr_horner(f, x, carry=x[:, :1])
    with pytest.raises(kernels.KernelError):
        horner.fr_horner(f[:, :0], x)
    with pytest.raises(kernels.KernelError):
        horner.fr_horner(f[:, None].expand(FR.W, 2, 64), x)  # one polynomial for all points


LADDER_WINDOWS = {1: 12, 4: 6, 8: 3}


@pytest.mark.parametrize("c", sorted(LADDER_WINDOWS))
@pytest.mark.parametrize("lanes", [1, 7, 2048])
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_ladder(dev, group, lanes, c):
    """The ladder kernel against its twin on random tables and digits, p
    infinite on lane 1 and all-zero digits on lane 2 where there are such
    lanes; one launch a ladder."""
    gen = torch.Generator(device=dev).manual_seed(lanes * 16 + c)
    tx, ty, p_inf, digits = lbench.random_ladder(group, lanes, c, LADDER_WINDOWS[c], gen)
    if lanes > 2:
        p_inf[1] = True
        digits[:, 2] = 0
    name = f"{group}_ladder"
    before = kernels.launch_counts()[name]
    got = cuda_ops.ladder(tx, ty, p_inf, digits, c)
    assert kernels.launch_counts()[name] == before + 1
    assert _equal(got, cuda_ops.ladder_plain(tx, ty, p_inf, digits, c))


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_ladder_edge_cases(dev, group):
    """P == Q, P == -Q, all-zero digits, p infinite, infinity + Q: the
    kernel equals its twin, and the oracle's points."""
    tx, ty, p_inf, digits, c, want = lbench.edge_case(group, dev)
    from_device = g1_from_device if group == "g1" else g2_from_device
    got = cuda_ops.ladder(tx, ty, p_inf, digits, c)
    assert _equal(got, cuda_ops.ladder_plain(tx, ty, p_inf, digits, c))
    assert from_device(got) == want
    # the kernel pairs lanes 2k and 2k + 1 in a block: the lanes reversed
    # meet each other's cases (and the odd lane out) in other pairs
    flip = [t.flip(-1).contiguous() for t in (tx, ty, p_inf, digits)]
    got = cuda_ops.ladder(*flip, c)
    assert _equal(got, cuda_ops.ladder_plain(*flip, c))
    assert from_device(got) == want[::-1]


def test_k9_mxu_reduce_and_product(dev):
    """K9 against its plain version on a real product's digit sums (a lane
    count that is no multiple of 8, so the product pads) and on the largest
    legal digit sums; the int8 product against the float64 one."""
    x = _fr_words(dev, 33, (3, 32, 7))
    planes = mxu.to_planes(x, 5)
    y = mxu.digit_sums(5, True, planes)
    assert _equal(y, mxu.digit_sums_plain(5, True, planes))
    y = y.reshape(mxu.OUT_DIGITS, -1)
    assert _equal(mxu.mxu_reduce(y), mxu.mxu_reduce_plain(y))
    pairs = [min(31, d) - max(0, d - 31) + 1 for d in range(63)] + [0]
    top = (torch.tensor(pairs, device=dev)[:, None] * (255 * 255 * 128)).expand(-1, 300)
    top = top.to(torch.int32).contiguous()
    assert _equal(mxu.mxu_reduce(top), mxu.mxu_reduce_plain(top))
    for inverse in (False, True):
        assert _equal(mxu.dft_axis2(5, inverse, x), mxu.dft_axis2(5, inverse, x, plain=True))


def test_mxu_ntt_equals_butterfly_ntt(dev, monkeypatch):
    """Domain transforms under ntt_mxu="auto" (balanced and pinned splits)
    equal the K5 path word for word, launch K9 and no butterfly stage."""
    for exp in (9, 14, 15):
        dom = Domain(exp)
        x = _fr_words(dev, 50 + exp, (dom.d,)) if exp == 9 else torch.cat(
            [_fr_words(dev, 50 + exp, (512,))] * (dom.d // 512), dim=1)
        monkeypatch.setattr(config, "_config",
                            dataclasses.replace(config.get_config(), ntt_mxu="off"))
        want = [getattr(dom, name)(x) for name in ("ntt", "intt", "coset_ntt", "coset_intt")]
        monkeypatch.setattr(config, "_config",
                            dataclasses.replace(config.get_config(), ntt_mxu="auto"))
        kernels.reset_launches()
        got = [getattr(dom, name)(x) for name in ("ntt", "intt", "coset_ntt", "coset_intt")]
        counts = kernels.launch_counts()
        assert all(_equal(a, b) for a, b in zip(got, want)), exp
        assert counts["mxu_reduce"] > 0 and counts["ntt_stage"] == 0


def test_setup_device_on_the_card(dev, monkeypatch):
    """The default config takes the device route on a card; its SRS equals
    the host engine's, and the Lagrange basis by the device route the host
    route's."""
    from kzg_tpu_torch.kzg import setup
    from kzg_tpu_torch.kzg.eval_form import compute_lagrange_basis_from_secret

    assert config.get_config().setup_engine == "auto"
    kernels.reset_launches()
    a = setup(7, 300)
    assert kernels.launch_counts()["g1_add"] >= 32 and kernels.launch_counts()["g2_add"] >= 32
    la = compute_lagrange_basis_from_secret(7, 5)
    monkeypatch.setattr(config, "_config",
                        dataclasses.replace(config.get_config(), setup_engine="host"))
    b = setup(7, 300)
    lb = compute_lagrange_basis_from_secret(7, 5)
    assert all(t.is_cuda for t in a.gs + a.hs)
    assert _equal(a.gs + a.hs, b.gs + b.hs)
    assert _equal(la.lg + la.lh, lb.lg + lb.lh)


def test_default_device_is_the_card(dev):
    from kzg_tpu_torch.kzg import setup
    from kzg_tpu_torch.poly import Polynomial

    assert config.get_config().device == "cuda"
    params = setup(5, 4)
    assert all(t.is_cuda for t in params.gs + params.hs)
    assert Polynomial.from_ints([1, 2, 3]).coeffs.is_cuda and FR.one((2,)).is_cuda


def test_no_fallback_when_the_build_fails(dev, monkeypatch):
    def failed_build():
        raise kernels.KernelError("build failed")

    monkeypatch.setattr(kernels, "_lib", None)
    monkeypatch.setattr(kernels, "build", failed_build)
    x = _fr_words(dev, 40, (1, 8, 1))
    p = tuple(t.to(dev) for t in g2_generator_device(4))
    with pytest.raises(kernels.KernelError):
        cuda_field.ntt_stage(x, x[:, 0, :4, 0], 0)
    with pytest.raises(kernels.KernelError):
        cuda_ops.g2_add(p, p)
    with pytest.raises(kernels.KernelError):
        cuda_ops.g2_dbl(p)
    for mode in cuda_ops.K2_MODES:
        with pytest.raises(kernels.KernelError):
            cuda_ops.g2_add(p, p, mode=mode)
    with pytest.raises(kernels.KernelError):
        cuda_field.mul_chain(FR, 3, x, x)
    with pytest.raises(kernels.KernelError):
        cuda_field.field_pow(FR, x, FR.modulus - 2)
    with pytest.raises(kernels.KernelError):
        cuda_field.field_scan(FR, cuda_field.MUL, x[:, 0])
    with pytest.raises(kernels.KernelError):
        horner.fr_horner(x[:, 0, :, 0], x[:, 0, :2, 0])
    tx, ty, p_inf, digits = lbench.random_ladder(
        "g1", 4, 2, 3, torch.Generator(device=dev).manual_seed(0))
    with pytest.raises(kernels.KernelError):
        cuda_ops.ladder(tx, ty, p_inf, digits, 2)
    with pytest.raises(kernels.KernelError):
        mxu.mxu_reduce(torch.zeros((mxu.OUT_DIGITS, 8), dtype=torch.int32, device=dev))
    skip = torch.zeros(4, dtype=torch.bool, device=dev)
    with pytest.raises(kernels.KernelError):
        cuda_ops.g2_madd(p, p[:2], skip)
    g1p = tuple(t[:, 0].contiguous() for t in p)  # (12, 4) words stand in for G1 points
    with pytest.raises(kernels.KernelError):
        cuda_ops.madd(g1p, g1p[:2], skip)
    q3 = tuple(t[:, :, None].expand(-1, -1, 3, -1).contiguous() for t in p[:2])
    with pytest.raises(kernels.KernelError):
        cuda_ops.g2_madd_multi(p, q3, torch.zeros(3, 4, dtype=torch.bool, device=dev))
    # G2 Pippenger (512 points take the bucket route) raises too: no ladder
    # and no twin stands in for the missing kernels
    inf = torch.zeros(512, dtype=torch.bool, device=dev)
    g = tuple(t.to(dev) for t in g2_generator_device(512))
    with pytest.raises(kernels.KernelError):
        msm_g2((g[0], g[1], inf), FR.one((512,), dev))
