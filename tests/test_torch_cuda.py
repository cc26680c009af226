"""Kernels K1-K9 (G1 and G2) on the card against their plain PyTorch twins,
exact, K2 in both modes (narrow and wide, at widths straddling the
crossover, its edge cases in both halves of a block), K7 in both modes
(1-6,755 lanes and the narrow mode's wave +- 1, S = 1, 5, 16, the planted
lanes of `bench.madd_multi.random_steps`; the bucket loop at the 2^15
witness's shape equal to the K3 route), K3 and the bucket
loop also on skewed digits, K4 at the window join's edge cases, K8 also in its cooperative mode, K1's Fermat chain
(`field_pow`) and the digit ladder (G1 and G2, also at its edge cases);
the scan kernel `field_scan` (Fr and Fp, mul and add, forward and
reverse, array, column, total and pair modes) and the Horner kernel
`fr_horner` (division and remainder alone, a zero x, a carry in, no
points and more than a launch holds), at ragged sizes and 2^15, and their
refusals;
K5's block entry `ntt_block` at the paths' shapes (every scale, the
transposed store) and whole transforms on it (launches per transform, the
four-step recursion at a lowered BLOCK_MAX_EXP, a second card where there
is one), K6 (K7's narrow kernel at S = 1); the matmul-DFT NTT (neither K5 entry launched) and device setup on the card; the default device; and no fallback when the
kernel build fails. The 2^24 path's streamed pieces at 2^12 with lowered
chunk logs (the streamed witness, the chunked division and MSM against
their one-shot forms), and the device pairing against the oracle and its
engine against the host engine; the pairing kernels (`miller_loop`,
`final_exp` in lane and product mode) against their plain versions at 1,
2 and 5 lanes with a lane at infinity, their refusal to fall back, the
small MSM on the digit ladder at 1, 3 and 17 points, and the launches of
a device verify; the fixed-base comb `fk20_comb` at FK20's shape and at
its edge cases. The sharded layer at world 1 on NCCL in
this process (`kzg_tpu_torch.parallel`): every sharded transform against
`Domain`, the sharded G1 and G2 MSMs against `msm`, and the three steps
against the one-device provers, at 2^10.

Needs a CUDA device and nvcc; skips elsewhere. This file imports no JAX, so
it runs where JAX is absent:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda
"""

import dataclasses

import numpy as np
import pytest
import torch

from kzg_tpu_torch import config, kernels, native
from kzg_tpu_torch.bench import field_body as fbench
from kzg_tpu_torch.bench import horner as hbench
from kzg_tpu_torch.bench import ladder as lbench
from kzg_tpu_torch.bench import madd_multi as mmbench
from kzg_tpu_torch.bench import pointwise as pw
from kzg_tpu_torch.constants import P, R
from kzg_tpu_torch.curve import (
    G1, G2, cuda_ops, g1_from_device, g2_from_device, g2_generator_device,
)
from kzg_tpu_torch.fields import FP, FR, cuda_field
from kzg_tpu_torch.fields.limb import ints_to_words, words_to_ints
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


@pytest.mark.parametrize("field,mod", [(FR, R), (FP, P)], ids=["Fr", "Fp"])
def test_k1_k8_carry_operands(dev, field, mod):
    """K1 add / sub / mul / mul_const and K8's one-thread chain (k = 1 and
    65) against their plain versions word for word on every ordered pair
    of `bench.field_body.carry_operands` (runs of all-ones and zero words,
    values just below each 2^(32 k), p - 1, R and R^2 mod p, ...), the
    products also against Python integers."""
    a, b = fbench.carry_words(field, dev)
    for op in (cuda_field.ADD, cuda_field.SUB, cuda_field.MUL):
        assert _equal(cuda_field.binary(field, op, a, b), cuda_field.binary_plain(field, op, a, b))
    assert _equal(cuda_field.binary(field, cuda_field.MUL, a, a),
                  cuda_field.binary_plain(field, cuda_field.MUL, a, a))
    r_inv = pow(1 << (32 * field.W), -1, mod)
    xs, ys = words_to_ints(a), words_to_ints(b)
    assert words_to_ints(cuda_field.binary(field, cuda_field.MUL, a, b)) == [
        x * y * r_inv % mod for x, y in zip(xs, ys)]
    for c in fbench.carry_operands(mod, field.W)[::7]:
        c_words = ints_to_words([c], field.W)[:, 0]
        assert _equal(cuda_field.mul_const(field, a, c_words),
                      cuda_field.mul_const_plain(field, a, c_words))
    for k in (1, 65):
        assert _equal(cuda_field.mul_chain(field, k, a, b),
                      cuda_field.mul_chain_plain(field, k, a, b))


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_k2_wide_carry_operands(dev, group):
    """Wide K2 add and dbl (one thread a point: field.cuh's products, and
    over G2 `fp2_mul` / `fp2_sqr`) against the twin on coordinates whose
    words are the Fp carry operands."""
    add, dbl, add_plain, dbl_plain, _, _ = K2[group]
    p, q = fbench.carry_points(group, dev)
    assert _equal(add(p, q, mode="wide"), add_plain(p, q))
    assert _equal(dbl(p, mode="wide"), dbl_plain(p))


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
    for mode in cuda_ops.MODES:
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
    for mode in cuda_ops.MODES:
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


def _random_words(dev, seed, shape):
    """(8, *shape) Fr words drawn on the card, 0, 1 and r - 1 first."""
    g = torch.Generator(device=dev).manual_seed(seed)
    low = torch.randint(-(1 << 31), 1 << 31, (7,) + shape, generator=g, device=dev,
                        dtype=torch.int64)
    top = torch.randint(0, R >> 224, (1,) + shape, generator=g, device=dev, dtype=torch.int64)
    x = torch.cat([low, top]).to(torch.int32)
    k = min(3, x[0].numel())
    x.view(FR.W, -1)[:, :k] = torch.from_numpy(FR.encode([0, 1, R - 1][:k])).to(dev)
    return x


# (log2 m, nb, bt, out_bt, pre, post): the shapes the paths give ntt_block
# (the subproduct trees' stacked levels, 2^12 whole, both four-step passes
# of 2^15 and 2^20), with every scale the Domain fuses
BLOCK_SHAPES = [
    (2, 16, 1, 1, None, None), (3, 8, 1, 1, None, "const"), (5, 2, 1, 1, None, None),
    (12, 1, 1, 1, None, "const"), (12, 1, 1, 1, "linear", None), (12, 1, 1, 1, None, "linear"),
    (8, 1, 128, 128, "linear", "product"), (8, 1, 128, 128, None, "product"),
    (7, 256, 1, 256, None, "linear"), (7, 256, 1, 256, None, "const"),
    (10, 1, 1024, 1024, "linear", "product"), (10, 1024, 1, 1024, None, "linear"),
]


def _block_scale(top, kind, inverse):
    dev = torch.device("cuda", 0)
    if kind is None:
        return None
    if kind == "const":
        return top._scale("dinv_scale", dev, "const", 0, top.d_inv)
    if kind == "product":
        return top._scale(f"twiddle_{'inv' if inverse else 'fwd'}", dev, "product",
                          top.omega_inv if inverse else top.omega)
    if inverse:
        return top._scale("coset_inv_scale", dev, "linear", top.gen_inv, top.d_inv)
    return top._scale("coset_fwd_scale", dev, "linear", top.gen)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("case", range(len(BLOCK_SHAPES)))
def test_ntt_block_at_path_shapes(dev, case, inverse):
    """ntt_block against its twin word for word at the paths' shapes, with
    the coset, 1/d and twiddle scales, nb > 1 and the transposed store;
    also at one column and 128 threads a block."""
    log_m, nb, bt, out_bt, pre, post = BLOCK_SHAPES[case]
    m = 1 << log_m
    top = Domain(log_m + max(bt, out_bt).bit_length() - 1)
    x = _random_words(dev, 60 + case, (nb, m, bt))
    tw = Domain(log_m)._stage_table(inverse, dev)
    args = (x, tw, _block_scale(top, pre, inverse), _block_scale(top, post, inverse), out_bt)
    want = cuda_field.ntt_block_plain(*args)
    kernels.reset_launches()
    assert _equal(cuda_field.ntt_block(*args), want)
    assert _equal(cuda_field.ntt_block(*args, cols=1, threads=128), want)
    assert kernels.launch_counts()["ntt_block"] == 2


@pytest.mark.parametrize("exp", [0, 1, 12, 15, 20])
def test_ntt_block_domains(dev, exp):
    """Whole transforms on the ntt_block route equal the stage loop (and the
    plain domain up to 2^15) word for word, in at most one launch up to
    2^BLOCK_MAX_EXP points and three above, none of them a K5 stage."""
    from kzg_tpu_torch.ntt import domain as ntt_domain

    dom = Domain(exp)
    x = _random_words(dev, 70 + exp, (2, dom.d) if exp <= 12 else (dom.d,))
    for name in ("ntt", "intt", "coset_ntt", "coset_intt"):
        kernels.reset_launches()
        got = getattr(dom, name)(x)
        counts = {k: v for k, v in kernels.launch_counts().items() if v}
        assert sum(counts.values()) == counts.get("ntt_block", 0) <= (
            1 if exp <= ntt_domain.BLOCK_MAX_EXP else 3), (name, counts)
        assert _equal(got, getattr(dom.as_stages(), name)(x))
        if exp <= 15:
            assert _equal(got, getattr(dom.as_plain(), name)(x))


def test_ntt_block_on_a_second_card(dev):
    """ntt_block with tiles above 48 KB of shared memory (a 2^12 transform,
    the 2^10 passes two columns a tile) on card 0 and then on card 1: the
    larger limit is allowed on each card the process launches on."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs a second CUDA device")
    for index in (0, 1):
        d = torch.device("cuda", index)
        with torch.cuda.device(d):
            for exp, shape, cols in ((12, (1, 1 << 12, 1), None), (10, (8, 1 << 10, 1), 2)):
                x = _fr_words(d, 40 + exp, shape)
                tw = Domain(exp)._stage_table(False, d)
                got = cuda_field.ntt_block(x, tw, cols=cols)
                assert got.device == d
                assert torch.equal(got, cuda_field.ntt_block_plain(x, tw)), (index, exp)


def test_ntt_block_recursion(dev, monkeypatch):
    """The four-step composition and its recursion (BLOCK_MAX_EXP lowered
    to 3) along axis 2 with a batch axis, against the plain domain."""
    from kzg_tpu_torch.ntt import domain as ntt_domain

    monkeypatch.setattr(ntt_domain, "BLOCK_MAX_EXP", 3)
    for exp in (5, 7, 9):
        dom = Domain(exp)
        x = _random_words(dev, 80 + exp, (2, dom.d))
        for name in ("ntt", "intt", "coset_ntt", "coset_intt"):
            assert _equal(getattr(dom, name)(x), getattr(dom.as_plain(), name)(x))
        x3 = _random_words(dev, 90 + exp, (dom.d, 3))
        for inverse in (False, True):
            assert _equal(dom._ntt_axis2(x3, inverse), dom.as_plain()._ntt_axis2(x3, inverse))


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


@pytest.mark.parametrize("where", ["1", "3", "200", "wave", "4 waves"])
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_k6_narrow_kernel(dev, group, where):
    """K6 (K7's narrow kernel at S = 1) against its twin on
    `bench.madd_multi`'s planted lanes, one to four waves of the kernel;
    counted as K6, not K7."""
    g = cuda_ops._G1K if group == "g1" else cuda_ops._G2K
    kfn, pfn = ((cuda_ops.madd, cuda_ops.madd_plain) if group == "g1"
                else (cuda_ops.g2_madd, cuda_ops.g2_madd_plain))
    wave = 2 * cuda_ops.narrow_min_blocks(g.ncomp) * (
        torch.cuda.get_device_properties(dev).multi_processor_count)
    lanes = {"wave": wave, "4 waves": 4 * wave}.get(where) or int(where)
    acc, q, skip, _ = mmbench.random_steps(group, lanes, 1,
                                           torch.Generator(device=dev).manual_seed(lanes))
    args = (acc, tuple(t.select(-2, 0) for t in q), skip[0])
    kernels.reset_launches()
    assert _equal(kfn(*args), pfn(*args))
    counts = kernels.launch_counts()
    assert counts[f"{group}_madd"] == 1 and counts[f"{group}_madd_multi"] == 0


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


K7 = {"g1": (cuda_ops.madd_multi, cuda_ops.madd_multi_plain, cuda_ops._G1K),
      "g2": (cuda_ops.g2_madd_multi, cuda_ops.g2_madd_multi_plain, cuda_ops._G2K)}


@pytest.mark.parametrize("steps", [1, 5, 16])
@pytest.mark.parametrize("lanes", [1, 2, 3, 200, 4223, 4224, 4225, 6755])
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_k7_modes(dev, group, lanes, steps):
    """Both modes of K7 against the twin, with and without a neg mask, on
    random field values with the planted lanes (an infinite accumulator, a
    lane skipped at every step, P + P, P + (-P) then a take), a block's
    second lane missing at odd widths, 4,224 +- 1 lanes (a G1 wave of the
    narrow kernel, two G2 waves); the width's own mode taken by default."""
    kfn, pfn, g = K7[group]
    gen = torch.Generator(device=dev).manual_seed(31 * lanes + steps)
    acc, q, skip, neg = mmbench.random_steps(group, lanes, steps, gen)
    want = pfn(acc, q, skip, neg)
    for mode in cuda_ops.MODES:
        assert _equal(kfn(acc, q, skip, neg, mode=mode), want)
    before = kernels.mode_counts()[f"{group}_madd_multi"]
    assert _equal(kfn(acc, q, skip), pfn(acc, q, skip))
    after = kernels.mode_counts()[f"{group}_madd_multi"]
    mode = cuda_ops.width_mode(g, "madd_multi", lanes, dev)
    assert {m: after[m] - before[m] for m in after} == {m: int(m == mode) for m in after}


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_k7_masks_at_an_odd_address(dev, group):
    """Masks sliced one step into an odd-width array (contiguous, at an odd
    byte) give both modes the twin's words: the narrow kernel copies its
    masks in 32-bit words, so the wrapper hands it an aligned copy."""
    kfn, pfn, _ = K7[group]
    lanes, steps = 201, 5
    gen = torch.Generator(device=dev).manual_seed(77)
    acc, q, skip, neg = mmbench.random_steps(group, lanes, steps, gen)
    skip_all = torch.cat([~skip[:1], skip])[1:]
    neg_all = torch.cat([~neg[:1], neg])[1:]
    assert skip_all.is_contiguous() and skip_all.data_ptr() % 4 != 0
    assert neg_all.is_contiguous() and neg_all.data_ptr() % 4 != 0
    want = pfn(acc, q, skip, neg)
    for mode in cuda_ops.MODES:
        assert _equal(kfn(acc, q, skip_all, neg_all, mode=mode), want)
        assert _equal(kfn(acc, q, skip_all, mode=mode), pfn(acc, q, skip))


def test_k7_bucket_loop_at_the_witness_shape(dev):
    """The bucket loop of a 2^15 - 1 point MSM (c = 9, the 2^15 witness's)
    on K7 equals the K3 route word for word, in the mode its width picks
    and in the other."""
    from kzg_tpu_torch.kzg.srs import setup_device

    n = (1 << 15) - 1
    params = setup_device(7, 1 << 15, g2_count=2, device=dev)
    pts = tuple(t[..., :n] for t in params.gs)
    scal = torch.from_numpy(FR.from_ints(_ints(44, R, n))).to(dev)
    inputs = pippenger.bucket_inputs(*pts, scal, 9)
    runs = pippenger.split_runs(inputs[2], inputs[3], n)
    k3 = cuda_ops.bucket_accumulate(*inputs)
    before = kernels.mode_counts()["g1_madd_multi"]
    assert _equal(pippenger._bucket_loop(G1, *inputs), k3)
    after = kernels.mode_counts()["g1_madd_multi"]
    mode = cuda_ops.width_mode(cuda_ops._G1K, "madd_multi", runs.pos.numel(), dev)
    assert after[mode] - before[mode] == -(-runs.longest // config.get_config().msm_fuse_steps)

    class Forced:  # the bucket loop's curve with K7 forced into the other mode
        def __getattr__(self, name):
            return getattr(G1, name)

        def madd_multi(self, acc, q, skip, neg=None):
            return cuda_ops.madd_multi(acc, q, skip, neg,
                                       mode="wide" if mode == "narrow" else "narrow")

    assert _equal(pippenger._bucket_loop(Forced(), *inputs), k3)


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
        assert counts["mxu_reduce"] > 0 and counts["ntt_stage"] == 0 and counts["ntt_block"] == 0


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
        cuda_field.ntt_block(x, Domain(3)._stage_table(False, dev))
    with pytest.raises(kernels.KernelError):
        cuda_ops.g2_add(p, p)
    with pytest.raises(kernels.KernelError):
        cuda_ops.g2_dbl(p)
    for mode in cuda_ops.MODES:
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
    skip3 = torch.zeros(3, 4, dtype=torch.bool, device=dev)
    with pytest.raises(kernels.KernelError):
        cuda_ops.g2_madd_multi(p, q3, skip3)
    for mode in cuda_ops.MODES:
        with pytest.raises(kernels.KernelError):
            cuda_ops.g2_madd_multi(p, q3, skip3, skip3, mode=mode)
        with pytest.raises(kernels.KernelError):
            cuda_ops.madd_multi(g1p, tuple(t[:, 0] for t in q3), skip3, mode=mode)
    # G2 Pippenger (512 points take the bucket route) raises too: no ladder
    # and no twin stands in for the missing kernels
    inf = torch.zeros(512, dtype=torch.bool, device=dev)
    g = tuple(t.to(dev) for t in g2_generator_device(512))
    with pytest.raises(kernels.KernelError):
        msm_g2((g[0], g[1], inf), FR.one((512,), dev))


def test_streamed_witness_and_chunked_division_on_the_card(dev, monkeypatch):
    """2^12 coefficients with msm_chunk_log = 10 and div_chunk_log = 8: the
    streamed witness (chunks of 2^8, one fr_horner call and one MSM each)
    equals the one-shot witness in affine; the chunked division
    (`_div_by_linear_big`, n one above a multiple of the chunk, x = 0 too)
    equals the one-shot division word for word, and so does the chunked
    MSM the one-shot MSM."""
    from kzg_tpu_torch.kzg import setup
    from kzg_tpu_torch.kzg.coeff_form import KZGProver, g1_compressed
    from kzg_tpu_torch.poly import Polynomial
    from kzg_tpu_torch.poly.polynomial import _div_by_linear, _div_by_linear_big

    n = 1 << 12
    rs = np.random.default_rng(12)
    coeffs = [int.from_bytes(rs.bytes(32), "little") % R for _ in range(n)]
    x = int.from_bytes(rs.bytes(32), "little") % R
    y = sum(c * pow(x, i, R) for i, c in enumerate(coeffs)) % R
    params = setup(0xBEEF, n)
    prover = KZGProver(params)
    poly = Polynomial.from_ints(coeffs)
    one_shot = prover.create_witness(poly, (x, y))
    base = config.get_config()
    monkeypatch.setattr(config, "_config",
                        dataclasses.replace(base, msm_chunk_log=10, div_chunk_log=8))
    kernels.reset_launches()
    streamed = prover.create_witness(poly, (x, y))
    assert kernels.launch_counts()["fr_horner"] >= 16
    assert g1_compressed(streamed) == g1_compressed(one_shot)
    chunked = msm_g1(params.gs, poly.trimmed())
    monkeypatch.setattr(config, "_config", base)
    assert g1_compressed(chunked) == g1_compressed(msm_g1(params.gs, poly.trimmed()))
    f = poly.trimmed()
    for m, pt in ((n, x), (n - 255, x), (n, 0)):
        ptw = torch.from_numpy(FR.encode([pt])).to(dev)
        assert _equal(_div_by_linear_big(f[:, :m], ptw, 8), _div_by_linear(f[:, :m], ptw))


def test_device_pairing_and_engine_on_the_card(dev):
    """pairing_device on two random pairs equals the oracle's pairing; the
    device engine's verdicts equal the host engine's on a 2^8 proof, true
    and tampered, single and batched (k = 3), and on the evaluation form's
    all-points check at d = 2^8."""
    from kzg_tpu_torch.curve import g1_to_device, g2_to_device
    from kzg_tpu_torch.kzg import setup
    from kzg_tpu_torch.kzg.coeff_form import KZGProver, KZGVerifier
    from kzg_tpu_torch.kzg.eval_form import (
        KZGBatchWitnessEvalForm, KZGProverEvalForm, KZGVerifierEvalForm, compute_lagrange_basis,
    )
    from kzg_tpu_torch.oracle import g1_generator, g2_generator, pairing
    from kzg_tpu_torch.pairing import pairing_device, tower
    from kzg_tpu_torch.poly import Polynomial

    rs = np.random.default_rng(2)
    ps = [native.g1_mul(g1_generator(), int.from_bytes(rs.bytes(32), "little") % R)
          for _ in range(2)]
    qs = [native.g2_mul(g2_generator(), int.from_bytes(rs.bytes(32), "little") % R)
          for _ in range(2)]
    p_aff, q_aff = g1_to_device(ps)[:2], g2_to_device(qs)[:2]
    got = pairing_device(p_aff, q_aff)
    assert [tower.f12_to_oracle(got[..., i]) for i in range(2)] == [
        pairing(p, q) for p, q in zip(ps, qs)]
    n = 1 << 8
    coeffs = [int.from_bytes(rs.bytes(32), "little") % R for _ in range(n)]
    xs = [int.from_bytes(rs.bytes(32), "little") % R for _ in range(3)]
    ys = [sum(c * pow(t, i, R) for i, c in enumerate(coeffs)) % R for t in xs]
    params = setup(0xFACE, n)
    prover = KZGProver(params)
    poly = Polynomial.from_ints(coeffs)
    c = prover.commit(poly)
    w = prover.create_witness(poly, (xs[0], ys[0]))
    bw = prover.create_witness_batched(poly, xs, ys)
    host, device = KZGVerifier(params, engine="host"), KZGVerifier(params, engine="device")
    for y in (ys[0], (ys[0] + 1) % R):
        assert device.verify_eval((xs[0], y), c, w) == host.verify_eval((xs[0], y), c, w)
    for pts in (xs, [xs[0], xs[1], (xs[2] + 1) % R]):
        assert device.verify_eval_batched(c, bw, pts) == host.verify_eval_batched(c, bw, pts)
    assert device.verify_eval((xs[0], ys[0]), c, w) and device.verify_eval_batched(c, bw, xs)
    # the evaluation form's all-points check: the identity witness puts both
    # G1 points of a true claim at infinity, no lane of the product finite
    lag = compute_lagrange_basis(params, 8)
    evals = torch.from_numpy(FR.encode(coeffs)).to(dev)
    tampered = evals.clone()
    tampered[:, 7] = evals[:, 8]
    ec = KZGProverEvalForm(params, lag).commit(evals)
    ew = KZGProverEvalForm(params, lag).create_witness_all()
    e_host = KZGVerifierEvalForm(params, lag, engine="host")
    e_device = KZGVerifierEvalForm(params, lag, engine="device")
    for r in (evals, tampered):
        bw_all = KZGBatchWitnessEvalForm(r=r, w=ew)
        assert e_device.verify_eval_all(ec, bw_all) == e_host.verify_eval_all(ec, bw_all)
    assert e_device.verify_eval_all(ec, KZGBatchWitnessEvalForm(r=evals, w=ew))
    assert not e_device.verify_eval_all(ec, KZGBatchWitnessEvalForm(r=tampered, w=ew))


def _pairs(dev, n, seed, inf_lane=None):
    """n random (P, Q) pairs as affine words, lane inf_lane with P (odd n)
    or Q (even n) at infinity, and the lanes to skip."""
    from kzg_tpu_torch.curve import g1_to_device, g2_to_device
    from kzg_tpu_torch.oracle import g1_generator, g2_generator

    rs = np.random.default_rng(seed)
    ps = [native.g1_mul(g1_generator(), int.from_bytes(rs.bytes(32), "little") % R)
          for _ in range(n)]
    qs = [native.g2_mul(g2_generator(), int.from_bytes(rs.bytes(32), "little") % R)
          for _ in range(n)]
    if inf_lane is not None:
        (ps if n % 2 else qs)[inf_lane] = None
    xp, yp, zp = g1_to_device(ps, dev)
    xq, yq, zq = g2_to_device(qs, dev)
    skip = (zp == 0).all(dim=0) | (zq == 0).all(dim=0).all(dim=0)
    return (xp, yp), (xq, yq), skip


@pytest.mark.parametrize("n,inf_lane", [(1, None), (1, 0), (2, 1), (5, 3)])
def test_pairing_kernels_match_plain(dev, n, inf_lane):
    """The miller_loop kernel and the final_exp kernel in lane and product
    mode against their plain versions (the tower code over K1 and
    field_pow) word for word, one launch each, a lane at infinity giving
    Fp12 one."""
    from kzg_tpu_torch.pairing import pairing as pm
    from kzg_tpu_torch.pairing import tower as tw

    p_aff, q_aff, skip = _pairs(dev, n, 60 + n, inf_lane)
    kernels.reset_launches()
    f = pm.miller_loop_device(p_aff, q_aff, skip)
    lanes = pm.final_exp_device(f)
    prod = pm.final_exp_product(f, skip)
    counts = kernels.launch_counts()
    assert counts["miller_loop"] == 1 and counts["final_exp"] == 2
    want = tw.f12_select(~skip, pm.miller_loop_plain(p_aff, q_aff), tw.f12_one((n,), dev))
    assert _equal(f, want)
    assert tw.f12_is_one(f).tolist() == skip.tolist()
    assert _equal(lanes, pm.final_exp_plain(f))
    assert _equal(prod, pm.final_exp_plain(pm._product_plain(f, skip)))


@pytest.mark.parametrize("inf", [False, True], ids=["finite", "lane-at-infinity"])
def test_pairing_check_verdicts_match_host(dev, inf):
    """pairing_check_device on e(a P, Q) e(-P, a Q) (times e(O, Q') where a
    lane is at infinity), honest and with a + 1 in the second factor, gives
    the host engine's verdicts."""
    from kzg_tpu_torch import hostcrypto
    from kzg_tpu_torch.oracle import ec_neg, g1_generator, g2_generator
    from kzg_tpu_torch.pairing import pairing_check_device

    rs = np.random.default_rng(90 + inf)
    k1, k2, k3, a = (int.from_bytes(rs.bytes(32), "little") % R for _ in range(4))
    p, q = native.g1_mul(g1_generator(), k1), native.g2_mul(g2_generator(), k2)
    verdicts = []
    for b in (a, (a + 1) % R):
        pairs = [(native.g1_mul(p, a), q), (ec_neg(p), native.g2_mul(q, b))]
        if inf:
            pairs.append((None, native.g2_mul(g2_generator(), k3)))
        (xp, yp), (xq, yq), skip = _pairs_of(dev, pairs)
        got = pairing_check_device((xp, yp, skip), (xq, yq, torch.zeros_like(skip)))
        assert got == hostcrypto.multi_pairing_check(pairs)
        verdicts.append(got)
    assert verdicts == [True, False]


def _pairs_of(dev, pairs):
    """Oracle (P, Q) pairs -> affine words and the lanes with P at infinity."""
    from kzg_tpu_torch.curve import g1_to_device, g2_to_device

    xp, yp, zp = g1_to_device([p for p, _ in pairs], dev)
    xq, yq, _ = g2_to_device([q for _, q in pairs], dev)
    return (xp, yp), (xq, yq), (zp == 0).all(dim=0)


def test_pairing_kernels_never_fall_back(dev, monkeypatch):
    """On CUDA tensors the pairing's entry points reach the kernels or
    raise: a failed build raises KernelError, no tower code runs."""
    from kzg_tpu_torch.pairing import pairing as pm

    def failed_build():
        raise kernels.KernelError("build failed")

    def plain(*args):
        raise AssertionError("a plain version ran on a CUDA tensor")

    p_aff, q_aff, skip = _pairs(dev, 2, 3)
    monkeypatch.setattr(kernels, "_lib", None)
    monkeypatch.setattr(kernels, "build", failed_build)
    monkeypatch.setattr(pm, "miller_loop_plain", plain)
    monkeypatch.setattr(pm, "final_exp_plain", plain)
    f = torch.zeros((12, 12, 2), dtype=torch.int32, device=dev)
    with pytest.raises(kernels.KernelError):
        pm.miller_loop_device(p_aff, q_aff, skip)
    with pytest.raises(kernels.KernelError):
        pm.final_exp_device(f)
    with pytest.raises(kernels.KernelError):
        pm.final_exp_product(f, skip)
    with pytest.raises(kernels.KernelError):
        pm.pairing_check_device(p_aff + (skip,), q_aff + (skip,))


@pytest.mark.parametrize("n", [1, 3, 17])
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_msm_small_on_the_ladder(dev, group, n):
    """Below small_msm_threshold points the MSM runs the digit ladder (one
    ladder launch, no K2 dbl) and equals the native engine's, a zero scalar
    and a point at infinity among the points."""
    if group == "g1":
        pts, msm_fn, from_dev, native_msm = _points(dev, n, 70 + n)[0], msm_g1, g1_from_device, \
            native.g1_msm
        plain = cuda_ops.PLAIN
    else:
        pts, msm_fn, from_dev, native_msm = _g2_points(dev, n, 70 + n), msm_g2, g2_from_device, \
            native.g2_msm
        plain = cuda_ops.PLAIN2
    x, y, inf = plain.to_affine(pts)
    if n > 1:
        inf[n // 3] = True
    host = from_dev((x, y, inf))
    scal = _ints(71 + n, R, n) if n > 3 else [int(v) for v in np.random.default_rng(n).integers(
        1, 1 << 62, n)]
    if n > 1:
        scal[n - 1] = 0
    kernels.reset_launches()
    got = msm_fn((x, y, inf), torch.from_numpy(FR.encode(scal)).to(dev))
    counts = kernels.launch_counts()
    assert counts[f"{group}_ladder"] == 1 and counts[f"{group}_dbl"] == 0
    assert from_dev(tuple(t[..., None] for t in got))[0] == native_msm(host, scal)


def test_device_verify_launches(dev):
    """One device verify_eval on a 2^4 proof: one miller_loop and one
    final_exp launch, x h and y g on the ladder kernel, at most 100 counted
    launches; the batched verify's h^Z and g^r on the ladder kernel with at
    most 60 K2 launches on either engine."""
    from kzg_tpu_torch.kzg import setup
    from kzg_tpu_torch.kzg.coeff_form import KZGProver, KZGVerifier
    from kzg_tpu_torch.poly import Polynomial

    rs = np.random.default_rng(17)
    coeffs = [int.from_bytes(rs.bytes(32), "little") % R for _ in range(16)]
    xs = [int.from_bytes(rs.bytes(32), "little") % R for _ in range(16)]
    ys = [sum(c * pow(t, i, R) for i, c in enumerate(coeffs)) % R for t in xs]
    params = setup(0xBEEF, 32)
    prover = KZGProver(params)
    poly = Polynomial.from_ints(coeffs)
    c = prover.commit(poly)
    w = prover.create_witness(poly, (xs[0], ys[0]))
    bw = prover.create_witness_batched(poly, xs, ys)
    k2 = ("g1_add", "g1_dbl", "g2_add", "g2_dbl")
    for engine in ("host", "device"):
        v = KZGVerifier(params, engine=engine)
        kernels.reset_launches()
        assert v.verify_eval((xs[0], ys[0]), c, w)
        counts = kernels.launch_counts()
        if engine == "device":
            assert counts["miller_loop"] == 1 and counts["final_exp"] == 1
            assert counts["g1_ladder"] == 1 and counts["g2_ladder"] == 1
            assert sum(counts.values()) <= 100, counts
        kernels.reset_launches()
        assert v.verify_eval_batched(c, bw, xs)
        counts = kernels.launch_counts()
        assert counts["g1_ladder"] >= 1 and counts["g2_ladder"] >= 1
        assert sum(counts[k] for k in k2) <= 60, counts
        assert counts["miller_loop"] == (engine == "device")


def _span_tree(prof):
    """(name, parent) of every program span of a profiler session, in the
    order they opened; the parent is the innermost span holding it."""
    evs = sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                  for e in prof.profiler.kineto_results.events()
                  if e.is_user_annotation() and e.device_type().name == "CPU"),
                 key=lambda t: (t[1], -t[2]))
    out = []
    for i, (name, s, e) in enumerate(evs):
        holders = [h for h in evs[:i] if h[1] <= s and e <= h[2]]
        out.append((name, min(holders, key=lambda h: h[2] - h[1])[0] if holders else None))
    return out, evs


def test_program_spans_on_the_card(dev):
    """A 2^15 commit (the K3 route), evaluation, witness and device
    `verify_eval` under torch.profiler: the spans of `kzg_tpu_torch.trace`
    nest as it lists them, the outputs equal an untraced run's, and the
    host waits for the device (`cudaStreamSynchronize`) inside each MSM at
    least at `split_runs`' three syncs and inside the verify at its verdict."""
    from torch.profiler import ProfilerActivity, profile

    from kzg_tpu_torch import trace
    from kzg_tpu_torch.kzg.coeff_form import KZGProver, KZGVerifier
    from kzg_tpu_torch.kzg.srs import setup_device
    from kzg_tpu_torch.poly import Polynomial

    n = 1 << 15
    params = setup_device(0x5EED, n, g2_count=2, device=dev)
    rs = np.random.default_rng(29)
    poly = Polynomial.from_ints([int.from_bytes(rs.bytes(32), "little") % R for _ in range(n)],
                                device=dev)
    prover, verifier = KZGProver(params), KZGVerifier(params, engine="device")
    x = int.from_bytes(rs.bytes(32), "little") % R

    def job():
        c = prover.commit(poly)
        y = poly.eval(x)
        w = prover.create_witness(poly, (x, y), check=False)
        return c, w, verifier.verify_eval((x, y), c, w)

    plain = job()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        traced = job()
        torch.cuda.synchronize()
    assert plain[2] and traced[2]
    assert _equal(plain[0], traced[0]) and _equal(plain[1], traced[1])
    msm = [("msm.digits", "msm"), ("msm.split", "msm"), ("msm.accumulate", "msm"),
           ("msm.combine", "msm"), ("msm.bucket_sum", "msm"), ("msm.window_join", "msm")]
    tree, evs = _span_tree(prof)
    assert tree == [("kzg.commit", None), ("msm", "kzg.commit"), *msm, ("poly.eval", None),
                    ("kzg.witness", None), ("poly.divide", "kzg.witness"),
                    ("msm", "kzg.witness"), *msm, ("kzg.verify_eval", None),
                    ("verify.xh", "kzg.verify_eval"), ("verify.yg", "kzg.verify_eval"),
                    ("verify.to_affine", "kzg.verify_eval"),
                    ("pairing.miller_loop", "kzg.verify_eval"),
                    ("pairing.final_exp", "kzg.verify_eval"),
                    ("pairing.read", "kzg.verify_eval")]
    assert {name for name, _ in tree} <= set(trace.SPANS)
    waits = [e.start_ns() for e in prof.profiler.kineto_results.events()
             if e.name() == "cudaStreamSynchronize"]
    for name, least in (("msm", 3), ("kzg.verify_eval", 1)):
        for _, lo, hi in (t for t in evs if t[0] == name):
            assert sum(lo <= w < hi for w in waits) >= least, name


# ---- the sharded layer (parallel/) at world 1 on NCCL ---------------------------------------

SHARDED_EXP = 10


@pytest.fixture(scope="module")
def nccl_mesh(tmp_path_factory):
    """A one-rank NCCL process group in this process and its 1-D mesh."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.distributed as dist
    from kzg_tpu_torch import parallel

    store = tmp_path_factory.mktemp("nccl") / "store"
    parallel.initialize_distributed(backend="nccl", init_method=f"file://{store}",
                                    world_size=1, rank=0)
    yield parallel.make_mesh()
    dist.destroy_process_group()


def _fr_dev(seed, n, dev):
    return torch.from_numpy(FR.encode(_ints(seed, R, n))).to(dev)


def _affine(jac):
    return g1_from_device(tuple(t[..., None] for t in jac))[0]


def test_sharded_domain_world_one(dev, nccl_mesh):
    from kzg_tpu_torch.parallel import ShardedDomain

    sd = ShardedDomain(nccl_mesh, "shard", SHARDED_EXP)
    dom = Domain(SHARDED_EXP)
    x = _fr_dev(40, 1 << SHARDED_EXP, dev)
    for name in ("ntt", "intt", "coset_ntt", "coset_intt", "ntt_t", "coset_ntt_t"):
        assert torch.equal(getattr(sd, name)(sd.shard(x)),
                           getattr(dom, name.removesuffix("_t"))(x)), name
    assert torch.equal(sd.intt_t(dom.ntt(x)), x)
    assert torch.equal(sd.coset_intt_t(dom.coset_ntt(x)), x)


def test_sharded_msm_world_one(dev, nccl_mesh):
    from kzg_tpu_torch.kzg.srs import setup_device
    from kzg_tpu_torch.parallel import make_sharded_msm, pad_msm_inputs

    params = setup_device(41, 1000, device=dev)
    for curve, pts, conv in ((G1, params.gs, g1_from_device), (G2, params.hs, g2_from_device)):
        s = _fr_dev(42, 1000, dev)
        run = make_sharded_msm(nccl_mesh, "shard", curve)
        padded, sp = pad_msm_inputs(curve, pts, s, 1)
        got = run(tuple(run.shard(t) for t in padded), run.shard(sp))
        want = pippenger.msm(curve, pts, s)
        assert conv(tuple(t[..., None] for t in got)) == conv(tuple(t[..., None] for t in want))


def test_sharded_steps_world_one(dev, nccl_mesh):
    from kzg_tpu_torch.kzg import KZGBatchWitness, KZGProver, KZGVerifier
    from kzg_tpu_torch.kzg.eval_form import (
        KZGProverEvalForm, compute_lagrange_basis_from_secret,
    )
    from kzg_tpu_torch.kzg.srs import setup_device
    from kzg_tpu_torch.parallel import (
        make_batched_witness_step, make_commit_witness_step, make_eval_form_step,
    )
    from kzg_tpu_torch.poly import Polynomial

    n, k, secret = 1 << SHARDED_EXP, 8, 43
    params = setup_device(secret, n, g2_count=k + 1, device=dev)
    prover = KZGProver(params)
    f = Polynomial(_fr_dev(44, n, dev))
    x = _ints(45, R, 4)[3]
    step = make_commit_witness_step(nccl_mesh, "shard", SHARDED_EXP)
    commit, y, wit = step(*params.gs, f.coeffs, torch.from_numpy(FR.encode([x])).to(dev))
    assert FR.decode(y) == [f.eval(x)]
    assert _affine(commit) == _affine(prover.commit(f))
    assert _affine(wit) == _affine(prover.create_witness(f, (x, FR.decode(y)[0])))

    xs = _ints(46, R, k + 3)[3:]
    step = make_batched_witness_step(nccl_mesh, "shard", SHARDED_EXP, k)
    commit, ys, r, wit = step(*params.gs, f.coeffs, torch.from_numpy(FR.encode(xs)).to(dev))
    want = prover.create_witness_batched(f, xs, FR.decode(ys))
    assert torch.equal(r, want.r.trimmed()) and _affine(wit) == _affine(want.w)
    assert KZGVerifier(params).verify_eval_batched(
        commit, KZGBatchWitness(r=Polynomial(r, k - 1), w=wit), xs)

    lag = compute_lagrange_basis_from_secret(secret, SHARDED_EXP, device=dev)
    eprover = KZGProverEvalForm(params, lag)
    evals = _fr_dev(47, n, dev)
    for m in (3, n - 2):
        commit, y, wit = make_eval_form_step(nccl_mesh, "shard", SHARDED_EXP, m)(*lag.lg, evals)
        assert torch.equal(y, evals[:, m:m + 1])
        assert _affine(commit) == _affine(eprover.commit(evals))
        assert _affine(wit) == _affine(eprover.create_witness(evals, m))


# ---- PeerDAS cells and FK20 proofs (kzg/das.py) at the published widths --------------------

DAS_SECRET = 0x5EED_DA5


@pytest.fixture(scope="module")
def das_card():
    """The cell prover over an SRS of 4096 G1 and 65 G2 powers on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from kzg_tpu_torch.kzg.das import DAS
    from kzg_tpu_torch.kzg.srs import setup_device

    params = setup_device(DAS_SECRET, 4096, g2_count=65, device=torch.device("cuda", 0))
    return DAS(params)


def _das_blobs(seed, count, dev):
    """count blobs of 4096 field elements (host ints) and their (8, B, 4096) words."""
    rs = np.random.default_rng(seed)
    values = [[int.from_bytes(rs.bytes(32), "little") % R for _ in range(4096)]
              for _ in range(count)]
    return values, torch.from_numpy(FR.encode(sum(values, []))).reshape(8, count, 4096).to(dev)


def test_das_one_blob_equals_the_reference(dev, das_card):
    """One full blob: its 128 cells and 128 proofs equal the plain
    reference's (the spec's FFTs; ((f(s) - I_k(s)) / (s^64 - h_k^64)) G),
    byte for byte."""
    from kzg_tpu_torch.compat.serialize import g1_compress
    from kzgbench.reference import das as ref
    from kzgbench.reference.bls import g1_compress as ref_compress

    values, blobs = _das_blobs(70, 1, dev)
    cells, proofs = das_card.compute_cells_and_kzg_proofs(blobs)
    ext, q = ref.Cells(DAS_SECRET, 4096, 64).blob(values[0])
    assert torch.equal(cells[:, 0].cpu(), ref.mont_words(ext, "cpu").reshape(8, 128, 64))
    g = ref.FixedBase()
    got = [g1_compress(p) for p in g1_from_device(tuple(t[:, 0] for t in proofs))]
    assert got == [ref_compress(g.mul(k)) for k in q]
    assert torch.equal(das_card.compute_cells(blobs), cells)


def test_das_launches_do_not_grow_with_the_blobs(dev, das_card):
    """A call on 9 blobs launches the same kernels, as many times, as a call
    on one; its first blob's outputs equal the one-blob call's."""
    _, blobs = _das_blobs(71, 9, dev)
    das_card.compute_cells_and_kzg_proofs(blobs[:, :1])  # the table, built once
    counts = []
    outs = []
    for b in (blobs[:, :1], blobs):
        kernels.reset_launches()
        outs.append(das_card.compute_cells_and_kzg_proofs(b.contiguous()))
        torch.cuda.synchronize()
        counts.append(kernels.launch_counts())
    assert counts[0] == counts[1] and sum(counts[0].values()) > 0
    assert counts[0]["g1_fk20_comb"] == 1
    (c1, p1), (c9, p9) = outs
    assert torch.equal(c1[:, 0], c9[:, 0])
    assert all(torch.equal(a[:, 0], b[:, 0]) for a, b in zip(p1, p9))


def test_das_verify_on_the_card(dev, das_card, monkeypatch):
    """verify_cell_kzg_proof_batch on the device engine accepts one blob's
    128 cells (shuffled) and one 9-cell column of a block, and rejects each
    with one cell value + 1."""
    from kzg_tpu_torch.msm import msm_g1

    monkeypatch.setattr(config, "_config",
                        dataclasses.replace(config.get_config(), pairing_engine="device"))

    _, blobs = _das_blobs(72, 9, dev)
    cells, proofs = das_card.compute_cells_and_kzg_proofs(blobs)
    coeffs, _ = das_card._extend(blobs)
    gs = das_card.params.gs
    coms = [msm_g1(gs, coeffs[:, b].contiguous()) for b in range(9)]

    def stack(points):
        return tuple(torch.stack([p[i] for p in points], dim=-1) for i in range(3))

    def bump(c, lane):
        c = c.clone()
        c[:, lane, 7:8] = FR.add(c[:, lane, 7:8], FR.one((1,), dev))
        return c

    order = torch.randperm(128, generator=torch.Generator().manual_seed(3)).tolist()
    one = (stack([coms[0]] * 128), order, cells[:, 0, order].contiguous(),
           tuple(t[:, 0, order] for t in proofs))
    col = (stack(coms), [5] * 9, cells[:, :, 5].contiguous(), tuple(t[:, :, 5] for t in proofs))
    for com, idx, c, p in (one, col):
        assert das_card.verify_cell_kzg_proof_batch(com, idx, c, p)
        assert not das_card.verify_cell_kzg_proof_batch(com, idx, bump(c, 3), p)


# ---- the fixed-base comb (FK20's MSM) -------------------------------------------------------


def test_fk20_comb_at_fk20s_shape(dev, das_card):
    """The comb kernel on the prover's own table (8,192 points) over 9 x 128
    x 64 lanes of random scalars equals its twin word for word, in one
    launch."""
    from kzg_tpu_torch.bench import comb as cbench

    rows, p_inf = das_card.fk20_table
    assert rows.shape == (64, 8192, 15, 24) and rows.numel() * 4 <= 800e6
    gen = torch.Generator(device=dev).manual_seed(21)
    scalars = cbench.random_scalars((9, 128, 64), gen)
    kernels.reset_launches()
    got = cuda_ops.fk20_comb(rows, p_inf, scalars)
    assert kernels.launch_counts()["g1_fk20_comb"] == 1
    assert _equal(got, cuda_ops.fk20_comb_plain(rows, p_inf, scalars))


def test_fk20_comb_edge_cases(dev):
    """A comb table made on the card (K2) from four points at random Z, the
    last infinite: the kernel equals its twin word for word on the scalars
    of `bench.comb.EDGE_SCALARS` (P == Q and P == -Q at the last window
    among them) and random ones, and the ladder's products and the oracle
    in affine form."""
    from kzg_tpu_torch.bench import comb as cbench
    from kzg_tpu_torch.oracle import ec_mul

    base, pts, scalars = cbench.edge_case(dev)
    table = pippenger.comb_table(base)
    got = cuda_ops.fk20_comb(*table, scalars)
    assert _equal(got, cuda_ops.fk20_comb_plain(*table, scalars))
    shape = tuple(scalars.shape[1:])
    tx, ty, p_inf = G1.ladder_table(base, 4)
    digits = pippenger._std_digits_msb(scalars.reshape(8, -1), 4, 64).reshape((64,) + shape)
    ladder = cuda_ops.ladder(tx.unsqueeze(2).expand(tx.shape[:2] + shape),
                             ty.unsqueeze(2).expand(ty.shape[:2] + shape), p_inf.expand(shape),
                             digits, 4)
    assert g1_from_device(tuple(t.reshape(12, -1) for t in got)) == g1_from_device(
        tuple(t.reshape(12, -1) for t in ladder))
    words = scalars.reshape(8, -1).cpu().to(torch.int64) & 0xFFFFFFFF
    ks = [sum(int(words[k, i]) << (32 * k) for k in range(8)) for i in range(words.shape[1])]
    want = [None if pts[i % 4] is None or k % R == 0 else ec_mul(pts[i % 4], k % R)
            for i, k in enumerate(ks)]
    assert g1_from_device(tuple(t.reshape(12, -1) for t in got)) == want
