"""The pairing kernels' programs and the digit ladders of the device verify,
on the CPU:

  * every program of `kzg_tpu_torch/pairing/schedule.py` (the programs
    `csrc/pairing.cuh` runs: the Miller loop's untwist, tangent and chord
    steps with the in-kernel inverse and conjugation; the final
    exponentiation's product, easy part, subset table, cyclotomic squaring
    and joint-ladder step; and standalone programs of f12_mul, f12_sqr,
    f12_inv, f12_conj, the Frobenius and the cyclotomic squaring), run on
    Python integers as the kernels run them, equals `pairing/tower.py` and
    the JAX package's `kzg_tpu.pairing.tower` word for word on random seeded
    elements;
  * the kernels' control flow (`simulate_miller`, `simulate_final_exp`,
    `simulate_product`) equals the oracle's Miller loop and final
    exponentiation, skipped lanes contributing 1, and the product tree;
  * the committed header equals `render()`; the bit columns recompose the
    hard exponent; the loop bits are the JAX loop's;
  * on CPU tensors the wrappers run the plain versions and never load the
    kernel library;
  * `_msm_small` on the digit ladder equals the oracle's sum of products at
    n = 1, 3 and 17 over G1 and G2, with a zero scalar and a point at
    infinity, and the JAX package's `msm` (G1 at n = 3; the other shapes
    under `slow`: its XLA compile takes 30-150 s a shape on a CPU);
  * the device engine's verdicts equal the host engine's, true and
    tampered, with the pairing's plain versions replaced by the kernels'
    programs on Python integers (the plain versions take ~80 s a check on a
    CPU; `tests/test_torch_pairing.py` runs them under `slow`).

Tolerance 0: exact integer arithmetic. Elements and scalars from numpy
seeds. The kernels themselves run on the card in `tests/test_torch_cuda.py`
and `chip_smoke.py`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kzg_tpu.constants import BLS_X as JAX_BLS_X
from kzg_tpu.pairing import pairing as jpm
from kzg_tpu.pairing import tower as jtw
from kzg_tpu_torch import config, kernels, native
from kzg_tpu_torch.constants import P, R
from kzg_tpu_torch.curve import (
    g1_from_device, g1_to_device, g2_from_device, g2_to_device,
)
from kzg_tpu_torch.fields import FR
from kzg_tpu_torch.fields.limb import unpack16
from kzg_tpu_torch.msm import msm_g1, msm_g2
from kzg_tpu_torch.oracle import ec_add, ec_mul, g1_generator, g2_generator
from kzg_tpu_torch.oracle.curve import final_exponentiation, miller_loop
from kzg_tpu_torch.oracle.field import Fp, Fp2, Fp6, Fp12
from kzg_tpu_torch.pairing import pairing as pm
from kzg_tpu_torch.pairing import schedule as S
from kzg_tpu_torch.pairing import tower as tw


@pytest.fixture(scope="module", autouse=True)
def _cpu_device():
    """The port's plain versions on the CPU, one intra-op thread (the twins
    run many tiny ops)."""
    old, threads = config.get_config(), torch.get_num_threads()
    config.configure(device="cpu")
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    config.set_config(old)


# ---- conversions: lanes of 12 Montgomery ints <-> (12, 12, k) words ------------------------


def _words(lanes):
    """Lanes of 12 Montgomery ints -> (12, 12, k) int32 words."""
    out = np.zeros((12, 12, len(lanes)), dtype=np.int64)
    for i, lane in enumerate(lanes):
        for k, v in enumerate(lane):
            for w in range(12):
                out[w, k, i] = (v >> (32 * w)) & 0xFFFFFFFF
    return torch.from_numpy(out.astype(np.uint32).view(np.int32))


def _lanes(t):
    """(12, 12, k) words -> lanes of 12 Montgomery ints."""
    a = t.numpy().astype(np.int64) & 0xFFFFFFFF
    return [[sum(int(a[w, k, i]) << (32 * w) for w in range(12)) for k in range(12)]
            for i in range(a.shape[2])]


def _jax(x):
    return jnp.asarray(unpack16(x).numpy().astype(np.uint32))


def _from_jax(x):
    """JAX (24, 12, k) 16-bit limbs -> lanes of 12 Montgomery ints."""
    a = np.asarray(x).astype(np.int64)
    return [[sum(int(a[l, k, i]) << (16 * l) for l in range(a.shape[0])) for k in range(12)]
            for i in range(a.shape[2])]


def _rand_lanes(seed, k=2):
    rs = np.random.default_rng(seed)
    return [[S.mont(int.from_bytes(rs.bytes(48), "little") % P) for _ in range(12)]
            for _ in range(k)]


def _oracle12(lane):
    v = [S.unmont(x) for x in lane]
    f2 = [Fp2(Fp(v[2 * i]), Fp(v[2 * i + 1])) for i in range(6)]
    return Fp12(Fp6(*f2[:3]), Fp6(*f2[3:]))


def _lane_of(o):
    return [S.mont(v) for v in S._f12_ints(o)]


def _cyclotomic_lanes(seed):
    """The easy part of the final exponentiation by the oracle: elements of
    the cyclotomic subgroup."""
    out = []
    for lane in _rand_lanes(seed):
        e = _oracle12(lane)
        e = e.conj() * e.inv()
        out.append(_lane_of(e.frobenius().frobenius() * e))
    return out


# ---- the tower's programs --------------------------------------------------------------------

TOWER = {
    # name: (traced fn, arity, port fn, JAX fn, operands: "random" or "cyclotomic")
    "f12_mul": (S.f12_mul, 2, tw.f12_mul, jtw.f12_mul, "random"),
    "f12_sqr": (S.f12_sqr, 1, tw.f12_sqr, jtw.f12_sqr, "random"),
    "f12_inv": (S.f12_inv, 1, tw.f12_inv, jtw.f12_inv, "random"),
    "f12_conj": (S.f12_conj, 1, tw.f12_conj, jtw.f12_conj, "random"),
    "f12_frobenius": (S.f12_frobenius, 1, tw.f12_frobenius, jtw.f12_frobenius, "random"),
    "f12_cyclotomic_sqr": (S.f12_cyclotomic_sqr, 1, tw.f12_cyclotomic_sqr,
                           jtw.f12_cyclotomic_sqr, "cyclotomic"),
}


@pytest.mark.parametrize("name", list(TOWER))
def test_tower_program_matches_port_and_jax(name):
    fn, arity, port_fn, jax_fn, kind = TOWER[name]
    a = _cyclotomic_lanes(3) if kind == "cyclotomic" else _rand_lanes(3)
    b = _rand_lanes(4)
    prog = S.tower_program(fn, arity)
    got = [S.run_tower(prog, *ops[:arity]) for ops in zip(a, b)]
    xs = [_words(a), _words(b)][:arity]
    assert got == _lanes(port_fn(*xs))
    assert got == _from_jax(jax_fn(*[_jax(x) for x in xs]))


def test_fermat_chain_is_the_inverse():
    for v in (0, 1, 2, P - 1, 0x1234567890ABCDEF):
        want = 0 if v == 0 else pow(v, -1, P)
        assert S.unmont(S.fermat(S.mont(v))) == want


# ---- the kernels' programs ---------------------------------------------------------------


def _points(k, seed=77):
    rs = np.random.default_rng(seed)
    ps = [native.g1_mul(g1_generator(), int.from_bytes(rs.bytes(32), "little") % R)
          for _ in range(k)]
    qs = [native.g2_mul(g2_generator(), int.from_bytes(rs.bytes(32), "little") % R)
          for _ in range(k)]
    return ps, qs


@pytest.fixture(scope="module")
def miller_state():
    """One pair's Miller state after a tangent step of the port's plain
    version from a random f: f, T = 2Q, P embedded and Q, all untwisted
    E(Fp12) words, and P's affine words."""
    ps, qs = _points(1)
    xp, yp, _ = g1_to_device(ps, device="cpu")
    xq, yq, _ = g2_to_device(qs, device="cpu")
    q = pm.untwist_device(xq, yq)
    p = (pm._fp_to_f12(xp), pm._fp_to_f12(yp))
    f, t = pm._line_step(_words(_rand_lanes(9, 1)), q, p)
    return f, t, p, q, (xp, yp)


def _f12(t):
    return _lanes(t)[0]


def _fp(t):
    return _lanes(pm._fp_to_f12(t))[0][0]


@pytest.mark.parametrize("chord", [False, True], ids=["tangent", "chord"])
def test_miller_step_program_matches_port_and_jax(miller_state, chord):
    """One Miller step of the kernel's program (the inverse inside) against
    the port's `_line_step` and the JAX package's line functions."""
    f, t, p, q, (xp, yp) = miller_state
    k = S.miller_kernel()
    regions = {"F": _f12(f), "XT": _f12(t[0]), "YT": _f12(t[1]), "XP": [_fp(xp)],
               "YP": [_fp(yp)], "XQ": _f12(q[0]), "YQ": _f12(q[1])}
    mem = S.simulate_program(k, "chord" if chord else "tangent", regions)
    got = [S.region(k, mem, r) for r in ("F", "XT", "YT")]
    wf, (wx, wy) = pm._line_step(f, t, p, q if chord else None)
    assert got == [_f12(wf), _f12(wx), _f12(wy)]
    jf, jt, jp, jq = _jax(f), tuple(map(_jax, t)), tuple(map(_jax, p)), tuple(map(_jax, q))
    if chord:
        ell, lam = jpm._line_chord(jt, jq, jp)
        jf = jtw.f12_mul(jf, ell)
        jt = jpm._ec_add_with_lambda(jt, jq[0], lam)
    else:
        ell, lam = jpm._line_tangent(jt, jp)
        jf = jtw.f12_mul(jtw.f12_sqr(jf), ell)
        jt = jpm._ec_add_with_lambda(jt, jt[0], lam)
    assert got == [_from_jax(jf)[0], _from_jax(jt[0])[0], _from_jax(jt[1])[0]]


def test_miller_init_and_conj_programs():
    ps, qs = _points(1)
    xq, yq, _ = g2_to_device(qs, device="cpu")
    q = pm.untwist_device(xq, yq)
    k = S.miller_kernel()
    qin = [_lanes(pm._fp2_to_f12(c))[0][i] for c in (xq, yq) for i in range(2)]
    mem = S.simulate_program(k, "init", {"Q": qin})
    one = [S.mont(1)] + [0] * 11
    assert [S.region(k, mem, r) for r in ("XQ", "YQ", "XT", "YT", "F")] == [
        _f12(q[0]), _f12(q[1]), _f12(q[0]), _f12(q[1]), one]
    f = _rand_lanes(5, 1)
    mem = S.simulate_program(k, "conj", {"F": f[0]})
    assert S.region(k, mem, "F") == _lanes(tw.f12_conj(_words(f)))[0]


def test_final_exp_programs_match_port_and_jax():
    """The final exponentiation's programs: the product step, the easy part,
    the subset table of the Frobenius powers, the cyclotomic squaring and
    one joint-ladder step (squaring, then the table entry's product)."""
    k = S.final_kernel()
    a, x = _rand_lanes(6, 1)[0], _rand_lanes(7, 1)[0]
    mem = S.simulate_program(k, "mul", {"ACC": a, "X": x})
    assert S.region(k, mem, "ACC") == _f12(tw.f12_mul(_words([a]), _words([x])))
    mem = S.simulate_program(k, "easy", {"ACC": a})
    want = pm.final_exp_easy(_words([a]))
    assert S.region(k, mem, "T", 12) == _f12(want)
    ja = _jax(_words([a]))
    je = jtw.f12_mul(jtw.f12_conj(ja), jtw.f12_inv(ja))
    je = jtw.f12_mul(jtw.f12_frobenius(jtw.f12_frobenius(je)), je)
    assert S.region(k, mem, "T", 12) == _from_jax(je)[0]
    cyc = _cyclotomic_lanes(8)[0]
    mem = S.simulate_program(k, "table", {"T": cyc})
    fs = [_words([cyc])]
    for _ in range(3):
        fs.append(tw.f12_frobenius(fs[-1]))
    table = tw._subset_table(fs)
    got = S.region(k, mem, "T")
    assert [got[12 * (m - 1):12 * m] for m in range(1, 16)] == [
        _f12(table[m]) for m in range(1, 16)]
    mem = S.simulate_program(k, "cyc", {"ACC": cyc})
    assert S.region(k, mem, "ACC") == _f12(tw.f12_cyclotomic_sqr(_words([cyc])))
    mem = S.simulate_program(k, "cyc_mul", {"ACC": cyc, "X": x})
    want = tw.f12_mul(tw.f12_cyclotomic_sqr(_words([cyc])), _words([x]))
    assert S.region(k, mem, "ACC") == _f12(want)
    jw = jtw.f12_mul(jtw.f12_cyclotomic_sqr(_jax(_words([cyc]))), _jax(_words([x])))
    assert S.region(k, mem, "ACC") == _from_jax(jw)[0]


@pytest.mark.parametrize("skip", [[False, False, False], [False, True, False],
                                  [True, True, True]], ids=["all", "one-skipped", "none"])
def test_product_matches_the_tree(skip):
    """The final_exp kernel's product mode (a fold of the lanes not
    skipped) against the port's pairwise tree and the JAX tower's products."""
    lanes = _rand_lanes(11, 3)
    got = S.simulate_product(lanes, skip)
    want = pm._product_plain(_words(lanes), torch.tensor(skip))
    assert got == _lanes(want[..., None])[0]
    jprod = _jax(_words([[S.mont(1)] + [0] * 11]))
    for lane, sk in zip(lanes, skip):
        if not sk:
            jprod = jtw.f12_mul(jprod, _jax(_words([lane])))
    assert got == _from_jax(jprod)[0]


def test_simulated_kernels_match_oracle():
    """The Miller loop on two pairs and a skipped one, and the final
    exponentiation in lane and product mode, against the oracle."""
    ps, qs = _points(2, seed=21)
    fs = []
    for p, q in zip(ps, qs):
        fs.append(S.simulate_miller(S.mont(p[0].n), S.mont(p[1].n),
                                    (S.mont(q[0].a.n), S.mont(q[0].b.n)),
                                    (S.mont(q[1].a.n), S.mont(q[1].b.n))))
        assert _oracle12(fs[-1]) == miller_loop(p, q)
    skipped = S.simulate_miller(1, 1, (1, 0), (1, 0), skip=True)
    assert skipped == [S.mont(1)] + [0] * 11
    lanes = S.simulate_final_exp(fs, product=False)
    assert [_oracle12(e) for e in lanes] == [final_exponentiation(miller_loop(p, q))
                                             for p, q in zip(ps, qs)]
    prod = S.simulate_final_exp(fs + [fs[0]], skip=[False, False, True])
    assert _oracle12(prod) == final_exponentiation(_oracle12(fs[0]) * _oracle12(fs[1]))


# ---- constants and the header ------------------------------------------------------------


def test_header_is_rendered():
    assert S.HEADER.read_text() == S.render(), (
        "regenerate: python -m kzg_tpu_torch.pairing.schedule --write")


def test_hard_columns_recompose_the_exponent():
    cols = S.hard_columns()
    nbits = len(cols)
    digits = [sum(((c >> i) & 1) << (nbits - 1 - j) for j, c in enumerate(cols))
              for i in range(4)]
    assert digits == list(pm.HARD_BASE_P)
    assert sum(h * P ** i for i, h in enumerate(digits)) == (P ** 4 - P ** 2 + 1) // R
    assert cols[0] != 0 and all(0 <= c < 16 for c in cols)


def test_loop_bits_match_jax():
    n = -JAX_BLS_X
    jax_bits = tuple((n >> i) & 1 for i in range(n.bit_length() - 2, -1, -1))
    assert S.LOOP_BITS == pm.LOOP_BITS == jax_bits
    text = S.HEADER.read_text()
    assert f"kMillerLoop = 0x{n:x}ull" in text
    assert f"kMillerLoopBits = {n.bit_length()};" in text


def test_schedule_stages_are_safe():
    """Every stage of both kernels passes the collision checks, and the
    constants of the wrapper are the layout's."""
    for k in (S.miller_kernel(), S.final_kernel()):
        assert k.slots * 64 <= 48 * 1024  # static shared memory
        for prog in k.programs.values():
            for st in prog.stages:
                S._check_stage(st, 2 * k.warps)
    m, f, cols = pm.kernel_inputs("cpu")
    assert tuple(m.shape) == (12, len(S.miller_layout().consts))
    assert tuple(f.shape) == (12, len(S.final_layout().consts))
    assert cols.tolist() == S.hard_columns()


# ---- the wrappers on the CPU ------------------------------------------------------------


def test_cpu_wrappers_never_load_the_kernels(monkeypatch):
    """On CPU tensors miller_loop_device, final_exp_device, final_exp_product
    and pairing_check_device run the plain versions (stubbed here: they
    take ~80 s a check) and never build or load the kernel library; skipped
    lanes give Fp12 one."""
    def refuse(*args, **kwargs):
        raise AssertionError("the kernel library was loaded for a CPU tensor")

    monkeypatch.setattr(kernels, "library", refuse)
    monkeypatch.setattr(kernels, "build", refuse)
    calls = []

    def miller_stub(p_aff, q_aff):
        calls.append("miller")
        return _words(_rand_lanes(13, p_aff[0].shape[-1]))

    def final_stub(f):
        calls.append("final")
        return f

    monkeypatch.setattr(pm, "miller_loop_plain", miller_stub)
    monkeypatch.setattr(pm, "final_exp_plain", final_stub)
    ps, qs = _points(2)
    xp, yp, _ = g1_to_device(ps, device="cpu")
    xq, yq, _ = g2_to_device(qs, device="cpu")
    skip = torch.tensor([False, True])
    f = pm.miller_loop_device((xp, yp), (xq, yq), skip)
    assert tw.f12_is_one(f).tolist() == [False, True]
    assert torch.equal(pm.final_exp_device(f), f)
    assert torch.equal(pm.final_exp_product(f, skip), f[..., 0])
    assert not pm.pairing_check_device((xp, yp, skip), (xq, yq, torch.tensor([False, False])))
    assert calls == ["miller", "final", "final", "miller", "final"]
    before = kernels.launch_counts()
    assert before["miller_loop"] == before["final_exp"] == 0


# ---- the small MSM on the digit ladder ---------------------------------------------------


def _msm_case(g2, n, seed):
    rs = np.random.default_rng(seed)
    gen, mul = (g2_generator(), native.g2_mul) if g2 else (g1_generator(), native.g1_mul)
    pts = [mul(gen, int.from_bytes(rs.bytes(32), "little") % R) for _ in range(n)]
    scal = [int.from_bytes(rs.bytes(32), "little") % R for _ in range(n)]
    if n > 1:
        pts[n // 3] = None
        scal[n - 1 - n // 3] = 0
    return pts, scal


def _port_msm(g2, pts, scal):
    to_dev, from_dev, msm = ((g2_to_device, g2_from_device, msm_g2) if g2
                             else (g1_to_device, g1_from_device, msm_g1))
    x, y, z = to_dev(pts, device="cpu")
    inf = (z == 0).reshape(z.shape[0], -1, z.shape[-1]).all(dim=1).all(dim=0)
    s = torch.from_numpy(FR.encode(scal))
    return from_dev(tuple(t[..., None] for t in msm((x, y, inf), s)))[0]


@pytest.mark.parametrize("n", [1, 3, 17])
@pytest.mark.parametrize("g2", [False, True], ids=["G1", "G2"])
def test_msm_small_on_digits_matches_oracle(g2, n):
    pts, scal = _msm_case(g2, n, 100 + n)
    want = None
    for pt, k in zip(pts, scal):
        want = ec_add(want, ec_mul(pt, k))
    assert _port_msm(g2, pts, scal) == want


# G1 at n = 3 (~30 s, the XLA compile) runs in the fast tier; the rest under `slow`
JAX_MSM_CASES = [pytest.param(g2, n, id=f"{'G2' if g2 else 'G1'}-{n}",
                              marks=() if (g2, n) == (False, 3) else pytest.mark.slow)
                 for g2 in (False, True) for n in (1, 3, 17)]


@pytest.mark.parametrize("g2, n", JAX_MSM_CASES)
def test_msm_small_on_digits_matches_jax(g2, n):
    from kzg_tpu import curve as jcurve
    from kzg_tpu.fields import FR as JFR
    from kzg_tpu.msm import pippenger as jpip

    pts, scal = _msm_case(g2, n, 100 + n)
    to_dev = jcurve.g2_to_device if g2 else jcurve.g1_to_device
    from_dev = jcurve.g2_from_device if g2 else jcurve.g1_from_device
    x, y, z = to_dev(pts)
    inf = jnp.asarray([p is None for p in pts])
    out = (jpip.msm_g2 if g2 else jpip.msm_g1)((x, y, inf), JFR.encode(scal))
    assert _port_msm(g2, pts, scal) == from_dev(tuple(t[..., None] for t in out))[0]


# ---- the device engine's verdicts -------------------------------------------------------


def _simulated_miller(p_aff, q_aff):
    """The miller_loop kernel's program on Python integers, lane by lane."""
    xp, yp = (_lanes(pm._fp_to_f12(t)) for t in p_aff)
    xq, yq = (_lanes(pm._fp2_to_f12(t)) for t in q_aff)
    return _words([S.simulate_miller(a[0], b[0], (c[0], c[1]), (d[0], d[1]))
                   for a, b, c, d in zip(xp, yp, xq, yq)])


def _simulated_final(f):
    return _words(S.simulate_final_exp(_lanes(f.reshape(12, 12, -1)), product=False)).reshape(
        f.shape)


def test_device_engine_verdicts_match_host(monkeypatch):
    """verify_eval with engine="device" on the CPU (the digit ladders of x h
    and y g on their twins, the affine conversions, the check's lanes and
    masks) against the host engine on a 16-coefficient proof, true and
    tampered; the pairing's plain versions are replaced by the kernels'
    programs on Python integers."""
    from kzg_tpu_torch.kzg import setup
    from kzg_tpu_torch.kzg.coeff_form import KZGProver, KZGVerifier
    from kzg_tpu_torch.poly import Polynomial

    monkeypatch.setattr(pm, "miller_loop_plain", _simulated_miller)
    monkeypatch.setattr(pm, "final_exp_plain", _simulated_final)
    rs = np.random.default_rng(16)
    coeffs = [int.from_bytes(rs.bytes(32), "little") % R for _ in range(16)]
    x = int.from_bytes(rs.bytes(32), "little") % R
    y = sum(c * pow(x, i, R) for i, c in enumerate(coeffs)) % R
    params = setup(0xC0FFEE, 16)
    prover = KZGProver(params)
    poly = Polynomial.from_ints(coeffs)
    c, w = prover.commit(poly), prover.create_witness(poly, (x, y))
    host, dev = KZGVerifier(params, engine="host"), KZGVerifier(params, engine="device")
    for yy in (y, (y + 1) % R):
        assert dev.verify_eval((x, yy), c, w) == host.verify_eval((x, yy), c, w) == (yy == y)
