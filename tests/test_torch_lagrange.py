"""Lagrange-SRS construction in the port (kzg_tpu_torch.kzg.eval_form, plain
kernel twins on CPU): the digit extraction, the group iNTT, the host route
from the secret, the Lagrange polynomials and the `.npz` carry-across.
Tolerance 0.

  * `_std_digits_msb` / `_host_digits_msb` at c = 3, 4, 5 against the JAX
    package's functions (which read 16-bit limbs) and against host ints;
  * the trusted route `compute_lagrange_basis` (group iNTT over G1 and G2,
    digit ladders on add / dbl / madd) against the from-secret route and the
    oracle's g^{L_i(s)}, h^{L_i(s)}, `lg` and `lh` both; the split-table
    branch (`force_split`) against the dense one;
  * a LagrangeSRS saved by either package loads into the other word for
    word; `lagrange_polynomials` against host ints.
One group iNTT of d points runs log2(d) + 1 full 255-bit ladders, each ~7 s
(G1) or ~14 s (G2) on the plain twins, so tier 1 holds the trusted route at
d = 4; d = 8 and the JAX-compiled comparisons are `slow`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kzg_tpu.fields import FR as JFR
from kzg_tpu.kzg import eval_form as jef
from kzg_tpu_torch import config
from kzg_tpu_torch.constants import R
from kzg_tpu_torch.curve import G1, g1_from_device, g2_from_device
from kzg_tpu_torch.fields import FR
from kzg_tpu_torch.fields.limb import unpack16
from kzg_tpu_torch.kzg import (
    LagrangeSRS,
    PolynomialDegreeTooLarge,
    compute_lagrange_basis,
    compute_lagrange_basis_and_polynomials,
    compute_lagrange_basis_from_secret,
    lagrange_polynomials,
    setup,
)
from kzg_tpu_torch.kzg import eval_form as ef
from kzg_tpu_torch.ntt import Domain
from kzg_tpu_torch.oracle import ec_mul, g1_generator, g2_generator

SECRET = 69696969


@pytest.fixture(scope="module", autouse=True)
def _cpu_device():
    """The port places tensors on the card by default; these tests run its
    plain twins, so they ask for the CPU. The twins' ops are tiny, so one
    intra-op thread is as fast as many and several test processes side by
    side do not fight over the cores."""
    old, threads = config.get_config(), torch.get_num_threads()
    config.configure(device="cpu")
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    config.set_config(old)


def _scalars(seed, n):
    rs = np.random.default_rng(seed)
    vals = [int.from_bytes(rs.bytes(32), "little") % R for _ in range(n)]
    vals[:3] = [0, 1, R - 1]
    return vals


@pytest.mark.parametrize("c", [3, 4, 5])
def test_std_digits_msb_match_jax_and_host(c):
    scal = _scalars(c, 21)
    w_count = -(-255 // c)
    got = ef._std_digits_msb(torch.from_numpy(FR.from_ints(scal)), c, w_count)
    want = jef._std_digits_msb(jnp.asarray(JFR.from_ints(scal)), c, w_count, (1 << c) - 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.shape == (w_count, 21)
    for k, col in zip(scal, got.T.tolist()):
        assert col == ef._host_digits_msb(k, c) == jef._host_digits_msb(k, c)
        assert sum(d << (c * (w_count - 1 - w)) for w, d in enumerate(col)) == k


class _RecordingCurve:
    """Stands in for a curve inside either package's `_group_intt`: keeps
    the digit rows every ladder is handed and turns a stage into its bare
    data movement (u = a, v = b), so the stage twiddle indices and the
    interleave / bit-reversal layout can be compared without a ladder."""

    def __init__(self, field_adapter):
        self.f = self.fa = field_adapter
        self.digits = []

    def add(self, a, b):
        return b[1] if isinstance(b[0], str) else a

    def neg(self, b):
        return ("negated", b)

    def scalar_mul_digits(self, p, digits, c):
        self.digits.append((np.asarray(digits).astype(np.int64), c))
        return p


@pytest.mark.parametrize("c", [3, 4, 5])
@pytest.mark.parametrize("force_split", [False, True], ids=["dense", "split"])
def test_group_intt_stage_digits_and_layout_match_jax(c, force_split):
    """Every stage's twiddle digit rows (MSB first, ceil(255 / c) windows,
    index j & ~(2^s - 1)), the 1/d column, and the order the lanes come out
    in, against the JAX package's `_group_intt` run without jit on the same
    points."""
    import jax

    from kzg_tpu import config as jconfig
    from kzg_tpu import curve as jcurve
    from kzg_tpu.kzg import srs as jsrs
    from kzg_tpu.ntt import Domain as JDomain

    exp = 3
    d = 1 << exp
    params = setup(SECRET, d)
    jparams = jsrs._setup_host(SECRET, d)
    old, jold = config.get_config(), jconfig.get_config()
    config.configure(group_ladder_window=c)
    jconfig.configure(group_ladder_window=c)
    try:
        rec = _RecordingCurve(G1.f)
        got = ef._group_intt(rec, params.gs, Domain(exp), force_split=force_split)
        jrec = _RecordingCurve(jcurve.G1.fa)
        with jax.disable_jit():
            want = jef._group_intt(jrec, jparams.gs, JDomain(exp), force_split=force_split)
    finally:
        config.set_config(old)
        jconfig.set_config(jold)
    assert len(rec.digits) == len(jrec.digits) == exp + 1
    widths = [d // 2] * exp + [d]  # the stages' half batches, then the 1 / d column
    for (a, ca), (b, cb), width in zip(rec.digits, jrec.digits, widths):
        assert ca == cb == c and a.shape == (-(-255 // c), width)
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(unpack16(a).numpy().astype(np.uint32), np.asarray(b))
    assert not torch.equal(got[0], params.gs[0])  # the lanes did move


def _oracle_lagrange_scalars(exp):
    """L_i(s) = prod_{j != i} (s - w^j) / (w^i - w^j), host ints."""
    d = 1 << exp
    w = Domain(exp).omega
    out = []
    for i in range(d):
        num = den = 1
        for j in range(d):
            if j != i:
                num = num * (SECRET - pow(w, j, R)) % R
                den = den * (pow(w, i, R) - pow(w, j, R)) % R
        out.append(num * pow(den, -1, R) % R)
    return out


def _check_trusted(exp):
    params = setup(SECRET, 1 << exp)
    trusted = compute_lagrange_basis(params, exp)
    secret = compute_lagrange_basis_from_secret(SECRET, exp)
    for a, b in zip(trusted.lg + trusted.lh, secret.lg + secret.lh):
        assert torch.equal(a, b)  # affine words and masks, lg and lh
    scalars = _oracle_lagrange_scalars(exp)
    assert g1_from_device(trusted.lg) == [ec_mul(g1_generator(), k) for k in scalars]
    assert g2_from_device(trusted.lh) == [ec_mul(g2_generator(), k) for k in scalars]
    return params, trusted


def test_lagrange_basis_trusted_vs_secret_vs_oracle():
    params, trusted = _check_trusted(2)
    assert trusted.exp == 2 and trusted.lg[0].shape == (12, 4) and trusted.lh[0].shape == (12, 2, 4)
    with pytest.raises(PolynomialDegreeTooLarge):
        compute_lagrange_basis(params, 3)


def test_group_intt_split_tables_match_dense():
    """The big-domain branch (twiddles from two O(sqrt n) tables, digits
    extracted on the device) forced on a small domain, and the domain of one
    point."""
    params = setup(SECRET, 4)
    dom = Domain(2)
    dense = ef._group_intt(G1, params.gs, dom)
    split = ef._group_intt(G1, params.gs, dom, force_split=True)
    assert all(torch.equal(a, b) for a, b in zip(dense, split))
    one = ef._group_intt(G1, tuple(t[..., :1] for t in params.gs), Domain(0))
    assert g1_from_device(one) == [g1_generator()]


@pytest.mark.slow
@pytest.mark.parametrize("exp", [3, 4, 5])
def test_lagrange_basis_trusted_vs_secret_vs_oracle_larger(exp):
    params, trusted = _check_trusted(exp)
    dom = Domain(exp)
    split = G1.to_affine(ef._group_intt(G1, params.gs, dom, force_split=True))
    assert all(torch.equal(a, b) for a, b in zip(split, trusted.lg))


@pytest.mark.slow
def test_lagrange_basis_matches_jax_trusted_route():
    """Against the JAX package's compute_lagrange_basis (its group-iNTT
    graphs compile for minutes on a CPU)."""
    from kzg_tpu.kzg import srs as jsrs

    exp = 2
    want = jef.compute_lagrange_basis(jsrs._setup_host(SECRET, 1 << exp), exp)
    got = compute_lagrange_basis(setup(SECRET, 1 << exp), exp)
    for a, b in zip(got.lg[:2] + got.lh[:2], want.lg[:2] + want.lh[:2]):
        np.testing.assert_array_equal(unpack16(a).numpy().astype(np.uint32), np.asarray(b))


def test_lagrange_srs_files_cross_the_packages(tmp_path):
    exp = 3
    jlag = jef._lagrange_basis_host(SECRET, exp)
    jlag.save(str(tmp_path / "jax_lagrange"))
    port = LagrangeSRS.load(str(tmp_path / "jax_lagrange"))
    own = compute_lagrange_basis_from_secret(SECRET, exp)
    for a, b in zip(port.lg + port.lh, own.lg + own.lh):
        assert torch.equal(a, b)
    assert port.exp == exp
    direct = LagrangeSRS.from_numpy(tuple(np.asarray(t) for t in jlag.lg),
                                    tuple(np.asarray(t) for t in jlag.lh), exp)
    for a, b in zip(direct.lg + direct.lh, own.lg + own.lh):
        assert torch.equal(a, b)
    own.save(str(tmp_path / "port_lagrange.npz"))
    back = jef.LagrangeSRS.load(str(tmp_path / "port_lagrange"))
    assert back.exp == exp
    for a, b in zip(back.lg + back.lh, jlag.lg + jlag.lh):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_lagrange_polynomials_against_host_ints():
    exp = 3
    d = 1 << exp
    mat = lagrange_polynomials(exp)
    assert mat.shape == (FR.W, d, d)
    winv = pow(Domain(exp).omega, -1, R)
    dinv = pow(d, -1, R)
    want = [pow(winv, (i * j) % d, R) * dinv % R for i in range(d) for j in range(d)]
    assert FR.decode(mat) == want
    # L_i(omega^k) = [i == k]
    rows = [want[i * d:(i + 1) * d] for i in range(d)]
    w = Domain(exp).omega
    for i in (0, 3):
        for k in (0, 3, 7):
            x = pow(w, k, R)
            assert sum(c * pow(x, j, R) for j, c in enumerate(rows[i])) % R == int(i == k)


@pytest.mark.slow
def test_lagrange_polynomials_match_jax():
    exp = 3
    got = lagrange_polynomials(exp)
    np.testing.assert_array_equal(unpack16(got).numpy().astype(np.uint32),
                                  np.asarray(jef.lagrange_polynomials(exp)))
    params = setup(SECRET, 4)
    lag, polys = compute_lagrange_basis_and_polynomials(params, 2)
    assert lag.exp == 2 and torch.equal(polys, lagrange_polynomials(2))
