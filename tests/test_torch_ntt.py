"""Port NTT (kzg_tpu_torch.ntt, the plain twin of kernel K5 on CPU) against
the JAX package's `Domain` on the same numpy-seeded inputs. NTT outputs are
canonical Montgomery words, so the comparison is exact (tolerance 0), limb
for limb after `unpack16`.

  * ntt / intt / coset_ntt / coset_intt at exp 1-8, Pease loop, with a
    batch axis;
  * the four-step path, with ntt_four_step_min_exp lowered to 4 in both
    packages (the coset transforms, which run ntt / intt inside, against
    JAX; ntt / intt themselves against a naive DFT);
  * the split-table path (coset and four-step twiddles from O(sqrt n)
    tables), with _BIG_TABLE_EXP lowered in both packages, and against a
    naive O(n^2) DFT on host ints;
  * the K5 plain twins: the butterfly against the Pallas `make_ntt_stage`
    in interpret mode and against host ints; the stage layout (twiddle
    index, interleaved output) against host ints.
Each JAX transform compiles once per shape, so the four-step and split
cases hold only the coset pair against JAX.
"""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kzg_tpu.fields import FR as JFR
from kzg_tpu.ntt import domain as jdomain
from kzg_tpu_torch import config, kernels
from kzg_tpu_torch.constants import R
from kzg_tpu_torch.fields import FR, cuda_field
from kzg_tpu_torch.fields.limb import unpack16
from kzg_tpu_torch.kzg.errors import PolynomialDegreeTooLarge
from kzg_tpu_torch.ntt import Domain, compute_omega
from kzg_tpu_torch.ntt import domain as pdomain

jconfig = importlib.import_module("kzg_tpu.config")


@pytest.fixture(scope="module", autouse=True)
def _cpu_device():
    """The port places tensors on the card by default; these tests run its
    plain twins, so they ask for the CPU."""
    old, threads = config.get_config(), torch.get_num_threads()
    config.configure(device="cpu")
    torch.set_num_threads(1)  # the twins' ops are tiny; test files run side by side
    yield
    torch.set_num_threads(threads)
    config.set_config(old)


def _ints(seed, n):
    rs = np.random.default_rng(seed)
    return [int.from_bytes(rs.bytes(32), "little") % R for _ in range(n)]


def _both(ints, shape):
    """The same Fr values as port words (8, *shape) and JAX limbs (16, *shape)."""
    port = torch.from_numpy(FR.encode(ints)).reshape((FR.W,) + shape)
    jax = jnp.asarray(JFR.encode(ints)).reshape((JFR.L,) + shape)
    return port, jax


def _same(port, jax):
    np.testing.assert_array_equal(unpack16(port).numpy().astype(np.uint32), np.asarray(jax))


def _transforms(dom):
    return (dom.ntt, dom.intt, dom.coset_ntt, dom.coset_intt)


def _naive_dft(xs, omega):
    n = len(xs)
    return [sum(x * pow(omega, j * k, R) for j, x in enumerate(xs)) % R for k in range(n)]


@pytest.fixture
def fresh_domains(monkeypatch):
    """Empty Domain caches in both packages for the test (restored after),
    so a lowered gate or table bound reaches freshly built domains."""
    monkeypatch.setattr(jdomain.Domain, "_cache", {})
    monkeypatch.setattr(Domain, "_cache", {})
    return monkeypatch


@pytest.mark.parametrize("exp", list(range(1, 9)))
def test_domain_matches_jax(exp):
    dom, jdom = Domain(exp), jdomain.Domain(exp)
    assert (dom.omega, dom.d) == (jdom.omega, jdom.d)
    x, jx = _both(_ints(exp, 2 * dom.d), (2, dom.d))
    for f, jf in zip(_transforms(dom), _transforms(jdom)):
        _same(f(x), jf(jx))
    assert FR.decode(dom.intt(dom.ntt(x))) == FR.decode(x)


def test_four_step_matches_jax(fresh_domains):
    fresh_domains.setattr(
        config, "_config", dataclasses.replace(config.get_config(), ntt_four_step_min_exp=4)
    )
    fresh_domains.setattr(
        jconfig, "_config", dataclasses.replace(jconfig.get_config(), ntt_four_step_min_exp=4)
    )
    for exp in (4, 6):
        dom, jdom = Domain(exp), jdomain.Domain(exp)
        x, jx = _both(_ints(10 + exp, 2 * dom.d), (2, dom.d))
        _same(dom.coset_ntt(x), jdom.coset_ntt(jx))
        _same(dom.coset_intt(x), jdom.coset_intt(jx))
    ints = _ints(20, 32)
    x, _ = _both(ints, (32,))
    dom = Domain(5)
    assert FR.decode(dom.ntt(x)) == _naive_dft(ints, dom.omega)
    assert FR.decode(dom.intt(dom.ntt(x))) == ints


def test_split_tables_match_jax(fresh_domains):
    fresh_domains.setattr(jdomain, "_BIG_TABLE_EXP", 5)
    fresh_domains.setattr(pdomain, "_BIG_TABLE_EXP", 5)
    for exp in (5, 7):
        dom, jdom = Domain(exp), jdomain.Domain(exp)
        assert dom.split == exp // 2 and jdom.tw_fwd is None
        x, jx = _both(_ints(30 + exp, dom.d), (dom.d,))
        _same(dom.coset_ntt(x), jdom.coset_ntt(jx))
        _same(dom.coset_intt(x), jdom.coset_intt(jx))
    ints = _ints(40, 128)
    x, _ = _both(ints, (128,))
    dom = Domain(7)
    assert FR.decode(dom.ntt(x)) == _naive_dft(ints, dom.omega)
    coset = [c * pow(dom.gen, i, R) % R for i, c in enumerate(ints)]
    assert FR.decode(dom.coset_ntt(x)) == _naive_dft(coset, dom.omega)
    assert FR.decode(dom.intt(dom.ntt(x))) == ints
    assert FR.decode(dom.coset_intt(dom.coset_ntt(x))) == ints


def test_four_step_axis2_matches_jax():
    dom, jdom = Domain(5), jdomain.Domain(5)
    x, jx = _both(_ints(50, 32 * 3), (32, 3))
    for inverse in (False, True):
        got = dom._four_step_axis2(x, inverse)
        _same(got, jdom._four_step_axis2(jx, inverse))
        assert torch.equal(got, dom._ntt_axis2(x, inverse))


def test_helpers_match_jax():
    for n in (1, 2, 3, 17, 1 << 10):
        assert compute_omega(n) == jdomain.compute_omega(n)
    with pytest.raises(PolynomialDegreeTooLarge):
        Domain(32)
    with pytest.raises(PolynomialDegreeTooLarge):
        compute_omega((1 << 32) + 1)
    dom, jdom = Domain(4), jdomain.Domain(4)
    assert dom.z_at(12345) == jdom.z_at(12345)
    x, jx = _both(_ints(60, 16), (16,))
    _same(dom.divide_by_z_on_coset(x), jdom.divide_by_z_on_coset(jx))


def test_ntt_stage_plain_against_host_ints():
    n = 64
    a_i, b_i, w_i = _ints(70, n), _ints(71, n), _ints(72, n)
    a_i[:3], b_i[:3] = [0, 1, R - 1], [R - 1, R - 1, 1]
    a, b, w = (torch.from_numpy(FR.encode(v)) for v in (a_i, b_i, w_i))
    u, v = cuda_field.ntt_stage_plain(a, b, w)
    assert FR.decode(u) == [(x + y) % R for x, y in zip(a_i, b_i)]
    assert FR.decode(v) == [(x - y) * t % R for x, y, t in zip(a_i, b_i, w_i)]


@pytest.mark.parametrize("s", [0, 1, 2])
def test_ntt_stage_layout_against_host_ints(s):
    nb, m, bt = 2, 8, 3
    h = m // 2
    vals = _ints(80 + s, nb * m * bt)
    tw_i = _ints(90, h)
    x = torch.from_numpy(FR.encode(vals)).reshape(FR.W, nb, m, bt)
    tw = torch.from_numpy(FR.encode(tw_i))
    got = FR.decode(cuda_field.ntt_stage(x, tw, s))  # CPU: the plain twin
    want = [0] * (nb * m * bt)

    def at(b_, row, c):
        return (b_ * m + row) * bt + c

    for b_ in range(nb):
        for j in range(h):
            w = tw_i[j & ~((1 << s) - 1)]
            for c in range(bt):
                p, q = vals[at(b_, j, c)], vals[at(b_, j + h, c)]
                want[at(b_, 2 * j, c)] = (p + q) % R
                want[at(b_, 2 * j + 1, c)] = (p - q) * w % R
    assert got == want


def test_ntt_stage_rejects_other_devices():
    x = torch.empty((FR.W, 1, 4, 1), dtype=torch.int32, device="meta")
    with pytest.raises(kernels.KernelError):
        cuda_field.ntt_stage(x, x[:, 0, :2, 0], 0)


def test_ntt_stage_plain_matches_pallas_interpret():
    from kzg_tpu.fields.pallas_field import make_ntt_stage

    n = 1024
    a, ja = _both(_ints(100, n), (n,))
    b, jb = _both(_ints(101, n), (n,))
    w, jw = _both(_ints(102, n), (n,))
    u, v = cuda_field.ntt_stage_plain(a, b, w)
    ju, jv = make_ntt_stage(JFR, interpret=True)(ja, jb, jw)
    _same(u, ju)
    _same(v, jv)
