"""Port EvaluationDomain (kzg_tpu_torch.ntt.evaluation_domain, plain kernel
twins on CPU) against the JAX package's class on the same numpy-seeded
inputs, limb for limb (the port's 32-bit words unpacked to the JAX package's
16-bit limbs). Tolerance 0.

Every method at exp 3-5; `distribute_powers` also through its split hi / lo
tables (`_SPLIT_POWERS_EXP` lowered) and against host ints; files saved by
either package load into the other.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kzg_tpu.fields import FR as JFR
from kzg_tpu.ntt import EvaluationDomain as JEvaluationDomain
from kzg_tpu_torch import config
from kzg_tpu_torch.constants import FR_GENERATOR, R
from kzg_tpu_torch.fields import FR
from kzg_tpu_torch.fields.limb import unpack16
from kzg_tpu_torch.kzg.errors import PolynomialDegreeTooLarge
from kzg_tpu_torch.ntt import EvaluationDomain, compute_omega
from kzg_tpu_torch.ntt import evaluation_domain as edm
from kzg_tpu_torch.poly import Polynomial


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


def _same(port: EvaluationDomain, ref: JEvaluationDomain):
    assert (port.d, port.exp, port.omega) == (ref.d, ref.exp, ref.omega)
    np.testing.assert_array_equal(
        unpack16(port.values).numpy().astype(np.uint32), np.asarray(ref.values)
    )


@pytest.fixture(scope="module", params=[3, 4, 5], ids=lambda e: f"exp{e}")
def pair(request):
    """The same d - 1 values (so from_ints pads) in both packages."""
    d = 1 << request.param
    xs, ys = _ints(request.param, d - 1), _ints(100 + request.param, d)
    return (xs, ys, EvaluationDomain.from_ints(xs), JEvaluationDomain.from_ints(xs),
            EvaluationDomain.from_ints(ys), JEvaluationDomain.from_ints(ys))


def test_constructors_and_accessors(pair):
    xs, _, a, ja, _, _ = pair
    _same(a, ja)
    d = len(xs) + 1
    assert len(a) == a.d == d and a.to_ints() == xs + [0]
    assert (a.omega, a.d, a.exp) == compute_omega(len(xs))
    assert a.into_coeffs() is a.values
    assert "EvaluationDomain(d=" in repr(a)
    p = Polynomial.from_ints(xs + [0, 0, 0], degree=len(xs) - 1)
    _same(EvaluationDomain.from_polynomial(p), ja)
    other = a.clone_with_different_coeffs(torch.from_numpy(FR.encode(list(range(d)))))
    assert other.d == a.d and other != a and other.domain is a.domain


@pytest.mark.parametrize("method", ["fft", "ifft", "coset_fft", "icoset_fft",
                                    "divide_by_z_on_coset"])
def test_transforms_match_jax(pair, method):
    _, _, a, ja, _, _ = pair
    _same(getattr(a, method)(), getattr(ja, method)())


def test_roundtrips_and_interpolate(pair):
    xs, _, a, ja, _, _ = pair
    assert a.fft().ifft() == a and a.coset_fft().icoset_fft() == a
    assert a.coset_fft() == a.distribute_powers(FR_GENERATOR).fft()
    p = a.fft().interpolate()
    assert p.to_ints()[: len(xs)] == xs
    np.testing.assert_array_equal(
        unpack16(p.coeffs).numpy().astype(np.uint32), np.asarray(ja.fft().interpolate().coeffs)
    )


def test_pointwise_ops_and_z_match_jax(pair):
    xs, ys, a, ja, b, jb = pair
    for name in ("mul_assign", "sub_assign", "add_assign"):
        _same(getattr(a, name)(b), getattr(ja, name)(jb))
    xs = xs + [0]
    assert a.mul_assign(b).to_ints() == [x * y % R for x, y in zip(xs, ys)]
    assert a.sub_assign(b).to_ints() == [(x - y) % R for x, y in zip(xs, ys)]
    tau = 987654321
    assert a.z(tau) == ja.z(tau) == (pow(tau, a.d, R) - 1) % R


def test_distribute_powers_dense_and_split_match_jax(pair, monkeypatch):
    xs, _, a, ja, _, _ = pair
    g = _ints(7, 1)[0]
    want = [(x * pow(g, i, R)) % R for i, x in enumerate(xs + [0])]
    edm._POWER_TABLE_CACHE.clear()
    dense = a.distribute_powers(g)
    _same(dense, ja.distribute_powers(g))
    assert dense.to_ints() == want
    assert a.distribute_powers(g) == dense  # the cache hit
    monkeypatch.setattr(edm, "_SPLIT_POWERS_EXP", 3)  # hi / lo tables at every exp here
    edm._POWER_TABLE_CACHE.clear()
    split = a.distribute_powers(g)
    assert split == dense
    (hi, lo), = edm._POWER_TABLE_CACHE.values()
    assert hi.shape[-1] * lo.shape[-1] == a.d and lo.shape[-1] == 1 << (a.exp // 2)
    assert a.distribute_powers(g) == dense  # the split cache hit
    edm._POWER_TABLE_CACHE.clear()


def test_powers_device_matches_host_ints():
    g = _ints(8, 1)[0]
    for count in (1, 2, 5, 16):
        assert FR.decode(edm._powers_device(g, count, "cpu")) == [pow(g, i, R) for i in range(count)]


def test_files_cross_the_packages(pair, tmp_path):
    _, _, a, ja, _, _ = pair
    a.save(str(tmp_path / "port.npz"))
    ja.save(str(tmp_path / "jax.npz"))
    _same(EvaluationDomain.load(str(tmp_path / "jax.npz")), ja)
    _same(a, JEvaluationDomain.load(str(tmp_path / "port.npz")))
    assert EvaluationDomain.load(str(tmp_path / "port.npz")) == a


def test_equality_and_errors():
    a = EvaluationDomain.from_ints([1, 2, 3, 4])
    assert (a == None) is False  # noqa: E711  (NotImplemented fallback)
    assert (a != 17) is True
    assert a != EvaluationDomain.from_ints([1, 2, 3, 4, 5])
    with pytest.raises(TypeError):
        hash(a)
    with pytest.raises(AssertionError):
        a.mul_assign(EvaluationDomain.from_ints([1, 2]))
    with pytest.raises(AssertionError):
        a.clone_with_different_coeffs(FR.zeros((3,)))
    with pytest.raises(PolynomialDegreeTooLarge):
        compute_omega((1 << 32) + 1)
    one = EvaluationDomain.from_ints([5])
    assert (one.d, one.exp) == (1, 0) and one.fft() == one
    assert JFR.decode(jnp.asarray(JFR.encode([5]))) == one.to_ints()
