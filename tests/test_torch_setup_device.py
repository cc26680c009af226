"""Device setup of the port (kzg_tpu_torch.kzg.srs.setup_device, the fixed-
base tables and ladders, the device route of
compute_lagrange_basis_from_secret), on the CPU, where every step runs its
plain version: `configure(setup_engine="device")` with `device="cpu"`.

Held, exactly (affine coordinates are canonical, tolerance 0), against the
JAX package's `setup` on its host engine, against `native.g1_powers` /
`g2_powers`, and against the oracle. The JAX package's own device ladders
compile for minutes on a CPU, so they are not run here; both packages'
ladders read the same table, which `tables_from_numpy` carries across.
"""

import importlib
import shutil
import warnings

import numpy as np
import pytest
import torch

from kzg_tpu.kzg import srs as jsrs
from kzg_tpu_torch import config, native
from kzg_tpu_torch.constants import R
from kzg_tpu_torch.curve import (
    G1, G2, g1_from_device, g1_generator_device, g2_from_device, g2_generator_device,
)
from kzg_tpu_torch.fields import FR
from kzg_tpu_torch.kzg import eval_form, srs
from kzg_tpu_torch.msm.pippenger import _digits
from kzg_tpu_torch.oracle import ec_mul, g1_generator, g2_generator

jconfig = importlib.import_module("kzg_tpu.config")

SECRET = 0x5EED1DEAF00D


@pytest.fixture(scope="module", autouse=True)
def _cpu_device():
    """The port places tensors on the card by default; these tests run the
    plain versions, so they ask for the CPU."""
    torch.set_num_threads(1)  # the plain versions' ops are tiny
    old = config.get_config()
    config.configure(device="cpu")
    yield
    config.set_config(old)


@pytest.fixture
def cfg():
    """Change the port's config inside a test; restored afterwards."""
    old = config.get_config()
    yield config.configure
    config.set_config(old)


def _same_params(got, want_gs, want_hs):
    for a, b in zip(got.gs[:2] + got.hs[:2], tuple(want_gs[:2]) + tuple(want_hs[:2])):
        np.testing.assert_array_equal(srs._to_limbs16(a), np.asarray(b))
    np.testing.assert_array_equal(got.gs[2].numpy(), np.asarray(want_gs[2]))
    np.testing.assert_array_equal(got.hs[2].numpy(), np.asarray(want_hs[2]))


@pytest.mark.parametrize("n", [4, 9])
def test_setup_device_matches_jax_host_setup_and_native(n):
    got = srs.setup_device(SECRET, n)
    assert got.n == n and got.gs[0].device.type == "cpu"
    want = jsrs.setup(SECRET, n)  # the JAX package on its host engine (CPU backend)
    _same_params(got, want.gs, want.hs)
    assert g1_from_device(got.gs) == native.g1_powers(g1_generator(), SECRET, n)
    assert g2_from_device(got.hs) == native.g2_powers(g2_generator(), SECRET, n)


def test_setup_device_g2_count():
    got = srs.setup_device(SECRET, 5, g2_count=2)
    assert got.n == 5 and got.gs[0].shape[-1] == 5 and got.hs[0].shape[-1] == 2
    assert g1_from_device(got.gs) == native.g1_powers(g1_generator(), SECRET, 5)
    assert g2_from_device(got.hs) == native.g2_powers(g2_generator(), SECRET, 2)


def test_setup_device_chunked_g1_ladder(cfg):
    """msm_chunk_log lowered to 4: 19 powers are built as chunks of 16 and
    3, the second from s^16."""
    cfg(msm_chunk_log=4)
    got = srs.setup_device(SECRET, 19, g2_count=19)
    assert got.gs[0].shape[-1] == 19 and got.hs[0].shape[-1] == 19
    assert g1_from_device(got.gs) == native.g1_powers(g1_generator(), SECRET, 19)
    assert g2_from_device(got.hs) == native.g2_powers(g2_generator(), SECRET, 19)


def test_setup_digits_are_the_windows_of_the_powers():
    s_mont = torch.from_numpy(FR.encode([SECRET]))
    digits = srs._setup_digits(6, 8, s_mont)
    assert tuple(digits.shape) == (32, 6)
    for i in range(6):
        p = pow(SECRET, i, R)
        assert digits[:, i].tolist() == [(p >> (8 * w)) & 0xFF for w in range(32)]
    base = torch.from_numpy(FR.encode([pow(SECRET, 16, R)]))
    assert torch.equal(srs._setup_digits(3, 8, s_mont, base),
                       _digits(FR.from_mont(torch.from_numpy(
                           FR.encode([pow(SECRET, 16 + i, R) for i in range(3)]))), 8))


@pytest.mark.parametrize("curve,gen,from_device,ogen",
                         [(G1, g1_generator_device, g1_from_device, g1_generator),
                          (G2, g2_generator_device, g2_from_device, g2_generator)],
                         ids=["G1", "G2"])
def test_fixed_base_table_and_ladder_against_oracle(curve, gen, from_device, ogen):
    """c = 2, two windows: T[w][d] = (d << 2 w) G, then the ladder over all
    16 two-digit scalars."""
    c, w_count = 2, 2
    table = srs._fixed_base_table(curve, gen(1, "cpu"), c, w_count)
    assert table[0].shape[-2:] == (w_count, 1 << c)
    pts = from_device(tuple(t.reshape(t.shape[:-2] + (-1,)) for t in table))
    assert pts == [ec_mul(ogen(), d << (c * w)) if d else None
                   for w in range(w_count) for d in range(1 << c)]
    scalars = torch.arange(16)
    digits = torch.stack([scalars & 3, scalars >> 2])
    got = from_device(srs._ladder_from_table(curve, table, digits))
    assert got == [ec_mul(ogen(), k) if k else None for k in range(16)]


def test_fixed_base_tables_load_the_repo_blob_and_match_jax():
    t1, t2 = srs.fixed_base_tables(8, 32)
    assert tuple(t1[0].shape) == (12, 32, 256) and tuple(t2[0].shape) == (12, 2, 32, 256)
    assert t1[0].dtype == torch.int32
    assert srs.fixed_base_tables(8, 32)[0][0] is t1[0]  # cached per device
    jt1, jt2 = jsrs.fixed_base_tables(8, 32)  # the same blob through the JAX package
    p1, p2 = srs.tables_from_numpy(jt1, jt2)
    assert all(torch.equal(a, b) for a, b in zip(t1 + t2, p1 + p2))
    with np.load(srs._table_cache_path(8, 32)) as z:
        raw1 = tuple(z[f"t1_{i}"] for i in range(3))
        raw2 = tuple(z[f"t2_{i}"] for i in range(3))
        assert srs._tables_digest(raw1, raw2) == str(z["digest"]) == jsrs._tables_digest(raw1, raw2)
    for a, b in zip(t1 + t2, raw1 + raw2):  # the layouts convert without loss
        np.testing.assert_array_equal(srs._to_limbs16(a), b)
    assert srs._validate_tables(raw1, raw2, 8, 32)
    bad = tuple(t.copy() for t in raw1)
    bad[0][0, 16, 3] ^= 1  # a sampled entry, one bit
    assert not srs._validate_tables(bad, raw2, 8, 32)
    assert not srs._validate_tables(raw1, raw2, 8, 31)


def test_corrupted_table_blob_is_refused_and_rebuilt(cfg, tmp_path, monkeypatch):
    """A tiny table (c = 2, two windows) in a cache directory of its own:
    built and written, read back, then corrupted on disk: the digest refuses
    it, a warning says so, and the rebuilt table replaces it. The JAX
    package accepts the blob the port wrote."""
    cfg(srs_cache_dir=str(tmp_path))
    monkeypatch.setattr(srs, "_TABLE_CACHE", {})
    good = srs.fixed_base_tables(2, 2)
    path = tmp_path / "fixed_base_c2_w2.npz"
    assert path.exists()
    with np.load(path) as z:
        blob = {k: z[k] for k in z.files}
    assert jsrs._validate_tables(tuple(blob[f"t1_{i}"] for i in range(3)),
                                 tuple(blob[f"t2_{i}"] for i in range(3)), 2, 2)
    srs._TABLE_CACHE.clear()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        again = srs.fixed_base_tables(2, 2)  # a clean load warns about nothing
    assert all(torch.equal(a, b) for a, b in zip(good[0] + good[1], again[0] + again[1]))
    blob["t1_1"] = blob["t1_1"].copy()
    blob["t1_1"][5, 1, 2] ^= 0x10
    np.savez(path, **blob)
    srs._TABLE_CACHE.clear()
    with pytest.warns(UserWarning, match="failed integrity validation"):
        rebuilt = srs.fixed_base_tables(2, 2)
    assert all(torch.equal(a, b) for a, b in zip(good[0] + good[1], rebuilt[0] + rebuilt[1]))
    with np.load(path) as z:
        assert str(z["digest"]) == srs._tables_digest(
            tuple(z[f"t1_{i}"] for i in range(3)), tuple(z[f"t2_{i}"] for i in range(3)))


def test_copied_repo_blob_loads_from_another_cache_dir(cfg, tmp_path, monkeypatch):
    shutil.copy(srs._table_cache_path(8, 32), tmp_path)
    cfg(srs_cache_dir=str(tmp_path))
    monkeypatch.setattr(srs, "_TABLE_CACHE", {})
    assert srs._table_cache_path(8, 32).startswith(str(tmp_path))
    t1, _ = srs.fixed_base_tables(8, 32)
    assert g1_from_device(tuple(t[:, 0, 1:2] for t in t1)) == [g1_generator()]


def test_lagrange_device_route_equals_host_route(cfg):
    cfg(setup_engine="device")
    dev_route = eval_form.compute_lagrange_basis_from_secret(SECRET, 2)
    cfg(setup_engine="host")
    host_route = eval_form.compute_lagrange_basis_from_secret(SECRET, 2)
    assert dev_route.exp == 2
    for a, b in zip(dev_route.lg + dev_route.lh, host_route.lg + host_route.lh):
        assert torch.equal(a, b)


def test_setup_takes_the_configured_engine(cfg, monkeypatch):
    """"auto" on the CPU is the host engine, "device" the ladders (on the
    plain versions), "host" the host engine; on a card "auto" is the device
    route. No route changes without the config saying so."""
    calls = []
    monkeypatch.setattr(srs, "_setup_host", lambda *a, **k: calls.append("host"))
    monkeypatch.setattr(srs, "setup_device", lambda *a, **k: calls.append("device"))
    for engine, device, want in (("auto", "cpu", "host"), ("device", "cpu", "device"),
                                 ("host", "cpu", "host"), ("auto", "cuda", "device"),
                                 ("host", "cuda", "host"), ("device", "cuda", "device")):
        cfg(setup_engine=engine)
        srs.setup(SECRET, 4, device=device)
        assert calls.pop() == want, (engine, device)
        assert srs.host_engine_preferred(device) == (want == "host")
    cfg(setup_engine="auto", device="cuda")
    assert not srs.host_engine_preferred()  # the default config on a GPU host
    cfg(setup_engine="host")
    monkeypatch.setattr(native, "available", lambda: False)
    with pytest.raises(native.NativeError):
        srs.host_engine_preferred("cpu")


def test_setup_device_engine_on_cpu_equals_host_engine(cfg):
    cfg(setup_engine="device")
    a = srs.setup(SECRET, 3)
    cfg(setup_engine="host")
    b = srs.setup(SECRET, 3)
    assert all(torch.equal(x, y) for x, y in zip(a.gs + a.hs, b.gs + b.hs))
