"""The port's default device (kzg_tpu_torch.config.device, resolve_device).

With the default config every constructor that is given no device places
its tensors on the card, and raises where there is none: it never drops to
the CPU, where every op would quietly run the plain twin. Under
`configure(device="cpu")`, or with `device="cpu"` at the call, the same
constructors yield CPU tensors.
"""

import numpy as np
import pytest
import torch

from kzg_tpu_torch import config
from kzg_tpu_torch.curve import (
    g1_generator_device,
    g1_to_device,
    g2_generator_device,
    g2_to_device,
)
from kzg_tpu_torch.fields import FP, FR
from kzg_tpu_torch.kzg import KZGParams, LagrangeSRS, csprng_setup, setup
from kzg_tpu_torch.kzg.eval_form import compute_lagrange_basis_from_secret, lagrange_polynomials
from kzg_tpu_torch.ntt import EvaluationDomain
from kzg_tpu_torch.oracle import g1_generator, g2_generator
from kzg_tpu_torch.poly import Polynomial


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """An SRS and a Lagrange SRS saved from explicit CPU tensors."""
    d = tmp_path_factory.mktemp("device")
    setup(5, 4, device="cpu").save(str(d / "srs"))
    compute_lagrange_basis_from_secret(5, 2, device="cpu").save(str(d / "lagrange"))
    EvaluationDomain.from_ints([1, 2, 3], device="cpu").save(str(d / "domain.npz"))
    return d


def _tensors(out):
    """Every tensor inside a constructor's result."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _tensors(o)]
    if isinstance(out, KZGParams):
        return list(out.gs + out.hs)
    if isinstance(out, LagrangeSRS):
        return list(out.lg + out.lh)
    if isinstance(out, Polynomial):
        return [out.coeffs]
    if isinstance(out, EvaluationDomain):
        return [out.values]
    raise TypeError(type(out))


CONSTRUCTORS = {
    "setup": lambda f, **kw: setup(7, 4, **kw),
    "csprng_setup": lambda f, **kw: csprng_setup(2, **kw),
    "KZGParams.load": lambda f, **kw: KZGParams.load(str(f / "srs"), **kw),
    "LagrangeSRS.load": lambda f, **kw: LagrangeSRS.load(str(f / "lagrange"), **kw),
    "lagrange_from_secret": lambda f, **kw: compute_lagrange_basis_from_secret(7, 1, **kw),
    "lagrange_polynomials": lambda f, **kw: lagrange_polynomials(2, **kw),
    "Polynomial.from_ints": lambda f, **kw: Polynomial.from_ints([1, 2, 3], **kw),
    "Polynomial.from_scalar": lambda f, **kw: Polynomial.from_scalar(5, **kw),
    "Polynomial.new_zero": lambda f, **kw: Polynomial.new_zero(**kw),
    "Polynomial.new_single_term": lambda f, **kw: Polynomial.new_single_term(3, **kw),
    "g1_to_device": lambda f, **kw: g1_to_device([g1_generator(), None], **kw),
    "g2_to_device": lambda f, **kw: g2_to_device([g2_generator(), None], **kw),
    "g1_generator_device": lambda f, **kw: g1_generator_device(2, **kw),
    "g2_generator_device": lambda f, **kw: g2_generator_device(2, **kw),
    "FR.zeros": lambda f, **kw: FR.zeros((3,), **kw),
    "FP.one": lambda f, **kw: FP.one((3,), **kw),
    "EvaluationDomain.from_ints": lambda f, **kw: EvaluationDomain.from_ints([1, 2, 3], **kw),
    "EvaluationDomain.load": lambda f, **kw: EvaluationDomain.load(str(f / "domain.npz"), **kw),
}


@pytest.fixture
def default_config():
    old = config.get_config()
    config.set_config(config.KZGConfig())
    yield config.get_config()
    config.set_config(old)


@pytest.fixture
def cpu_config():
    old = config.get_config()
    config.configure(device="cpu")
    yield
    config.set_config(old)


def test_default_device_is_the_card(default_config):
    assert default_config.device == "cuda"
    assert config.resolve_device(None) == torch.device("cuda")
    assert config.resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("name", list(CONSTRUCTORS))
def test_default_config_places_on_the_card_or_raises(default_config, files, name):
    """No card here: torch's own error, not a quiet CPU tensor. (On a host
    with a card the same call yields CUDA tensors.)"""
    if torch.cuda.is_available():
        assert all(t.device.type == "cuda" for t in _tensors(CONSTRUCTORS[name](files)))
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            CONSTRUCTORS[name](files)


@pytest.mark.parametrize("name", list(CONSTRUCTORS))
def test_cpu_on_request(files, name, default_config):
    """device="cpu" at the call wins over the default config."""
    out = _tensors(CONSTRUCTORS[name](files, device="cpu"))
    assert out and all(t.device.type == "cpu" for t in out)


def test_configured_cpu(cpu_config, files):
    for name, make in CONSTRUCTORS.items():
        out = _tensors(make(files))
        assert out and all(t.device.type == "cpu" for t in out), name
    params = setup(7, 4)
    again = setup(7, 4, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(params.gs + params.hs, again.gs + again.hs))
    np.testing.assert_array_equal(params.gs[2].numpy(), np.zeros(4, dtype=bool))


def test_config_validates_new_fields():
    with pytest.raises(ValueError):
        config.KZGConfig(group_ladder_window=9).validate()
    with pytest.raises(ValueError):
        config.KZGConfig(group_ladder_window=0).validate()
    assert config.KZGConfig().group_ladder_window == 4


@pytest.mark.parametrize("field,bad,good", [
    ("setup_engine", "gpu", ("auto", "host", "device")),
    ("ntt_mxu", "on", ("auto", "off", "force")),
    ("fixed_base_window", 1, (2, 8, 16)),
    ("fixed_base_window", 17, (8,)),
    ("msm_chunk_log", 3, (4, 22)),
])
def test_config_validates_setup_and_mxu_fields(field, bad, good):
    with pytest.raises(ValueError):
        config.KZGConfig(**{field: bad}).validate()
    for value in good:
        assert getattr(config.KZGConfig(**{field: value}).validate(), field) == value


def test_config_defaults_of_setup_and_mxu_fields(default_config):
    """As the JAX package: the matmul-DFT NTT is off, the engine is chosen
    by the device, the repo's table cache is used."""
    assert default_config.ntt_mxu == "off"
    assert default_config.setup_engine == "auto"
    assert default_config.fixed_base_window == 8
    assert default_config.srs_cache_dir is None
    assert default_config.msm_chunk_log == 22
    with pytest.raises(TypeError):
        config.configure(setup_device=True)
