"""KZG protocol layer of the port: setup and the coefficient-form prover and
verifier. Exports resolve lazily, as in `kzg_tpu/kzg/__init__.py`."""

_EXPORTS = {
    "KZGError": "errors",
    "PolynomialDegreeTooLarge": "errors",
    "PointNotOnPolynomial": "errors",
    "BatchedPointsNotOnPolynomial": "errors",
    "KZGParams": "srs",
    "setup": "srs",
    "csprng_setup": "srs",
    "KZGProver": "coeff_form",
    "KZGVerifier": "coeff_form",
    "KZGBatchWitness": "coeff_form",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    submodule = _EXPORTS.get(name)
    if submodule is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    value = getattr(importlib.import_module(f".{submodule}", __name__), name)
    globals()[name] = value
    return value
