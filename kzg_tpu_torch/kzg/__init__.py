"""KZG protocol layer of the port: setup, the coefficient-form and the
evaluation-form prover and verifier. Exports resolve lazily, as in `kzg_tpu/kzg/__init__.py`."""

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
    "LagrangeSRS": "eval_form",
    "KZGProverEvalForm": "eval_form",
    "KZGVerifierEvalForm": "eval_form",
    "KZGBatchWitnessEvalForm": "eval_form",
    "compute_lagrange_basis": "eval_form",
    "compute_lagrange_basis_from_secret": "eval_form",
    "compute_lagrange_basis_and_polynomials": "eval_form",
    "lagrange_polynomials": "eval_form",
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
