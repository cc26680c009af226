"""Copy of `kzg_tpu/hostcrypto.py`. The `kzg_tpu` package imports JAX in
its `__init__`, so the port, which runs where JAX is absent, cannot import
even the JAX-free modules of that package.

Host-side crypto dispatch: native C++ engine when available, else oracle.

The Rust reference's host arithmetic is blst assembly behind blstrs
(SURVEY.md §2.2). Here the same role is split in two: `native/` (C++, fast)
and `oracle/` (pure Python, slow but obviously correct). This module picks
the best available engine at import time so protocol code (verify pairings,
serialization subgroup checks, host-side scalar muls) never has to care.

All functions speak the oracle point convention: None = infinity, otherwise
a tuple of oracle field elements.
"""

from .oracle import curve as _oracle
from . import native as _native

NATIVE = _native.available()


def multi_pairing_check(pairs, engine: str = "auto") -> bool:
    """True iff prod e(P_i, Q_i) == 1 (one shared final exponentiation).

    engine: "auto"/"host" = native C++ when available, else oracle;
    "oracle" forces the pure-Python path (the "device" engine never reaches
    this host dispatcher — the verifiers route it to kzg/engines.py)."""
    if engine != "oracle" and NATIVE:
        return _native.pairing_check(pairs)
    return _oracle.multi_pairing_check(pairs)


def pairing(p, q):
    if NATIVE:
        return _native.pairing(p, q)
    return _oracle.pairing(p, q)


def ec_mul_g1(p, k: int):
    if NATIVE:
        return _native.g1_mul(p, k)
    return _oracle.ec_mul(p, k)


def ec_mul_g2(p, k: int):
    if NATIVE:
        return _native.g2_mul(p, k)
    return _oracle.ec_mul(p, k)


def g1_in_subgroup(p) -> bool:
    if NATIVE:
        return _native.g1_in_subgroup(p)
    from .compat.serialize import _in_subgroup

    return _in_subgroup(p)


def g2_in_subgroup(p) -> bool:
    if NATIVE:
        return _native.g2_in_subgroup(p)
    from .compat.serialize import _in_subgroup

    return _in_subgroup(p)
