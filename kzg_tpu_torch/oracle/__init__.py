"""Copy of `kzg_tpu/oracle/__init__.py`. The `kzg_tpu` package imports JAX in
its `__init__`, so the port, which runs where JAX is absent, cannot import
even the JAX-free modules of that package.

Pure-Python BLS12-381 oracle: slow, obviously-correct reference used for
differential testing of every TPU kernel and for host-side pairing checks."""

from .field import Fp, Fp2, Fp6, Fp12
from .curve import (
    ec_add,
    ec_mul,
    ec_neg,
    g1_generator,
    g2_generator,
    on_curve_g1,
    on_curve_g2,
    pairing,
    multi_pairing_check,
    miller_loop,
    final_exponentiation,
)
