"""Copy of `kzg_tpu/kzg/errors.py`. The `kzg_tpu` package imports JAX in
its `__init__`, so the port, which runs where JAX is absent, cannot import
even the JAX-free modules of that package.

Typed protocol errors, mirroring the reference's KZGError enum
(reference src/lib.rs:26-36)."""


class KZGError(Exception):
    """Base class for KZG protocol errors."""


class PolynomialDegreeTooLarge(KZGError):
    """Polynomial degree exceeds the SRS size or the field's two-adic domain
    bound (reference src/ft.rs:61-69 raises this when exp >= S = 32)."""


class PointNotOnPolynomial(KZGError):
    """(x, y) does not lie on the polynomial: the witness quotient division
    left a nonzero remainder (reference src/coeff_form.rs:71-75)."""


class BatchedPointsNotOnPolynomial(KZGError):
    """At least one of a batch of points is not on the polynomial
    (reference src/coeff_form.rs:95-97)."""


class NoPolynomial(KZGError):
    """Operation requires a polynomial that is absent (reference
    src/lib.rs:29 — declared but never constructed there; kept for a
    complete error-enum surface)."""


class BatchOpeningZeroRemainder(KZGError):
    """Batch opening produced a zero remainder where one was required
    (reference src/lib.rs:33 — declared but never constructed there; kept
    for a complete error-enum surface)."""
