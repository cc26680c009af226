"""Coefficient-form KZG prover and verifier: the single opening (port of the
main-path subset of `kzg_tpu/kzg/coeff_form.py`).

  * commit / witness = one Pippenger MSM over the SRS (kernels K1-K4);
  * the witness quotient (f - y)/(X - x) is a log-depth suffix scan
    (poly layer); f_0 only enters the remainder, so f - y is never formed;
  * pairing checks run on the host engine: two small points cross from the
    device.

Not ported yet: the streamed witness above 2^msm_chunk_log coefficients
(`_witness_streamed`), the batched opening and its verifier, and the
device pairing engine.
"""

from ..constants import R
from ..curve import G1, g1_from_device, g2_from_device
from ..hostcrypto import multi_pairing_check
from ..msm import msm_g1
from ..oracle import ec_add, ec_mul, ec_neg
from ..poly import Polynomial
from .errors import PointNotOnPolynomial, PolynomialDegreeTooLarge
from .srs import KZGParams


def _slice_srs(gs, n):
    return tuple(t[..., :n] for t in gs)


class KZGProver:
    """Stateless prover borrowing the SRS (coeff_form.rs:38-53)."""

    def __init__(self, params: KZGParams):
        self.params = params

    def commit(self, poly: Polynomial):
        """C = MSM(gs[..n], coeffs)  (coeff_form.rs:59-64). Returns a
        Jacobian point, 3 x (12,) words."""
        n = poly.num_coeffs()
        if n > self.params.n:
            raise PolynomialDegreeTooLarge(f"{n} coefficients, SRS holds {self.params.n}")
        return msm_g1(_slice_srs(self.params.gs, n), poly.trimmed())

    def create_witness(self, poly: Polynomial, point, check: bool = True):
        """Witness for f(x) = y: psi = (f - y)/(X - x), w = MSM(gs, psi)
        (coeff_form.rs:66-81). Raises PointNotOnPolynomial when y != f(x);
        check=False skips that device -> host round trip."""
        x, y = point
        if check and poly.eval(x % R) != y % R:
            raise PointNotOnPolynomial(f"({x}, {y}) not on polynomial")
        if poly.degree == 0:
            return G1.infinity((), poly.device)
        q, _ = poly.div_by_linear(x % R, want_rem=False)
        return msm_g1(_slice_srs(self.params.gs, q.num_coeffs()), q.trimmed())


class KZGVerifier:
    """Stateless verifier borrowing the SRS (coeff_form.rs:114-183). Pairing
    checks run on the host: config.pairing_engine "auto"/"host" = native
    C++ engine (oracle if it is missing), "oracle" = pure Python."""

    def __init__(self, params: KZGParams, engine: str | None = None):
        self.params = params
        self.engine = engine
        self._g = g1_from_device(tuple(t[..., 0:1] for t in params.gs))[0]
        self._h = g2_from_device(tuple(t[..., 0:1] for t in params.hs))[0]
        self._hs1 = g2_from_device(tuple(t[..., 1:2] for t in params.hs))[0]

    def _engine(self) -> str:
        if self.engine is not None:
            return self.engine
        from ..config import get_config

        return get_config().pairing_engine

    def verify_poly(self, commitment, poly: Polynomial) -> bool:
        """Recommit and compare (coeff_form.rs:119-124)."""
        again = msm_g1(_slice_srs(self.params.gs, poly.num_coeffs()), poly.trimmed())
        return bool(G1.eq(commitment, again))

    def verify_eval(self, point, commitment, witness) -> bool:
        """e(w, h^s / h^x) == e(C / g^y, h)  (coeff_form.rs:126-142)."""
        x, y = point
        c_host = g1_from_device(tuple(t[..., None] for t in commitment))[0]
        w_host = g1_from_device(tuple(t[..., None] for t in witness))[0]
        s2 = ec_add(self._hs1, ec_neg(ec_mul(self._h, x % R)))  # h^(s - x)
        rhs_g1 = ec_add(c_host, ec_neg(ec_mul(self._g, y % R)))  # C - y*g
        # e(w, s2) * e(-(C - y g), h) == 1
        return multi_pairing_check(
            [(w_host, s2), (ec_neg(rhs_g1), self._h)], engine=self._engine()
        )


def g1_compressed(point) -> bytes:
    """ZCash 48-byte encoding of one Jacobian device point."""
    from ..compat.serialize import g1_compress

    return g1_compress(g1_from_device(tuple(t[..., None] for t in point))[0])


__all__ = ["KZGProver", "KZGVerifier", "g1_compressed"]
