"""Coefficient-form KZG prover and verifier, single and batched openings
(port of `kzg_tpu/kzg/coeff_form.py`).

  * commit / witness = one Pippenger MSM over the SRS (kernels K1-K4);
  * the single-point witness quotient (f - y)/(X - x) is a log-depth suffix
    scan (poly layer); f_0 only enters the remainder, so f - y is never
    formed;
  * the batched witness quotient (f - r)/Z is computed by coset evaluation
    division: numerator and Z evaluated on a coset where Z has no roots,
    multiplied by the batch inverse, interpolated back (NTTs on K5); it
    falls back to long division when a batch point lies on the coset;
  * above 2^msm_chunk_log coefficients the single-point witness streams:
    each quotient chunk goes straight into its MSM partial, so the full
    quotient never sits beside the SRS (`_witness_streamed`);
  * the batched verifier computes h^Z with the G2 ladder MSM (G2 kernels);
  * pairing checks run on the engine config.pairing_engine names: a host
    engine, with a few small points crossing from the device, or the
    device engine (`kzg/engines.py`), which reads one boolean.
"""

from dataclasses import dataclass

import torch

from ..config import get_config
from ..constants import FR_GENERATOR, R
from ..curve import G1, g1_from_device, g2_from_device
from ..fields import FR
from ..hostcrypto import multi_pairing_check
from ..msm import msm_g1, msm_g2
from ..ntt import Domain
from ..oracle import ec_add, ec_mul, ec_neg
from ..poly import Polynomial, lagrange_interpolation, vanishing_poly
from ..poly.polynomial import _div_stream_chunk, _pad_to
from ..trace import span
from .engines import verify_batched_device, verify_eval_device
from .errors import (
    BatchedPointsNotOnPolynomial,
    PointNotOnPolynomial,
    PolynomialDegreeTooLarge,
)
from .srs import KZGParams


@dataclass
class KZGBatchWitness:
    """Batched opening witness: the interpolated remainder polynomial r and
    the aggregate quotient commitment w, a G1 Jacobian device point
    (reference coeff_form.rs:12-35)."""

    r: Polynomial
    w: tuple


def _fr_tensor(ints, device) -> torch.Tensor:
    return torch.from_numpy(FR.encode([x % R for x in ints])).to(device)


def _slice_srs(gs, n):
    return tuple(t[..., :n] for t in gs)


class KZGProver:
    """Stateless prover borrowing the SRS (coeff_form.rs:38-53)."""

    def __init__(self, params: KZGParams):
        self.params = params

    def commit(self, poly: Polynomial):
        """C = MSM(gs[..n], coeffs)  (coeff_form.rs:59-64). Returns a
        Jacobian point, 3 x (12,) words."""
        with span("kzg.commit"):
            n = poly.num_coeffs()
            if n > self.params.n:
                raise PolynomialDegreeTooLarge(f"{n} coefficients, SRS holds {self.params.n}")
            return msm_g1(_slice_srs(self.params.gs, n), poly.trimmed())

    def create_witness(self, poly: Polynomial, point, check: bool = True):
        """Witness for f(x) = y: psi = (f - y)/(X - x), w = MSM(gs, psi)
        (coeff_form.rs:66-81). Raises PointNotOnPolynomial when y != f(x);
        check=False skips that device -> host round trip."""
        with span("kzg.witness"):
            x, y = point
            if check and poly.eval(x % R) != y % R:
                raise PointNotOnPolynomial(f"({x}, {y}) not on polynomial")
            if poly.degree == 0:
                return G1.infinity((), poly.device)
            if poly.num_coeffs() > (1 << get_config().msm_chunk_log) and x % R != 0:
                return self._witness_streamed(poly, x % R)
            q, _ = poly.div_by_linear(x % R, want_rem=False)
            return msm_g1(_slice_srs(self.params.gs, q.num_coeffs()), q.trimmed())

    def _witness_streamed(self, poly: Polynomial, x: int):
        """The single-point witness chunk by chunk (`kzg_tpu/kzg/
        coeff_form.py:105-143`): for each chunk of 2^min(div_chunk_log,
        msm_chunk_log) coefficients, high to low, one `fr_horner` call
        (`_div_stream_chunk`) gives the quotient chunk and one MSM over the
        matching SRS slice consumes it; the Jacobian partials are summed by
        K2. The top chunk is clipped to the n - off coefficients it holds
        (its last quotient entry is the zero above the quotient). Peak
        memory is the SRS, f and one chunk's work, whatever n."""
        cfg = get_config()
        m = 1 << min(cfg.div_chunk_log, cfg.msm_chunk_log)
        f = poly.trimmed()
        n = f.shape[-1]
        pt = torch.from_numpy(FR.encode([x])).to(f.device)
        carry = FR.zeros((1,), f.device)
        acc = None
        for off in range((n - 1) // m * m, -1, -m):
            qc, carry = _div_stream_chunk(f[:, off:off + m], pt, carry)
            part = msm_g1(tuple(t[..., off:off + qc.shape[-1]] for t in self.params.gs), qc)
            acc = part if acc is None else G1.add(acc, part)
        return acc

    def create_witness_batched(self, poly: Polynomial, xs, ys,
                               check: bool = True) -> KZGBatchWitness:
        """Aggregate witness for f(x_i) = y_i: r interpolates the points,
        psi = (f - r)/Z, w = MSM(gs, psi) (coeff_form.rs:83-111). Raises
        BatchedPointsNotOnPolynomial when some y_i != f(x_i); check=False
        skips that device -> host round trip."""
        if len(xs) != len(ys) or len(xs) == 0:
            raise ValueError("need as many ys as xs, and at least one point")
        xs_d = _fr_tensor(xs, poly.device)
        ys_d = _fr_tensor(ys, poly.device)
        if check and FR.decode(poly.eval_many(xs_d)) != [y % R for y in ys]:
            raise BatchedPointsNotOnPolynomial("some (x_i, y_i) not on polynomial")
        z = vanishing_poly(xs_d)
        r = lagrange_interpolation(xs_d, ys_d)
        q = self._exact_div(poly - r, z, xs_int=[x % R for x in xs])
        w = msm_g1(_slice_srs(self.params.gs, q.num_coeffs()), q.trimmed())
        return KZGBatchWitness(r=r, w=w)

    @staticmethod
    def _exact_div(numerator: Polynomial, z: Polynomial, xs_int=None) -> Polynomial:
        """numerator / z, exact by the caller's evaluation check, by coset
        evaluation division. A batch point ON the coset g<omega_d> makes Z
        vanish there; then it falls back to long division. With xs_int
        (the points as host ints) that test is host arithmetic,
        x in g<omega_d> iff (x/g)^d == 1, so the device is never read."""
        n = numerator.num_coeffs()
        k = z.num_coeffs()
        if n < k:
            return Polynomial.new_zero(numerator.device)
        dom = Domain(max(1, (n - 1).bit_length()))
        ne = dom.coset_ntt(_pad_to(numerator.trimmed(), dom.d))
        ze = dom.coset_ntt(_pad_to(z.trimmed(), dom.d))
        if xs_int is not None:
            ginv = pow(FR_GENERATOR, -1, R)
            on_coset = any(pow(x * ginv % R, dom.d, R) == 1 for x in xs_int)
        else:
            on_coset = bool(FR.is_zero(ze).any())
        if on_coset:
            q, _ = numerator.long_division(z)
            return q
        q_evals = FR.mul(ne, FR.batch_inv(ze))
        return Polynomial(dom.coset_intt(q_evals)[..., : n - k + 1], n - k)


class KZGVerifier:
    """Stateless verifier borrowing the SRS (coeff_form.rs:114-183). Pairing
    checks run on the engine config.pairing_engine (or the per-verifier
    `engine`) names: "auto"/"host" = native C++ engine (oracle if it is
    missing), "device" = scalar multiplications, Miller loops and final
    exponentiation on the device (`kzg/engines.py`), "oracle" = pure
    Python."""

    def __init__(self, params: KZGParams, engine: str | None = None):
        self.params = params
        self.engine = engine
        self._g = g1_from_device(tuple(t[..., 0:1] for t in params.gs))[0]
        self._h = g2_from_device(tuple(t[..., 0:1] for t in params.hs))[0]
        self._hs1 = g2_from_device(tuple(t[..., 1:2] for t in params.hs))[0]

    def _engine(self) -> str:
        if self.engine is not None:
            return self.engine
        return get_config().pairing_engine

    def verify_poly(self, commitment, poly: Polynomial) -> bool:
        """Recommit and compare (coeff_form.rs:119-124)."""
        again = msm_g1(_slice_srs(self.params.gs, poly.num_coeffs()), poly.trimmed())
        return bool(G1.eq(commitment, again))

    def verify_eval(self, point, commitment, witness) -> bool:
        """e(w, h^s / h^x) == e(C / g^y, h)  (coeff_form.rs:126-142)."""
        with span("kzg.verify_eval"):
            x, y = point
            if self._engine() == "device":
                return verify_eval_device(self.params, x % R, y % R, commitment, witness)
            c_host = g1_from_device(tuple(t[..., None] for t in commitment))[0]
            w_host = g1_from_device(tuple(t[..., None] for t in witness))[0]
            s2 = ec_add(self._hs1, ec_neg(ec_mul(self._h, x % R)))  # h^(s - x)
            rhs_g1 = ec_add(c_host, ec_neg(ec_mul(self._g, y % R)))  # C - y*g
            # e(w, s2) * e(-(C - y g), h) == 1
            return multi_pairing_check(
                [(w_host, s2), (ec_neg(rhs_g1), self._h)], engine=self._engine()
            )

    def verify_eval_batched(self, commitment, batch_witness: KZGBatchWitness, xs) -> bool:
        """e(w, h^Z) == e(C / g^r, h) (coeff_form.rs:144-182). h^Z is a G2
        MSM over the k + 1 powers hs[..k] (the ladder below
        small_msm_threshold points); raises PolynomialDegreeTooLarge when
        the SRS holds fewer G2 powers."""
        z = vanishing_poly(_fr_tensor(xs, self.params.hs[0].device))
        if z.num_coeffs() > self.params.hs[0].shape[-1]:
            raise PolynomialDegreeTooLarge(
                f"batched verify at {len(xs)} points needs {z.num_coeffs()} "
                f"G2 powers, setup has {self.params.hs[0].shape[-1]}"
            )
        hz = msm_g2(tuple(t[..., : z.num_coeffs()] for t in self.params.hs), z.trimmed())
        r = batch_witness.r
        gr = msm_g1(_slice_srs(self.params.gs, r.num_coeffs()), r.trimmed())
        if self._engine() == "device":
            return verify_batched_device(self.params, commitment, batch_witness.w, hz, gr)
        hz_host = g2_from_device(tuple(t[..., None] for t in hz))[0]
        gr_host = g1_from_device(tuple(t[..., None] for t in gr))[0]
        c_host = g1_from_device(tuple(t[..., None] for t in commitment))[0]
        w_host = g1_from_device(tuple(t[..., None] for t in batch_witness.w))[0]
        lhs_g1 = ec_add(c_host, ec_neg(gr_host))
        return multi_pairing_check(
            [(w_host, hz_host), (ec_neg(lhs_g1), self._h)], engine=self._engine()
        )


def g1_compressed(point) -> bytes:
    """ZCash 48-byte encoding of one Jacobian G1 device point."""
    from ..compat.serialize import g1_compress

    return g1_compress(g1_from_device(tuple(t[..., None] for t in point))[0])


def g2_compressed(point) -> bytes:
    """ZCash 96-byte encoding of one Jacobian G2 device point."""
    from ..compat.serialize import g2_compress

    return g2_compress(g2_from_device(tuple(t[..., None] for t in point))[0])


__all__ = ["KZGBatchWitness", "KZGProver", "KZGVerifier", "g1_compressed", "g2_compressed"]
