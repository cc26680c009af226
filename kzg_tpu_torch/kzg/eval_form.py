"""Evaluation-form (Lagrange-basis) KZG prover and verifier (port of
`kzg_tpu/kzg/eval_form.py`).

  * the in-domain quotient `_div_by_omega_i` is fully vectorised: one batch
    inversion and elementwise multiplies (kernel K1);
  * the Lagrange SRS is computed in O(d log d) group work as an inverse NTT
    over the SRS points (`_group_intt`): butterflies are point adds (K2),
    twiddle multiplications are per-lane digit ladders
    (`CurveOps.scalar_mul_digits`: doublings on K2, table madds on K6), for
    G1 and for G2; when the setup secret is available (testing / csprng
    setups) the L_i(s) scalars are computed directly and the points come
    from the two fixed-base ladders of device setup (`kzg/srs.py`), or from
    the host engine, by the same engine choice as `setup`;
  * commit and witness are one G1 Pippenger MSM over the Lagrange basis
    (the bucket loop on K7 below 2^15 points, K3 from there; K4); the
    all-points check runs a G2 Pippenger MSM over it (the same kernels'
    Fp2 instantiations);
  * create_witness_all returns the identity point: opening at every domain
    point has quotient 0;
  * pairing checks run on the engine config.pairing_engine names, as in
    coeff_form.py: a host engine or the device engine (`kzg/engines.py`).
"""

from dataclasses import dataclass

import numpy as np
import torch

from ..config import get_config, resolve_device
from ..constants import R
from ..curve import G1, G2, g1_from_device, g1_to_device, g2_from_device, g2_to_device
from ..fields import FR
from ..hostcrypto import multi_pairing_check
from ..msm import msm_g1, msm_g2
from ..msm.pippenger import _digits, _host_digits_msb, _std_digits_msb
from ..ntt import Domain
from ..ntt.domain import compute_omega
from ..oracle import ec_add, ec_mul, ec_neg
from .engines import verify_batched_device, verify_eval_device
from .errors import PolynomialDegreeTooLarge
from .srs import (
    KZGParams, _fb_window, _from_limbs16, _ladders, _mask, _to_limbs16, host_engine_preferred,
)


@dataclass
class LagrangeSRS:
    """g^{L_i(s)} and h^{L_i(s)} for the 2^exp domain, as affine batches
    (x, y, inf): (12, d) words for G1, (12, 2, d) for G2."""

    lg: tuple
    lh: tuple
    exp: int

    def save(self, path: str):
        """Persist the (expensive) Lagrange-basis precompute in the JAX
        package's `.npz` layout (16-bit limbs in uint32, its
        `eval_form.py:48-66`), so either package loads the other's file."""
        np.savez(
            path,
            lg_x=_to_limbs16(self.lg[0]), lg_y=_to_limbs16(self.lg[1]),
            lg_i=self.lg[2].cpu().numpy(),
            lh_x=_to_limbs16(self.lh[0]), lh_y=_to_limbs16(self.lh[1]),
            lh_i=self.lh[2].cpu().numpy(),
            exp=self.exp,
        )

    @classmethod
    def from_numpy(cls, lg_np, lh_np, exp: int, device=None) -> "LagrangeSRS":
        """From the JAX package's arrays: lg_np = ((24, d) x, (24, d) y,
        (d,) inf), lh_np = ((24, 2, d) x, (24, 2, d) y, (d,) inf), limbs as
        uint32 16-bit values. device=None: the configured default."""

        def batch(t):
            return (_from_limbs16(np.asarray(t[0]), device),
                    _from_limbs16(np.asarray(t[1]), device), _mask(t[2], device))

        return cls(lg=batch(lg_np), lh=batch(lh_np), exp=int(exp))

    @classmethod
    def load(cls, path: str, device=None) -> "LagrangeSRS":
        with np.load(path if path.endswith(".npz") else path + ".npz") as z:
            lg = tuple(z[k] for k in ("lg_x", "lg_y", "lg_i"))
            lh = tuple(z[k] for k in ("lh_x", "lh_y", "lh_i"))
            exp = int(z["exp"])
        return cls.from_numpy(lg, lh, exp, device)


@dataclass
class KZGBatchWitnessEvalForm:
    """All-points opening witness (reference eval_form.rs:16-37): r is the
    evaluation vector itself, (8, d) words; w is the identity."""

    r: torch.Tensor
    w: tuple


# --------------------------------------------------------------------------
# Lagrange SRS construction
# --------------------------------------------------------------------------


def _group_intt(curve, points, dom: Domain, force_split: bool = False):
    """Inverse NTT whose butterflies are point adds and whose twiddle
    multiplications are per-lane scalar multiplications: O(d log d) group
    ops. points: affine batch (x, y, inf) of length d on one device;
    returns a Jacobian batch of length d.

    Each stage splits the batch into halves a, b, forms u = a + b and
    v = (a - b) * omega^-(j & ~(2^s - 1)) with the windowed digit ladder
    (curve.scalar_mul_digits, config.group_ladder_window) and interleaves
    u, v: the Pease layout of `Domain`, bit-reversed at the end. Small
    domains read a dense MSB-first digit table of omega^-t; big domains
    (exp >= ntt.domain._BIG_TABLE_EXP, or force_split) build each stage's
    twiddle VALUES from two O(sqrt n) split tables, omega^-t =
    HI[t >> sc] * LO[t & (2^sc - 1)], and extract the digit rows on the
    device. The final scale by 1/d is one more ladder with a broadcast digit
    column."""
    d = dom.d
    dev = points[0].device
    f = curve.f
    zcoord = torch.where(f.expand(points[2]), f.zeros((d,), dev), f.one((d,), dev))
    p = (points[0], points[1], zcoord)
    if d == 1:
        return p
    h = d // 2
    c = get_config().group_ladder_window
    w_count = -(-255 // c)
    jidx = torch.arange(h, device=dev)
    if dom.split is None and not force_split:
        # dense MSB-first digit table of omega^{-t}, t < h: (W, h)
        tw_std = FR.from_mont(dom._table("tw_inv", dev))
        digits_tbl = _std_digits_msb(tw_std, c, w_count)

        def stage_digits(s):
            return digits_tbl[:, jidx & ~((1 << s) - 1)]
    else:
        # split twiddle tables (Montgomery form), O(sqrt(h)) each
        sc = max(1, (dom.exp - 1) // 2)
        smask = (1 << sc) - 1
        hi = torch.from_numpy(Domain._powers_step(dom.omega_inv, 1 << sc, h >> sc)).to(dev)
        lo = torch.from_numpy(Domain._powers(dom.omega_inv, 1 << sc)).to(dev)

        def stage_digits(s):
            tv = jidx & ~((1 << s) - 1)
            w_m = FR.mul(hi[:, tv >> sc], lo[:, tv & smask])
            return _std_digits_msb(FR.from_mont(w_m), c, w_count)

    for s in range(dom.exp):
        a = tuple(t[..., :h] for t in p)
        b = tuple(t[..., h:] for t in p)
        u = curve.add(a, b)
        v = curve.scalar_mul_digits(curve.add(a, curve.neg(b)), stage_digits(s), c)
        p = tuple(
            torch.stack([uu, vv], dim=-1).reshape(uu.shape[:-1] + (d,)) for uu, vv in zip(u, v)
        )
    if dom.split is None:
        rev = dom._table("bitrev", dev)
    else:
        idx = torch.arange(d, device=dev)
        rev = torch.zeros_like(idx)
        for bit in range(dom.exp):
            rev = rev | (((idx >> bit) & 1) << (dom.exp - 1 - bit))
    p = tuple(torch.index_select(t, -1, rev) for t in p)
    # scale by 1/d: scalar mul of every lane by the same constant
    column = torch.tensor(_host_digits_msb(pow(d, -1, R), c), device=dev)[:, None]
    return curve.scalar_mul_digits(p, column.expand(-1, d), c)


def compute_lagrange_basis(params: KZGParams, exp: int) -> LagrangeSRS:
    """Trusted-setup path: the group iNTT over the first 2^exp SRS powers,
    G1 and G2, on the SRS's device (no secret needed). O(d log d) group ops
    where the reference constructs every L_i and commits it
    (eval_form.rs:254-280)."""
    dom = Domain(exp)
    d = dom.d
    if d > params.n:
        raise PolynomialDegreeTooLarge(f"SRS has {params.n} < 2^{exp} powers")
    gsl = tuple(t[..., :d] for t in params.gs)
    hsl = tuple(t[..., :d] for t in params.hs)
    lg = G1.to_affine(_group_intt(G1, gsl, dom))
    lh = G2.to_affine(_group_intt(G2, hsl, dom))
    return LagrangeSRS(lg=lg, lh=lh, exp=exp)


def _omega_powers(dom: Domain, w: int, device) -> torch.Tensor:
    """[1, w, ..., w^(d-1)] as (8, d) Montgomery words: a running product
    on the device, as the reference's prefix_mul of a broadcast column."""
    col = torch.from_numpy(FR.encode([w])).to(device)
    pw = FR.powers(col[:, 0], dom.d)
    return torch.cat([FR.one((1,), device), pw[:, : dom.d - 1]], dim=1)


def lagrange_polynomials(exp: int, device=None) -> torch.Tensor:
    """Coefficient arrays of ALL Lagrange basis polynomials over the 2^exp
    domain as one (8, d, d) batch: [:, i, j] = coeff_j(L_i) = omega^{-ij}/d
    (the inverse-DFT matrix). Closed form replacing the reference's explicit
    O(d^2 M(d)) product construction (eval_form.rs:221-251)."""
    dev = resolve_device(device)
    dom = Domain(exp)
    d = dom.d
    winv_pows = _omega_powers(dom, pow(dom.omega, -1, R), dev)
    idx = (np.arange(d)[:, None] * np.arange(d)[None, :]) % d  # (i*j) mod d
    mat = winv_pows[:, torch.from_numpy(idx).to(dev)]  # (8, d, d)
    return FR.mul_const(mat, FR.encode([pow(d, -1, R)])[:, 0])


def compute_lagrange_basis_and_polynomials(params: KZGParams, exp: int):
    """Reference compute_lagrange_basis_and_polynomials (eval_form.rs:
    221-251): the Lagrange SRS plus the L_i polynomials themselves (the
    batched coefficient array of lagrange_polynomials)."""
    return (compute_lagrange_basis(params, exp),
            lagrange_polynomials(exp, params.gs[0].device))


def _lagrange_scalars(exp: int, c: int, s_mont: torch.Tensor) -> torch.Tensor:
    """(W, d) window digits of L_i(s) = (s^d - 1) omega^i / (d (s - omega^i))
    for all i, from s as an (8, 1) Montgomery column, on its device."""
    dom = Domain(exp)
    d = dom.d
    dev = s_mont.device
    omega_pows = _omega_powers(dom, dom.omega, dev)
    zs = FR.sub(FR.pow_static(s_mont, d), FR.one((1,), dev))  # s^d - 1
    denom = FR.sub(s_mont.expand(FR.W, d), omega_pows)
    li = FR.mul(FR.mul(zs, omega_pows), FR.batch_inv(denom))
    li = FR.mul_const(li, FR.encode([pow(d, -1, R)])[:, 0])
    return _digits(FR.from_mont(li), c)


def compute_lagrange_basis_from_secret(s: int, exp: int, device=None) -> LagrangeSRS:
    """Fast path when the setup secret is known (test / csprng setups): the
    L_i(s) scalars directly, then the two fixed-base ladders of device setup
    on `device`. Where `srs.host_engine_preferred` picks the host engine
    (the same rule as `setup`: the CPU under "auto", or "host"), the scalars
    are host ints and the points come from the native engine."""
    if host_engine_preferred(device):
        return _lagrange_basis_host(s, exp, device)
    c = _fb_window()
    s_mont = torch.from_numpy(FR.encode([s % R])).to(resolve_device(device))
    lg, lh = _ladders(c, _lagrange_scalars(exp, c, s_mont))
    return LagrangeSRS(lg=lg, lh=lh, exp=exp)


def _lagrange_basis_host(s: int, exp: int, device=None) -> LagrangeSRS:
    """L_i(s) = omega^i (s^d - 1) / (d (s - omega^i)) with Python ints,
    points via the native engine."""
    from .. import native
    from ..oracle import g1_generator, g2_generator

    d = 1 << exp
    omega, _, _ = compute_omega(d)
    s %= R
    sd = (pow(s, d, R) - 1) % R
    dinv = pow(d, -1, R)
    wi = 1
    gpts, hpts = [], []
    g, h = g1_generator(), g2_generator()
    for _ in range(d):
        li = sd * wi % R * pow((s - wi) % R, -1, R) % R * dinv % R
        gpts.append(native.g1_mul(g, li))
        hpts.append(native.g2_mul(h, li))
        wi = wi * omega % R
    gx, gy, _ = g1_to_device(gpts, device)
    hx, hy, _ = g2_to_device(hpts, device)
    lg = (gx, gy, _mask([p is None for p in gpts], device))
    lh = (hx, hy, _mask([p is None for p in hpts], device))
    return LagrangeSRS(lg=lg, lh=lh, exp=exp)


# --------------------------------------------------------------------------
# div_by_omega_i (reference eval_form.rs:58-84), fully vectorised
# --------------------------------------------------------------------------


def _div_by_omega_i(exp: int, evals: torch.Tensor, m: int) -> torch.Tensor:
    """q = (f - f(omega^m)) / (X - omega^m) in evaluation form.

    q_j = f_j / (omega^j - omega^m)                    for j != m
    q_m = sum_{i != m} f_i omega^{i-m} / (omega^m - omega^i)
    (the reference's a_i = d*omega^{-i} weights reduce to omega^{i-m}).
    Relies on batch_inv(0) == 0 for the j == m lane."""
    dom = Domain(exp)
    d = dom.d
    omega_pows = _omega_powers(dom, dom.omega, evals.device)
    wm = omega_pows[:, m:m + 1]  # omega^m
    denom = FR.sub(omega_pows, wm)  # omega^j - omega^m (0 at j = m)
    dinv = FR.batch_inv(denom)  # 0 at j = m
    q = FR.mul(evals, dinv)
    # diagonal term: q_m = - sum_i f_i * omega^i * omega^{-m} * dinv_i
    wm_inv = FR.batch_inv(wm)
    terms = FR.mul(FR.mul(evals, omega_pows), dinv)
    qm = FR.neg(FR.mul(FR.sum_last(terms), wm_inv[:, 0]))
    idx = torch.arange(d, device=evals.device)
    return torch.where((idx == m)[None], qm[:, None], q)


# --------------------------------------------------------------------------
# prover / verifier
# --------------------------------------------------------------------------


class KZGProverEvalForm:
    """Operates directly on evaluations over the omega-domain: commits
    without any iNTT (reference eval_form.rs:40-147)."""

    def __init__(self, params: KZGParams, lagrange: LagrangeSRS):
        self.params = params
        self.lagrange = lagrange
        self.dom = Domain(lagrange.exp)

    @property
    def d(self):
        return self.dom.d

    def commit(self, evals):
        """C = MSM(lagrange_basis_g, evals)  (eval_form.rs:114-122)."""
        assert evals.shape[-1] == self.d
        return msm_g1(self.lagrange.lg, evals)

    def create_witness(self, evals, i: int):
        """Witness for f(omega^i) = evals[i]: subtract y_i pointwise, divide
        by (X - omega^i) in evaluation form, commit (eval_form.rs:124-140)."""
        numerator = FR.sub(evals, evals[..., i:i + 1])
        q = _div_by_omega_i(self.lagrange.exp, numerator, i)
        return msm_g1(self.lagrange.lg, q)

    def create_witness_all(self) -> tuple:
        """Opening at ALL domain points: the quotient is identically zero, so
        the witness is the identity point (eval_form.rs:142-146)."""
        return G1.infinity((), self.lagrange.lg[0].device)


class KZGVerifierEvalForm:
    """Reference eval_form.rs:149-218. Pairing engine selection as in
    KZGVerifier (config.pairing_engine or the per-verifier override)."""

    def __init__(self, params: KZGParams, lagrange: LagrangeSRS,
                 engine: str | None = None):
        self.params = params
        self.lagrange = lagrange
        self.engine = engine
        self.dom = Domain(lagrange.exp)
        self._g = g1_from_device(tuple(t[..., 0:1] for t in params.gs))[0]
        self._h = g2_from_device(tuple(t[..., 0:1] for t in params.hs))[0]
        self._hs1 = g2_from_device(tuple(t[..., 1:2] for t in params.hs))[0]

    def _engine(self) -> str:
        if self.engine is not None:
            return self.engine
        return get_config().pairing_engine

    def verify_poly(self, commitment, evals) -> bool:
        """iNTT to coefficients, recommit against the monomial SRS
        (eval_form.rs:162-171)."""
        coeffs = self.dom.intt(evals)
        again = msm_g1(tuple(t[..., : self.dom.d] for t in self.params.gs), coeffs)
        return bool(G1.eq(commitment, again))

    def verify_eval(self, point, commitment, witness) -> bool:
        """Pairing check at x = omega^i (eval_form.rs:173-190)."""
        i, y = point
        x = pow(self.dom.omega, i, R)
        if self._engine() == "device":
            return verify_eval_device(self.params, x, y % R, commitment, witness)
        c_host = g1_from_device(tuple(t[..., None] for t in commitment))[0]
        w_host = g1_from_device(tuple(t[..., None] for t in witness))[0]
        s2 = ec_add(self._hs1, ec_neg(ec_mul(self._h, x)))
        rhs_g1 = ec_add(c_host, ec_neg(ec_mul(self._g, y % R)))
        return multi_pairing_check(
            [(w_host, s2), (ec_neg(rhs_g1), self._h)], engine=self._engine()
        )

    def verify_eval_all(self, commitment, witness: KZGBatchWitnessEvalForm) -> bool:
        """Batched all-points check (eval_form.rs:193-218). With the identity
        witness the pairing degenerates and this reduces to C == g^r; the
        full pairing form is kept for parity, including the reference's
        z = -L_0 + L_{d-1} Lagrange vector (eval_form.rs:199-202), harmless
        for exactly that reason. h^z is a G2 MSM over all d Lagrange points
        (G2 Pippenger at d >= small_msm_threshold)."""
        d = self.dom.d
        dev = self.lagrange.lh[0].device
        z = FR.zeros((d,), dev)
        one = FR.one((), dev)
        z[:, 0] = FR.neg(one)
        z[:, d - 1] = one
        hz = msm_g2(self.lagrange.lh, z)
        gr = msm_g1(self.lagrange.lg, witness.r)
        if self._engine() == "device":
            return verify_batched_device(self.params, commitment, witness.w, hz, gr)
        hz_host = g2_from_device(tuple(t[..., None] for t in hz))[0]
        gr_host = g1_from_device(tuple(t[..., None] for t in gr))[0]
        c_host = g1_from_device(tuple(t[..., None] for t in commitment))[0]
        w_host = g1_from_device(tuple(t[..., None] for t in witness.w))[0]
        lhs_g1 = ec_add(c_host, ec_neg(gr_host))
        return multi_pairing_check(
            [(w_host, hz_host), (ec_neg(lhs_g1), self._h)], engine=self._engine()
        )


__all__ = [
    "LagrangeSRS", "KZGBatchWitnessEvalForm", "KZGProverEvalForm", "KZGVerifierEvalForm",
    "compute_lagrange_basis", "compute_lagrange_basis_from_secret",
    "compute_lagrange_basis_and_polynomials", "lagrange_polynomials",
]
