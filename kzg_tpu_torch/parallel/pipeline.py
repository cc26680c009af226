"""Sharded end-to-end KZG steps (port of `kzg_tpu/parallel/pipeline.py`):
commit + evaluate + witness for a degree-(2^exp - 1) polynomial, the
coefficients and SRS block-split over one mesh axis. BASELINE.json config
5's shape (multi-host commit + witness = sharded Pippenger + all_to_all
NTT).

Per step, for coefficients f split over the ranks and an opening point x:
  1. C = MSM(gs, f)                 sharded Pippenger, all_gather join
  2. y = f(x)                       each rank's block by Horner (`fr_horner`'s
                                    remainder) times x^(d * blk), then an
                                    all_gather join
  3. q = (f - y) / (X - x) by coset evaluation division in TRANSPOSED NTT
     order: coset_ntt_t(f), subtract y, multiply by 1/(coset_k - x) (local
     batch inversion), coset_intt_t -> quotient coefficients. The divisor
     never vanishes on the coset unless x = g omega^k.
  4. W = MSM(gs, q)

Each `make_*` returns a plain callable over this rank's blocks whose
outputs are the same on every rank, and `.shard(t)` to cut a rank's block
out of a replicated array. The JAX package builds omega^d, g^(d blk) and
x^(d blk) from the traced axis index with `pow_dynamic`; the rank is a host
integer here, so the first two are host constants and x^(d blk) is one
`pow_static` (kernel `field_pow`). The JAX package's `FR.dot` against a
2^exp-wide row of powers of x becomes Horner on the block, the same field
element without that row.
"""

import torch

from ..constants import FR_GENERATOR, R as FR_MOD
from ..curve import G1
from ..fields import FR
from ..msm.pippenger import pick_window
from ..ntt.domain import compute_omega
from ..poly import lagrange_interpolation, vanishing_poly
from ..poly.polynomial import _eval_many
from .msm import gather_last, local_msm_join
from .ntt import _split, coset_scale_local, four_step_dif, four_step_dit, geom_row, prebuild_domains
from .runtime import MeshAxis, block, mesh_axis


def _sum_over_ranks(local: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """The field sum over the ranks of an (8, k) array, on every rank."""
    return FR.sum_last(gather_last(local, axis))


def _eval_many_local(coeffs_local, xs_mont, exp: int, axis: MeshAxis):
    """f(x_i) for replicated points xs (8, k) with block-split coefficients:
    this rank's block by Horner times x^(d blk), summed over the ranks.
    Returns (8, k) on every rank."""
    blk = (1 << exp) // axis.size
    local = FR.mul(_eval_many(coeffs_local, xs_mont), FR.pow_static(xs_mont, axis.rank * blk))
    return _sum_over_ranks(local, axis)


def _coset_points_local_t(exp: int, axis: MeshAxis, device):
    """(8, n / R) coset points g omega^k at this rank's TRANSPOSED-order
    evaluation indices k = d + R k2."""
    n, r, log_r, c, c_local, omega = _split(exp, axis.size)
    return geom_row(pow(omega, r, FR_MOD), FR_GENERATOR * pow(omega, axis.rank, FR_MOD),
                    c, device)


def _coset_evals_t(x_local, exp: int, axis: MeshAxis):
    """x's evaluations on the coset g<omega>, transposed order."""
    return four_step_dif(coset_scale_local(x_local, exp, axis, False), exp, axis, False,
                         "transposed")


def _coset_interp(evals_t, exp: int, axis: MeshAxis):
    """Coefficients (this rank's standard-order block) from coset
    evaluations in transposed order."""
    return coset_scale_local(four_step_dit(evals_t, exp, axis, True), exp, axis, True)


def _replicated_slice0(coeffs, blk: int, axis: MeshAxis):
    """Block-split a small replicated (8, m) coefficient array (m <= blk):
    rank 0 holds it zero-padded to blk, every other rank zeros."""
    out = coeffs.new_zeros((FR.W, blk))
    if axis.rank == 0:
        out[:, :coeffs.shape[-1]] = coeffs
    return out


def _with_shard(fn, axis: MeshAxis):
    fn.shard = lambda t: block(t, axis)
    return fn


def make_commit_witness_step(mesh, axis_name: str, exp: int, msm_window: int | None = None):
    """Sharded single opening: step(gs_x, gs_y, gs_inf, coeffs, x_mont) ->
    (commit_jac, y_mont (8, 1), witness_jac). The points and coefficients
    are this rank's blocks of their last axis, x (8, 1) is the same on
    every rank, and so are the outputs."""
    axis = mesh_axis(mesh, axis_name)
    c = msm_window if msm_window is not None else pick_window((1 << exp) // axis.size)
    prebuild_domains(exp, axis.size)

    def step(gx, gy, ginf, coeffs, x_mont):
        commit = local_msm_join(G1, axis, (gx, gy, ginf), coeffs, c)
        y = _eval_many_local(coeffs, x_mont, exp, axis)
        denom = FR.sub(_coset_points_local_t(exp, axis, coeffs.device), x_mont)
        fe = _coset_evals_t(coeffs, exp, axis)
        q_e = FR.mul(FR.sub(fe, y), FR.batch_inv(denom))  # (f(coset_k) - y) / (coset_k - x)
        del fe, denom
        q = _coset_interp(q_e, exp, axis)
        del q_e
        wit = local_msm_join(G1, axis, (gx, gy, ginf), q, c)
        return commit, y, wit

    return _with_shard(step, axis)


def make_batched_witness_step(mesh, axis_name: str, exp: int, k: int,
                              msm_window: int | None = None):
    """Sharded BATCHED opening (BASELINE config 3 at scale; reference
    create_witness_batched, coeff_form.rs:83-111): step(gs_x, gs_y, gs_inf,
    coeffs, xs_mont (8, k)) -> (commit_jac, ys_mont (8, k), r_coeffs (8, k),
    witness_jac).

    The interpolated remainder r and the vanishing Z are k-sized and the
    same on every rank; the quotient (f - r) / Z is the sharded coset
    evaluation division with both f - r and Z through the transposed
    four-step NTT. Needs k < n / R."""
    axis = mesh_axis(mesh, axis_name)
    blk = (1 << exp) // axis.size
    if k + 1 > blk:
        raise ValueError(f"{k} points do not fit in one coefficient block of {blk}")
    c = msm_window if msm_window is not None else pick_window(blk)
    prebuild_domains(exp, axis.size)

    def step(gx, gy, ginf, coeffs, xs_mont):
        commit = local_msm_join(G1, axis, (gx, gy, ginf), coeffs, c)
        ys = _eval_many_local(coeffs, xs_mont, exp, axis)
        z = vanishing_poly(xs_mont)  # degree k
        r = lagrange_interpolation(xs_mont, ys)  # degree k - 1
        num = FR.sub(coeffs, _replicated_slice0(r.trimmed(), blk, axis))
        ze = _coset_evals_t(_replicated_slice0(z.trimmed(), blk, axis), exp, axis)
        q_e = FR.mul(_coset_evals_t(num, exp, axis), FR.batch_inv(ze))
        del num, ze
        q = _coset_interp(q_e, exp, axis)
        del q_e
        wit = local_msm_join(G1, axis, (gx, gy, ginf), q, c)
        return commit, ys, r.trimmed(), wit

    return _with_shard(step, axis)


def make_eval_form_step(mesh, axis_name: str, exp: int, m: int,
                        msm_window: int | None = None):
    """Sharded EVALUATION-FORM commit + witness at domain index m (reference
    eval_form.rs:114-140; div_by_omega_i local to each rank plus two small
    joins): step(lg_x, lg_y, lg_inf, evals) -> (commit_jac, y_mont (8, 1),
    witness_jac). The Lagrange-basis points and the evaluations are this
    rank's blocks."""
    axis = mesh_axis(mesh, axis_name)
    n = 1 << exp
    blk = n // axis.size
    c = msm_window if msm_window is not None else pick_window(blk)
    omega, _, _ = compute_omega(n)
    wm = pow(omega, m, FR_MOD)
    wm_inv_words = FR.encode([pow(wm, -1, FR_MOD)])[:, 0]
    owner, m_local = divmod(m, blk)

    def step(lx, ly, linf, evals):
        dev = evals.device
        commit = local_msm_join(G1, axis, (lx, ly, linf), evals, c)
        opow = geom_row(omega, pow(omega, axis.rank * blk, FR_MOD), blk, dev)  # omega^j
        # y = evals[m], held by one rank
        local_y = (evals[:, m_local:m_local + 1] if axis.rank == owner
                   else evals.new_zeros((FR.W, 1)))
        y = _sum_over_ranks(local_y, axis)
        num = FR.sub(evals, y)
        dinv = FR.batch_inv(FR.sub(opow, torch.from_numpy(FR.encode([wm])).to(dev)))  # 0 at m
        q = FR.mul(num, dinv)
        # the diagonal term q_m = -(sum_j num_j omega^j dinv_j) omega^-m
        total = _sum_over_ranks(FR.sum_last(FR.mul(FR.mul(num, opow), dinv))[:, None], axis)
        if axis.rank == owner:
            q[:, m_local] = FR.neg(FR.mul_const(total, wm_inv_words))[:, 0]
        wit = local_msm_join(G1, axis, (lx, ly, linf), q, c)
        return commit, y, wit

    return _with_shard(step, axis)
