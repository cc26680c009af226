"""The optimal ate pairing over BLS12-381 on the device (port of
`kzg_tpu/pairing/pairing.py`).

Structure of the oracle (`oracle/curve.py`): untwist G2 to E(Fp12), the
affine Miller loop f_{|x|,Q}(P) with the BLS x < 0 conjugation, then the
final exponentiation (the easy part by conjugation, inverse and Frobenius,
the hard part by the base-p decomposition of (p^4 - p^2 + 1) / r and one
joint ladder of cyclotomic squarings).

On a CUDA tensor the loop and the exponentiation are one launch each: the
`miller_loop` kernel (one block a pair) and the `final_exp` kernel (one
block an output; in product mode it first multiplies the Miller values of
its input together), `csrc/pairing.cuh`, running the programs that
`pairing/schedule.py` generates from the same formulas. On a CPU tensor
they are the plain versions, `miller_loop_plain` and `final_exp_plain`:
tensor code over the tower (`pairing/tower.py`: K1's and `field_pow`'s
plain twins), which on a card is the kernels' twin in the tests and the
smoke and nothing else.

The loop bits of |x| are a constant of the curve, so a Python branch on
each bit is the same function as the reference's select (`:124-140`) and
skips the chord step where the bit is 0. Everything is batched on the last
axis: `pairing_check_device` runs all Miller loops in lanes, multiplies
them together and shares one final exponentiation. Points at infinity
contribute 1 (the reference's select; the kernel skips their loop, the
plain version runs it on their words and drops its value).
"""

import math

import torch

from .. import kernels
from ..constants import BLS_X, P, R
from ..curve import cuda_ops
from ..fields import FP
from ..trace import span
from . import tower as tw

# ---------------------------------------------------------------------------
# untwist: w^-2, w^-3 as Fp12 constants (from the oracle tower, host ints)
# ---------------------------------------------------------------------------

_W_DEV = {}


def _w_consts(device):
    """(12, 12, 2): w^-2 and w^-3 stacked on `device`."""
    key = str(device)
    if key not in _W_DEV:
        from ..oracle.curve import _w_inv_powers

        _W_DEV[key] = torch.stack([tw.f12_from_oracle(c, device=device)
                                   for c in _w_inv_powers()], dim=2)
    return _W_DEV[key]


def _fp_to_f12(x):
    """Embed an Fp element (12, *batch) into Fp12."""
    out = tw.f12_zero(tuple(x.shape[1:]), x.device)
    out[:, 0] = x
    return out


def _fp2_to_f12(x):
    """Embed an Fp2 element (12, 2, *batch) into Fp12."""
    out = tw.f12_zero(tuple(x.shape[2:]), x.device)
    out[:, 0:2] = x
    return out


def untwist_device(xq, yq):
    """E'(Fp2) affine -> E(Fp12) affine: (x / w^2, y / w^3), both products
    in one `f12_mul`."""
    w = _w_consts(xq.device)
    w = w.reshape(tuple(w.shape) + (1,) * (xq.dim() - 2))
    out = tw.f12_mul(torch.stack([_fp2_to_f12(xq), _fp2_to_f12(yq)], dim=2), w)
    return out[:, :, 0], out[:, :, 1]


# ---------------------------------------------------------------------------
# Miller loop
# ---------------------------------------------------------------------------

# the bits of |x| below the top one, MSB first
LOOP_BITS = tuple((-BLS_X >> i) & 1 for i in range((-BLS_X).bit_length() - 2, -1, -1))


def _line_step(f, t, p, q=None):
    """One Miller step: with q None the tangent at t (f <- f^2 l_{T,T}(P),
    T <- 2T), else the chord through t and q (f <- f l_{T,Q}(P),
    T <- T + Q); lines evaluated at p, all points E(Fp12) affine
    (`_line_tangent`, `_line_chord`, `_ec_add_with_lambda` of the
    reference). Independent products share a launch: f^2 with x_t^2, the
    slope times (x_p - x_t) with the slope squared, f with the line and the
    slope with (x_t - x_3)."""
    xt, yt = t
    xp, yp = p
    if q is None:
        sq = tw.f12_sqr(torch.stack([f, xt], dim=2))
        f, x2 = sq[:, :, 0], sq[:, :, 1]
        num, den, other_x = FP.add(FP.add(x2, x2), x2), FP.add(yt, yt), xt
    else:
        num, den, other_x = FP.sub(q[1], yt), FP.sub(q[0], xt), q[0]
    lam = tw.f12_mul(num, tw.f12_inv(den))
    pr = tw.f12_mul(torch.stack([lam, lam], dim=2), torch.stack([FP.sub(xp, xt), lam], dim=2))
    ell = FP.sub(FP.sub(yp, yt), pr[:, :, 0])
    x3 = FP.sub(FP.sub(pr[:, :, 1], xt), other_x)
    pr = tw.f12_mul(torch.stack([f, lam], dim=2), torch.stack([ell, FP.sub(xt, x3)], dim=2))
    return pr[:, :, 0], (x3, FP.sub(pr[:, :, 1], yt))


def miller_loop_plain(p_aff, q_aff):
    """Plain version of the `miller_loop` kernel: f_{|x|,Q}(P), conjugated
    for x < 0, as tensor code over the tower. p_aff = (xp, yp) Fp
    coordinates (12, *batch); q_aff = (xq, yq) Fp2 coordinates (12, 2,
    *batch). Points must not be infinity (callers select those lanes
    away)."""
    q = untwist_device(*q_aff)
    p = (_fp_to_f12(p_aff[0]), _fp_to_f12(p_aff[1]))
    f = tw.f12_one(tuple(p_aff[0].shape[1:]), p_aff[0].device)
    t = q
    for bit in LOOP_BITS:
        f, t = _line_step(f, t, p)
        if bit:
            f, t = _line_step(f, t, p, q)
    return tw.f12_conj(f)


# ---------------------------------------------------------------------------
# final exponentiation
# ---------------------------------------------------------------------------

# base-p digits of the hard exponent: hard = sum_i HARD_BASE_P[i] p^i, so
# f^hard = prod (f^(p^i))^(h_i), one joint ladder over the Frobenius powers
HARD_EXP = (P ** 4 - P ** 2 + 1) // R
HARD_BASE_P = []
_h = HARD_EXP
while _h:
    HARD_BASE_P.append(_h % P)
    _h //= P
del _h
if len(HARD_BASE_P) != 4 or sum(h * P ** i for i, h in enumerate(HARD_BASE_P)) != HARD_EXP:
    raise ArithmeticError("the hard exponent's base-p digits do not recompose")


def final_exp_easy(f):
    """f^((p^6 - 1)(p^2 + 1)): conj * inv, then the p^2-Frobenius times f.
    The result lies in the cyclotomic subgroup."""
    f = tw.f12_mul(tw.f12_conj(f), tw.f12_inv(f))  # f^(p^6 - 1)
    return tw.f12_mul(tw.f12_frobenius(tw.f12_frobenius(f)), f)  # ^(p^2 + 1)


def final_exp_plain(f):
    """Plain version of the `final_exp` kernel: f^((p^12 - 1) / r), the easy
    part, then the hard part by the base-p Frobenius decomposition and the
    joint ladder with Granger-Scott cyclotomic squarings."""
    return tw.f12_joint_pow_frobenius(final_exp_easy(f), HARD_BASE_P)


def _product_plain(f, skip):
    """prod over the last axis of (12, 12, n), lanes under skip contributing
    1: a pairwise product tree."""
    if skip is not None:
        f = tw.f12_select(~skip, f, tw.f12_one(tuple(f.shape[2:]), f.device))
    while f.shape[-1] > 1:
        half = f.shape[-1] // 2
        prod = tw.f12_mul(f[..., :half], f[..., half:2 * half])
        f = torch.cat([prod, f[..., 2 * half:]], dim=-1)
    return f[..., 0]


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------

_MILLER = kernels.REGISTRY["miller_loop"]
_FINAL = kernels.REGISTRY["final_exp"]
_KERNEL_INPUTS = {}


def kernel_inputs(device):
    """The kernels' constant inputs on `device`, built once: the Miller and
    final-exponentiation programs' constants ((12, k) Montgomery words, the
    order of `schedule.miller_layout()` / `final_layout()`) and the joint
    ladder's bit columns of HARD_BASE_P (uint8, MSB first)."""
    key = str(device)
    if key not in _KERNEL_INPUTS:
        from . import schedule

        def words(layout):
            return torch.from_numpy(FP.encode(layout.consts)).to(device).contiguous()

        cols = schedule.hard_columns()
        if cols[0] == 0:
            raise ArithmeticError("the hard exponent's top bit column is empty")
        _KERNEL_INPUTS[key] = (words(schedule.miller_layout()), words(schedule.final_layout()),
                               torch.tensor(cols, dtype=torch.uint8, device=device))
    return _KERNEL_INPUTS[key]


def _skip_bytes(skip, batch, dev, what):
    if skip is None:
        return None
    if skip.dtype != torch.bool or skip.device != dev or tuple(skip.shape) != batch:
        raise kernels.KernelError(f"{what}: skip must be bool {batch} on {dev}")
    return skip.reshape(-1).contiguous().view(torch.uint8)


def miller_loop_device(p_aff, q_aff, skip=None):
    """f_{|x|,Q}(P), conjugated for x < 0, for affine batches p_aff = (xp,
    yp) of Fp coordinates (12, *batch) and q_aff = (xq, yq) of Fp2
    coordinates (12, 2, *batch): (12, 12, *batch). Lanes under `skip` (bool
    (*batch), the pairs with a point at infinity) give Fp12 one. One launch
    of the `miller_loop` kernel on a CUDA tensor, the plain version on a
    CPU tensor."""
    xp, yp = p_aff
    xq, yq = q_aff
    batch = tuple(xp.shape[1:])
    if cuda_ops._is_cpu(xp):
        f = miller_loop_plain(p_aff, q_aff)
        return f if skip is None else tw.f12_select(~skip, f, tw.f12_one(batch, xp.device))
    dev, n, w = xp.device, math.prod(batch), FP.W
    ops = ([cuda_ops._coord(t, dev, n, "miller_loop") for t in (xp, yp)]
           + [cuda_ops._coord(t, dev, n, "miller_loop", (w, 2)) for t in (xq, yq)])
    mask = _skip_bytes(skip, batch, dev, "miller_loop")
    out = torch.empty((w, 12, n), dtype=torch.int32, device=dev)
    if n:
        consts = kernel_inputs(dev)[0]
        rc = kernels.library().kzg_miller_loop(
            out.data_ptr(), *(t.data_ptr() for t in ops),
            None if mask is None else mask.data_ptr(), consts.data_ptr(), n,
            kernels.stream_handle(dev))
        kernels.check_status(rc, "miller_loop")
        _MILLER.count()
    return out.reshape((w, 12) + batch)


def _final_exp(f, skip, product):
    batch = tuple(f.shape[2:])
    dev, n, w = f.device, math.prod(batch), FP.W
    flat = cuda_ops._coord(f, dev, n, "final_exp", (w, 12))
    mask = _skip_bytes(skip, batch, dev, "final_exp")
    out = torch.empty((w, 12, 1 if product else n), dtype=torch.int32, device=dev)
    if n:
        _, consts, cols = kernel_inputs(dev)
        rc = kernels.library().kzg_final_exp(
            out.data_ptr(), flat.data_ptr(), None if mask is None else mask.data_ptr(),
            cols.data_ptr(), cols.numel(), consts.data_ptr(), n, int(product),
            kernels.stream_handle(dev))
        kernels.check_status(rc, "final_exp")
        _FINAL.count()
    elif product:
        out = tw.f12_one((1,), dev)
    return out[..., 0] if product else out.reshape((w, 12) + batch)


def final_exp_device(f):
    """f^((p^12 - 1) / r) of every lane of f (12, 12, *batch): one launch of
    the `final_exp` kernel, a block a lane, on a CUDA tensor; the plain
    version on a CPU tensor."""
    if cuda_ops._is_cpu(f):
        return final_exp_plain(f)
    return _final_exp(f, None, False)


def final_exp_product(f, skip=None):
    """(prod_i f_i)^((p^12 - 1) / r) over the last axis of f (12, 12, n),
    the lanes under `skip` (bool (n,)) contributing 1: one (12, 12) Gt
    element. One launch of the `final_exp` kernel in product mode on a CUDA
    tensor; on a CPU tensor a pairwise product tree and the plain version."""
    if cuda_ops._is_cpu(f):
        return final_exp_plain(_product_plain(f, skip))
    return _final_exp(f, skip, True)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def _pairing_product(xp, yp, p_inf, xq, yq, q_inf):
    """prod_i e(P_i, Q_i) over the last axis, infinity pairs contributing
    1: every Miller loop in lanes, their product and one final
    exponentiation (two launches on a card). Returns one (12, 12) Gt
    element."""
    skip = p_inf | q_inf
    with span("pairing.miller_loop"):
        f = miller_loop_device((xp, yp), (xq, yq), skip)
    with span("pairing.final_exp"):
        return final_exp_product(f, skip)


def pairing_check_device(g1_points, g2_points) -> bool:
    """True iff prod e(P_i, Q_i) == 1. g1_points = (x, y, inf), an Fp
    affine batch (12, n); g2_points = (x, y, inf), an Fp2 affine batch
    (12, 2, n). The verdict is one boolean read from the device."""
    out = _pairing_product(g1_points[0], g1_points[1], g1_points[2],
                           g2_points[0], g2_points[1], g2_points[2])
    with span("pairing.read"):
        return bool(tw.f12_is_one(out))


def pairing_device(p_aff, q_aff):
    """e(P, Q) for affine batches p_aff = (x, y) (12, *batch) and q_aff =
    (x, y) (12, 2, *batch) of points that are not infinity: (12, 12,
    *batch) Gt elements."""
    return final_exp_device(miller_loop_device(p_aff, q_aff))


__all__ = ["miller_loop_device", "miller_loop_plain", "final_exp_device", "final_exp_plain",
           "final_exp_product", "final_exp_easy", "pairing_device", "pairing_check_device",
           "untwist_device", "kernel_inputs"]
