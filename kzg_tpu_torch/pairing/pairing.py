"""The optimal ate pairing over BLS12-381 on the device (port of
`kzg_tpu/pairing/pairing.py`).

Structure of the oracle (`oracle/curve.py`): untwist G2 to E(Fp12), the
affine Miller loop f_{|x|,Q}(P) with the BLS x < 0 conjugation, then the
final exponentiation (the easy part by conjugation, inverse and Frobenius,
the hard part by the base-p decomposition of (p^4 - p^2 + 1) / r and one
joint ladder of cyclotomic squarings). The port's Miller loop keeps T in
homogeneous projective coordinates on the twist E'(Fp2) and scales each
line by an Fp2 factor, so it runs no inverse; its value is the oracle's
times an element of Fp2, which the easy part sends to 1, so every pairing
equals the oracle's.

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
# Miller loop
# ---------------------------------------------------------------------------

# the bits of |x| below the top one, MSB first
LOOP_BITS = tuple((-BLS_X >> i) & 1 for i in range((-BLS_X).bit_length() - 2, -1, -1))


def _small(x, k: int):
    """k x for a small k > 0: doublings and adds."""
    out = None
    while k:
        if k & 1:
            out = x if out is None else FP.add(out, x)
        k >>= 1
        if k:
            x = FP.add(x, x)
    return out


def _sparse_line(c0, c3, c5):
    """c0 + c3 w^3 + c5 w^5 (Fp2 coefficients (12, 2, *batch)) as an Fp12:
    c3 at w v, c5 at w v^2."""
    out = tw.f12_zero(tuple(c0.shape[2:]), c0.device)
    out[:, 0:2], out[:, 8:10], out[:, 10:12] = c0, c3, c5
    return out


def _line_dbl(t, p):
    """The tangent at T = (X, Y, Z), homogeneous projective on the twist
    E'(Fp2): y^2 = x^3 + 4 xi, at the affine P: (line, 2T), the formulas of
    `schedule.line_dbl`. The line is the reference's affine l_{T,T}(P) on
    the untwisted points times 2 Y Z xi, an Fp2 factor that the final
    exponentiation sends to 1; no inverse. Independent products share a
    launch."""
    x, y, z = t
    xp, yp = p
    pr = tw.f2_mul(torch.stack([y, z, y, x, x], 2), torch.stack([y, z, z, x, y], 2))
    b, c, d, x2, xy = pr.unbind(2)
    e = _small(tw.f2_mul_xi(c), 12)
    f = _small(e, 3)
    d2, g, e2 = FP.add(d, d), FP.add(b, f), FP.add(e, e)
    pr = tw.f2_mul(torch.stack([FP.add(xy, xy), g, e2, b], 2),
                   torch.stack([FP.sub(b, f), g, e2, _small(d2, 4)], 2))
    x3, y3 = pr[:, :, 0], FP.sub(pr[:, :, 1], _small(pr[:, :, 2], 3))
    s = FP.mul(torch.stack([tw.f2_mul_xi(d2), _small(x2, 3)], 2),
               torch.stack([yp, xp], 1)[:, None])
    return _sparse_line(s[:, :, 0], FP.sub(b, e), FP.neg(s[:, :, 1])), (x3, y3, pr[:, :, 3])


def _line_add(t, q, p):
    """The chord through T = (X, Y, Z) and the affine Q = (x_Q, y_Q) on the
    twist, at P: (line, T + Q), the mixed addition of `schedule.line_add`;
    the line is the reference's l_{T,Q}(P) times xi (X - x_Q Z)."""
    x, y, z = t
    xq, yq = q
    xp, yp = p
    pr = tw.f2_mul(torch.stack([yq, xq], 2), z[:, :, None])
    n, lam = FP.sub(y, pr[:, :, 0]), FP.sub(x, pr[:, :, 1])
    sq = tw.f2_mul(torch.stack([n, lam], 2), torch.stack([n, lam], 2))
    nn, ll = sq.unbind(2)
    pr = tw.f2_mul(torch.stack([lam, x, z, n, lam], 2), torch.stack([ll, ll, nn, xq, yq], 2))
    e, g, znn, nxq, lyq = pr.unbind(2)
    h = FP.sub(FP.add(e, znn), FP.add(g, g))
    pr = tw.f2_mul(torch.stack([lam, n, e, z], 2), torch.stack([h, FP.sub(g, h), y, e], 2))
    s = FP.mul(torch.stack([tw.f2_mul_xi(lam), n], 2), torch.stack([yp, xp], 1)[:, None])
    return (_sparse_line(s[:, :, 0], FP.sub(nxq, lyq), FP.neg(s[:, :, 1])),
            (pr[:, :, 0], FP.sub(pr[:, :, 1], pr[:, :, 2]), pr[:, :, 3]))


def _line_step(f, t, p, q=None):
    """One Miller step: with q None the tangent at t (f <- f^2 l_{T,T}(P),
    T <- 2T), else the chord through t and q (f <- f l_{T,Q}(P),
    T <- T + Q). t projective (three Fp2 (12, 2, *batch)), q affine (two
    Fp2), p affine (two Fp (12, *batch))."""
    if q is None:
        ell, t = _line_dbl(t, p)
        f = tw.f12_sqr(f)
    else:
        ell, t = _line_add(t, q, p)
    return tw.f12_mul(f, ell), t


def miller_loop_plain(p_aff, q_aff):
    """Plain version of the `miller_loop` kernel: f_{|x|,Q}(P), conjugated
    for x < 0, as tensor code over the tower, T in projective coordinates on
    the twist from (x_Q, y_Q, 1). The value is the reference's affine
    Miller value times an Fp2 factor, so equal to it after the final
    exponentiation. p_aff = (xp, yp) Fp coordinates (12, *batch); q_aff =
    (xq, yq) Fp2 coordinates (12, 2, *batch). Points must not be infinity
    (callers select those lanes away)."""
    batch, dev = tuple(p_aff[0].shape[1:]), p_aff[0].device
    f = tw.f12_one(batch, dev)
    t = (q_aff[0], q_aff[1], tw.f2_one(batch, dev))
    for bit in LOOP_BITS:
        f, t = _line_step(f, t, p_aff)
        if bit:
            f, t = _line_step(f, t, p_aff, q_aff)
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
           "kernel_inputs"]
