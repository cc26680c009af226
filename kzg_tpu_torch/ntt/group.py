"""The NTT over a group: the DFT of a vector of points, forward or inverse,
whose butterflies are point additions and whose twiddle multiplications are
digit ladders (`CurveOps.scalar_mul_digits`). O(d log d) group operations
along the last axis of a Jacobian batch, for G1 or G2, over any leading
batch axes. Two callers: the Lagrange SRS (`kzg.eval_form`, the inverse
over one vector of SRS powers) and FK20 (`kzg.das`, both directions over a
block of blobs).

The layout is the Pease one of `Domain`'s reference route: each stage
splits the vector into halves a, b, forms u = a + b and
v = (a - b) * omega^(+-(j & ~(2^s - 1))) with one ladder over every lane of
every batch row (config.group_ladder_window), and interleaves u, v; the
output comes out bit-reversed, and one gather puts it in natural order
unless the caller asks for the bit-reversed order itself.
"""

import torch

from ..config import get_config
from ..constants import R
from ..fields import FR
from ..fields.cuda_field import bitrev_perm
from ..msm.pippenger import _host_digits_msb, _std_digits_msb
from .domain import Domain


def scale_points(curve, p, k: int):
    """k p for every lane of a Jacobian batch p and one host int k in
    [0, r): one ladder whose digit column is broadcast over the lanes."""
    c = get_config().group_ladder_window
    lanes = tuple(p[0].shape[curve.f.bdim:])
    column = torch.tensor(_host_digits_msb(k % R, c), device=p[0].device)
    return curve.scalar_mul_digits(p, column.reshape((-1,) + (1,) * len(lanes)).expand(
        (column.numel(),) + lanes), c)


def _stage_digits(dom: Domain, inverse: bool, force_split: bool, device):
    """s -> the (W, d / 2) MSB-first digit rows of stage s's twiddles
    omega^(+-(j & ~(2^s - 1))), j < d / 2. Small domains read a dense digit
    table of the half powers; big ones (exp >= ntt.domain._BIG_TABLE_EXP,
    or force_split) build each stage's twiddle values from two O(sqrt d)
    split tables, omega^t = HI[t >> sc] * LO[t & (2^sc - 1)], and extract
    the digits on the device."""
    h = dom.d // 2
    c = get_config().group_ladder_window
    w_count = -(-255 // c)
    jidx = torch.arange(h, device=device)
    base = dom.omega_inv if inverse else dom.omega
    if dom.split is None and not force_split:
        tw_std = FR.from_mont(dom._table("tw_inv" if inverse else "tw_fwd", device))
        table = _std_digits_msb(tw_std, c, w_count)
        return lambda s: table[:, jidx & ~((1 << s) - 1)]
    sc = max(1, (dom.exp - 1) // 2)
    smask = (1 << sc) - 1
    hi = torch.from_numpy(Domain._powers_step(base, 1 << sc, h >> sc)).to(device)
    lo = torch.from_numpy(Domain._powers(base, 1 << sc)).to(device)

    def digits(s):
        tv = jidx & ~((1 << s) - 1)
        return _std_digits_msb(FR.from_mont(FR.mul(hi[:, tv >> sc], lo[:, tv & smask])),
                               c, w_count)

    return digits


def group_ntt(curve, points, dom: Domain, inverse: bool = False, scale: bool = True,
              bit_reversed: bool = False, force_split: bool = False):
    """The DFT of the Jacobian batch `points` ((W[, 2], *batch, d) words a
    coordinate) along its last axis: X[k] = sum_i x[i] omega^(ik), or for
    `inverse` sum_i x[i] omega^(-ik), times 1/d where `scale` (a last
    ladder with a broadcast digit column). Returns the Jacobian batch of
    the same shape, in natural order, or bit-reversed where
    `bit_reversed` (the stages' own order: the gather is left out)."""
    d = dom.d
    if points[0].shape[-1] != d:
        raise ValueError(f"{points[0].shape[-1]} points along the last axis, domain 2^{dom.exp}")
    p = points
    if d == 1:
        return p
    dev = p[0].device
    h = d // 2
    rows = tuple(p[0].shape[curve.f.bdim:-1])
    stage_digits = _stage_digits(dom, inverse, force_split, dev)
    c = get_config().group_ladder_window
    for s in range(dom.exp):
        a = tuple(t[..., :h] for t in p)
        b = tuple(t[..., h:] for t in p)
        u = curve.add(a, b)
        dig = stage_digits(s)
        dig = dig.reshape((dig.shape[0],) + (1,) * len(rows) + (h,)).expand(
            (dig.shape[0],) + rows + (h,))
        v = curve.scalar_mul_digits(curve.add(a, curve.neg(b)), dig, c)
        p = tuple(torch.stack([uu, vv], dim=-1).reshape(uu.shape[:-1] + (d,))
                  for uu, vv in zip(u, v))
    if not bit_reversed:
        rev = (dom._table("bitrev", dev) if dom.split is None
               else torch.from_numpy(bitrev_perm(dom.exp)).to(dev))
        p = tuple(torch.index_select(t, -1, rev) for t in p)
    if inverse and scale:
        p = scale_points(curve, p, pow(d, -1, R))
    return p


__all__ = ["group_ntt", "scale_points"]
