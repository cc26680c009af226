"""Mesh-sharded Pippenger MSM (port of `kzg_tpu/parallel/msm.py`).

The points and scalars axis is split over the ranks of one mesh axis;
every rank runs the port's MSM on its block (`msm.pippenger.msm`, the
window picked for the block's size as in the JAX package), and the
per-rank partial sums, one Jacobian point each, are joined by one
`all_gather` and a pairwise tree of point additions (`point_sum`, kernel
K2) that every rank runs on the same gathered points, so the result is the
same on every rank.
"""

import torch
import torch.distributed as dist

from ..curve import G1
from ..msm.pippenger import msm, pick_window, point_sum
from .runtime import MeshAxis, block, mesh_axis

# torch 2.13 calls it all_gather_single and warns on all_gather_into_tensor;
# 2.11 has only the old name
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def gather_last(t: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """Every rank's t stacked along a new last axis, in rank order, on
    every rank (one all_gather)."""
    t = t.contiguous()
    out = torch.empty((axis.size * t.numel(),), dtype=t.dtype, device=t.device)
    _all_gather(out, t.reshape(-1), group=axis.group)
    return out.reshape((axis.size,) + t.shape).movedim(0, -1)


def gather_sum(curve, part, axis: MeshAxis):
    """Every rank's Jacobian point `part` gathered and summed by one
    pairwise tree: the same point on every rank."""
    return point_sum(curve, tuple(gather_last(torch.stack(part), axis)))


def local_msm_join(curve, axis: MeshAxis, points, scalars_mont, c: int):
    """This rank's MSM, then the join (`kzg_tpu/parallel/msm.py:34-41`)."""
    return gather_sum(curve, msm(curve, points, scalars_mont, c), axis)


def make_sharded_msm(mesh, axis_name: str, curve=G1, c: int | None = None):
    """A sharded MSM over `axis_name`: run(points, scalars_mont) takes this
    rank's block of an affine batch ((12, n / R) words a coordinate for G1,
    (12, 2, n / R) for G2, with the (n / R,) infinity mask) and of its
    Montgomery scalars, and returns the Jacobian sum of the whole batch on
    every rank. The window is `c`, or `pick_window(n / R)`. `run.shard(t)`
    cuts this rank's block out of a replicated array."""
    axis = mesh_axis(mesh, axis_name)

    def run(points, scalars_mont):
        n_local = points[0].shape[-1]
        cc = c if c is not None else pick_window(n_local)
        return local_msm_join(curve, axis, points, scalars_mont, cc)

    run.shard = lambda t: block(t, axis)
    return run


def pad_msm_inputs(curve, points, scalars_mont, n_dev: int):
    """Pad an affine point batch and its scalars to a multiple of n_dev
    with points at infinity and zero scalars, which add nothing."""
    n = points[0].shape[-1]
    extra = -(-n // n_dev) * n_dev - n
    if extra == 0:
        return points, scalars_mont

    def padc(t):
        return torch.cat([t, t.new_zeros(t.shape[:-1] + (extra,))], dim=-1)

    x, y, inf = points
    inf = torch.cat([inf, inf.new_ones((extra,))])
    return (padc(x), padc(y), inf), padc(scalars_mont)


__all__ = ["gather_last", "gather_sum", "local_msm_join", "make_sharded_msm", "pad_msm_inputs"]
