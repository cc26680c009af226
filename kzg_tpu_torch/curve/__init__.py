"""Curve instances and host converters (port of `kzg_tpu/curve/__init__.py`).

`G1` is the group law over `FP` whose batch point ops (`add`, `dbl`, `madd`,
`madd_multi`, `bucket_accumulate`, `window_join`) run as kernels K2-K4, K6
and K7 on CUDA tensors, and the rounds of its digit ladder
(`scalar_mul_digits`) as one launch of the ladder kernel (all of them as
their plain twins on CPU tensors); its remaining formulas (`to_affine`,
`eq`, the ladders' table) are tensor code over K1 field math.
`G2` is the same over Fp2 (`Fp2Adapter(FP)`), on the Fp2 instantiations of
those kernels. G2 coordinates are (12, 2, *batch) words, c0 then c1 on
axis 1.
"""

import numpy as np
import torch

from ..config import resolve_device
from ..constants import G1_GEN, G2_GEN
from ..fields import FP
from . import cuda_ops
from .ops import CurveOps, Fp2Adapter


class _KernelCurve(CurveOps):
    """A curve whose bucket kernels (K3, K4) and ladder kernel (G1 or G2 by
    the shapes they are given) stand behind bucket_accumulate / window_join
    and the rounds of scalar_mul_digits."""

    def bucket_accumulate(self, rows, order, start, count):
        return cuda_ops.bucket_accumulate(rows, order, start, count)

    def window_join(self, s_all, c: int):
        return cuda_ops.horner_join(s_all, c)

    def ladder_rounds(self, tx, ty, p_inf, digits, c: int):
        return cuda_ops.ladder(tx, ty, p_inf, digits, c)


class _G1(_KernelCurve):
    """G1 with the point kernels behind add / dbl / madd / madd_multi."""

    def add(self, p, q):
        return cuda_ops.add(p, q)

    def dbl(self, p):
        return cuda_ops.dbl(p)

    def madd(self, p, q_affine, q_inf):
        return cuda_ops.madd(p, q_affine, q_inf)

    def madd_multi(self, acc, q_affine, skip, neg=None):
        return cuda_ops.madd_multi(acc, q_affine, skip, neg)


G1 = _G1(FP, name="G1")


class _G2(_KernelCurve):
    """G2 with the Fp2 point kernels behind add / dbl / madd / madd_multi."""

    def add(self, p, q):
        return cuda_ops.g2_add(p, q)

    def dbl(self, p):
        return cuda_ops.g2_dbl(p)

    def madd(self, p, q_affine, q_inf):
        return cuda_ops.g2_madd(p, q_affine, q_inf)

    def madd_multi(self, acc, q_affine, skip, neg=None):
        return cuda_ops.g2_madd_multi(acc, q_affine, skip, neg)


FP2 = Fp2Adapter(FP)
G2 = _G2(FP2, name="G2")


def _tensor(words_np: np.ndarray, device) -> torch.Tensor:
    """Host words on `device` (None: the configured default device)."""
    return torch.from_numpy(words_np).to(resolve_device(device))


# ---- host converters (oracle <-> device) ---------------------------------------

def g1_to_device(points, device=None):
    """List of oracle G1 points (None or (Fp, Fp)) -> Jacobian (X, Y, Z)
    tensors with Z = 0 columns for infinity."""
    xs, ys, zs = [], [], []
    for p in points:
        if p is None:
            xs.append(1)
            ys.append(1)
            zs.append(0)
        else:
            xs.append(p[0].n)
            ys.append(p[1].n)
            zs.append(1)
    return tuple(_tensor(FP.encode(v), device) for v in (xs, ys, zs))


def _is_affine_triple(point, bdim: int) -> bool:
    """Affine batches carry a boolean infinity mask as the third element;
    Jacobian batches carry a Z field element (word axis present)."""
    return point[2].dim() == point[0].dim() - bdim


def g1_from_device(point):
    """Batched device point -> list of oracle points. Accepts a Jacobian
    (X, Y, Z) batch or an affine (x, y, inf_mask) batch."""
    from ..oracle.field import Fp

    if _is_affine_triple(point, 1):
        x, y, inf = point
    else:
        x, y, inf = G1.to_affine(point)
    xs = FP.decode(x)
    ys = FP.decode(y)
    infs = inf.reshape(-1).cpu().numpy()
    return [None if i else (Fp(a), Fp(b)) for a, b, i in zip(xs, ys, infs)]


def g2_to_device(points, device=None):
    """List of oracle G2 points -> (X, Y, Z) of (12, 2, n) Fp2 words."""
    cols = {k: [] for k in ("x0", "x1", "y0", "y1", "z0")}
    for p in points:
        if p is None:
            vals = (1, 0, 1, 0, 0)
        else:
            vals = (p[0].a.n, p[0].b.n, p[1].a.n, p[1].b.n, 1)
        for k, v in zip(cols, vals):
            cols[k].append(v)
    zero = [0] * len(points)

    def fp2(c0, c1):
        return _tensor(np.stack([FP.encode(c0), FP.encode(c1)], axis=1), device)

    return (fp2(cols["x0"], cols["x1"]), fp2(cols["y0"], cols["y1"]), fp2(cols["z0"], zero))


def g2_from_device(point):
    """Batched G2 device point -> list of oracle points. Accepts a Jacobian
    (X, Y, Z) batch or an affine (x, y, inf_mask) batch of (12, 2, ...)
    words."""
    from ..oracle.field import Fp2

    if _is_affine_triple(point, 2):
        x, y, inf = point
    else:
        x, y, inf = G2.to_affine(point)
    xc0, xc1 = FP.decode(x[:, 0]), FP.decode(x[:, 1])
    yc0, yc1 = FP.decode(y[:, 0]), FP.decode(y[:, 1])
    infs = inf.reshape(-1).cpu().numpy()
    return [
        None if i else (Fp2.from_ints(a0, a1), Fp2.from_ints(b0, b1))
        for a0, a1, b0, b1, i in zip(xc0, xc1, yc0, yc1, infs)
    ]


def g1_generator_device(n: int = 1, device=None):
    """(X, Y, Z) of n copies of the G1 generator."""
    return tuple(
        _tensor(FP.encode(v), device)
        for v in ([G1_GEN[0]] * n, [G1_GEN[1]] * n, [1] * n)
    )


def g2_generator_device(n: int = 1, device=None):
    """(X, Y, Z) of n copies of the G2 generator, (12, 2, n) words each."""

    def fp2(c0, c1):
        return _tensor(np.stack([FP.encode([c0] * n), FP.encode([c1] * n)], axis=1), device)

    return (fp2(*G2_GEN[0]), fp2(*G2_GEN[1]), fp2(1, 0))


__all__ = [
    "G1", "G2", "FP2", "CurveOps", "Fp2Adapter", "g1_to_device", "g1_from_device",
    "g2_to_device", "g2_from_device", "g1_generator_device", "g2_generator_device",
]
