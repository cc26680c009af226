"""The device pairing engine of the verifiers (port of
`kzg_tpu/kzg/engines.py`).

The host engines read four small points off the device and pair them on
the host (`hostcrypto.multi_pairing_check`). With
`config.pairing_engine = "device"` the verifiers come here instead: the
scalar multiplications x h and y g (`CurveOps.scalar_mul_digits`: a table of
15 multiples on K2, then one digit-ladder launch each; the reference runs
`scalar_mul_bits`, the same points in affine), the affine conversions
(`to_affine`: `field_scan`, `field_pow`, K1), both Miller loops in lanes
(one `miller_loop` launch) and the one final exponentiation (one
`final_exp` launch, the Miller values' product inside) all run on the
device, and a verify reads one boolean.
"""

import torch

from ..curve import G1, G2
from ..msm.pippenger import SMALL_MSM_WINDOW, _host_digits_msb
from ..pairing.pairing import pairing_check_device
from ..trace import span


def _mul(curve, p, k: int):
    """k p for a host int k in [0, r) and a batch-(1,) Jacobian point p."""
    c = SMALL_MSM_WINDOW
    digits = torch.tensor(_host_digits_msb(k, c), dtype=torch.int64, device=p[0].device)
    return curve.scalar_mul_digits(p, digits[:, None], c)


def _expand1(p):
    """A batch-() point -> batch-(1,)."""
    return tuple(t[..., None] for t in p)


def _affine1(points, i: int):
    """Column i of an affine batch (x, y, ...) as batch-(1,) (x, y)."""
    return tuple(t[..., i:i + 1] for t in points[:2])


def _check(a0, a1, b0, h) -> bool:
    """e(a0, b0) e(a1, h) == 1 for batch-(1,) Jacobian points a0, a1 (G1)
    and b0 (G2) and the affine (x, y) batch-(1,) G2 point h: both G1 points
    in one affine conversion, both pairs in the lanes of one check."""
    with span("verify.to_affine"):
        g1 = G1.to_affine(tuple(torch.cat([u, v], dim=-1) for u, v in zip(a0, a1)))
        b = G2.to_affine(b0)
        g2 = (torch.cat([b[0], h[0]], dim=-1), torch.cat([b[1], h[1]], dim=-1),
              torch.cat([b[2], torch.zeros_like(b[2])]))
    return pairing_check_device(g1, g2)


def verify_eval_device(params, x: int, y: int, commitment, witness) -> bool:
    """e(w, h^s - x h) e(y g - C, h) == 1 on the device, for host ints x, y
    reduced mod r and Jacobian device points C, w."""
    h = _affine1(params.hs, 0)
    with span("verify.xh"):
        xh = _mul(G2, G2.from_affine(*h), x)
    s2 = G2.add(G2.from_affine(*_affine1(params.hs, 1)), G2.neg(xh))  # h^(s - x)
    with span("verify.yg"):
        yg = _mul(G1, G1.from_affine(*_affine1(params.gs, 0)), y)
    r1 = G1.add(yg, G1.neg(_expand1(commitment)))  # y g - C
    return _check(_expand1(witness), r1, s2, h)


def verify_batched_device(params, commitment, w, hz, gr) -> bool:
    """e(w, h^Z) e(g^r - C, h) == 1 on the device; h^Z and g^r are the
    caller's device MSMs (Jacobian, batch ())."""
    r1 = G1.add(_expand1(gr), G1.neg(_expand1(commitment)))
    return _check(_expand1(w), r1, _expand1(hz), _affine1(params.hs, 0))


__all__ = ["verify_eval_device", "verify_batched_device"]
