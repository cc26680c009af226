"""Fast polynomial division and tree-remaindering multipoint evaluation
(port of `kzg_tpu/poly/newton.py`).

  * general long division by reversal + Newton-iteration power-series
    inverse: O(M(n)) NTT work at log depth instead of the reference's
    O((n-k)k) schoolbook (polynomial.rs:193-227);
  * multipoint evaluation by remaindering down a subproduct tree, level
    synchronous: every level is one batched Newton division over all nodes.

All helpers take (8, ..., n) Montgomery Fr words (coefficient index last).
The JAX package wraps `newton_divmod` and `eval_points_tree` in cached jits;
PyTorch runs eagerly, so the port calls them directly.
"""

import torch

from ..fields import FR
from .polynomial import _mul_ntt, _pad_to


def _trunc_mul(a, b, m: int):
    """(a * b) mod X^m. The product domain is sized for the full product,
    so nothing wraps around into [0, m)."""
    out_len = a.shape[-1] + b.shape[-1] - 1
    return _mul_ntt(a, b, out_len)[..., :m]


def inv_series(d, m: int):
    """Power-series inverse g with d * g == 1 (mod X^m): Newton iteration
    g_2t = g_t (2 - d g_t) mod X^2t from g_1 = 1/d_0. d[..., 0] must be
    invertible."""
    g = FR.inv(d[..., :1])
    t = 1
    while t < m:
        t = min(2 * t, m)
        dg = _trunc_mul(d[..., : min(t, d.shape[-1])], g, t)
        # e = 2 - d*g: negate everything, then add 2 at coefficient 0
        e = FR.neg(dg)
        one = FR.one(e.shape[1:-1] + (1,), e.device)
        e = torch.cat([FR.add(e[..., :1], FR.add(one, one)), e[..., 1:]], dim=-1)
        g = _trunc_mul(g, e, t)
    return g


def _reverse(c, n: int):
    """rev_n: the first n coefficients (c padded or cut to n), reversed."""
    return torch.flip(_pad_to(c[..., :n], n), dims=(-1,))


def newton_divmod(f, d, nf: int, nd: int, d_inv_rev=None):
    """Quotient and remainder of f / d by the reversal trick:
    q = rev(rev(f) * rev(d)^-1 mod X^(nf-nd+1)), r = f - q d.

    f: (8, ..., >= nf) with true length nf; d: (8, ..., >= nd) with true
    length nd and an invertible leading coefficient. Returns
    q (8, ..., nf-nd+1) and r (8, ..., max(nd-1, 1)). d_inv_rev: an
    optional precomputed inv_series(rev(d), nf-nd+1)."""
    f = f[..., :nf]
    d = d[..., :nd]
    steps = nf - nd + 1
    if steps <= 0:
        return FR.zeros(f.shape[1:-1] + (1,), f.device), f
    fr = _reverse(f, nf)
    if d_inv_rev is None:
        d_inv_rev = inv_series(_reverse(d, nd), steps)
    qr = _trunc_mul(fr, d_inv_rev[..., :steps], steps)
    q = torch.flip(qr, dims=(-1,))
    qd = _mul_ntt(q, d, nf)
    r = FR.sub(f, qd)[..., : max(nd - 1, 1)]
    return q, r


def eval_points_tree(coeffs, levels, nf: int):
    """Evaluate one polynomial at all k points of a subproduct tree by
    remaindering down the tree (reference polynomial.rs:329-348), one
    batched Newton division per level.

    coeffs: (8, n) with true length nf; levels[j]: (8, k/2^j, 2^j + 1)
    monic node polynomials. Returns (8, k) values in point order."""
    k = levels[0].shape[1]
    root = levels[-1][:, 0, :]
    if nf >= k + 1:
        _, r = newton_divmod(coeffs, root, nf, k + 1)
        r = _pad_to(r, k)  # f mod root, degree < k
    else:
        r = _pad_to(coeffs[..., :nf], k)
    cur = r[:, None, :]  # (8, 1, k)
    for j in range(len(levels) - 2, -1, -1):
        nodes = levels[j]  # the children at this level
        m = nodes.shape[-1] - 1  # child degree
        nf_cur = cur.shape[-1]
        ch = nodes.reshape(FR.W, -1, 2, m + 1)  # children paired under parents
        par = cur[:, :, None, :].expand(FR.W, ch.shape[1], 2, nf_cur)
        _, r2 = newton_divmod(par, ch, nf_cur, m + 1)
        cur = r2.reshape(FR.W, -1, max(m, 1))
    return cur[..., 0]  # leaves: f mod (X - x_i) = f(x_i)
