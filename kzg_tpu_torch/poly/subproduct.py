"""SubProductTree, vanishing polynomials and Lagrange interpolation (port of
`kzg_tpu/poly/subproduct.py`).

The tree is built level-synchronously: every level is ONE batched NTT
multiplication over all node pairs (the reference recurses node by node,
polynomial.rs:310-327). Interpolation uses the derivative-of-product
construction (polynomial.rs:237-293) with all k quotients Z/(X - x_i) from
one batched linear division and one sum.
"""

import torch

from ..fields import FR
from .polynomial import Polynomial, _div_by_linear, _eval_many, _mul_ntt


def _leaves(xs):
    """(8, k) points -> (8, k, 2) leaves X - x_i, coefficients [-x_i, 1]."""
    k = xs.shape[-1]
    return torch.stack([FR.neg(xs), FR.one((k,), xs.device)], dim=-1)


def _build_levels(xs):
    """Level j of the tree is an (8, k/2^j, 2^j + 1) array of monic node
    polynomials; k must be a power of two."""
    k = xs.shape[-1]
    assert k & (k - 1) == 0, "point count must be a power of two"
    level = _leaves(xs)
    levels = [level]
    while level.shape[1] > 1:
        out_len = 2 * level.shape[-1] - 1
        level = _mul_ntt(level[:, 0::2, :], level[:, 1::2, :], out_len)
        levels.append(level)
    return levels


class SubProductTree:
    """Binary tree of the products prod(X - x_i) (reference
    polynomial.rs:303-327): `product` is the root; fast multipoint
    evaluation and the linear-mod-combination of interpolation."""

    def __init__(self, xs, levels):
        self.xs = xs
        self.levels = levels

    @classmethod
    def from_points(cls, xs):
        """xs: (8, k) points, k a power of two."""
        return cls(xs, _build_levels(xs))

    @property
    def product(self) -> Polynomial:
        root = self.levels[-1][:, 0, :]
        return Polynomial(root, root.shape[-1] - 1)

    def eval_points(self, poly: Polynomial):
        """`poly` at the tree's points: remainders down the tree for large
        point counts, direct evaluation for small batches."""
        from ..config import get_config

        k = self.xs.shape[-1]
        if k < get_config().tree_eval_threshold and poly.num_coeffs() * k < (1 << 22):
            return poly.eval_many(self.xs)
        from .newton import eval_points_tree

        return eval_points_tree(poly.trimmed(), self.levels, poly.num_coeffs())

    def linear_mod_combination(self, cs):
        """sum_i cs_i * Z(X)/(X - x_i) (polynomial.rs:350-364)."""
        z = self.product
        q, _ = _div_by_linear(z.trimmed(), self.xs)  # (8, k, deg)
        weighted = FR.mul(q, cs[..., None])
        return Polynomial(FR.sum_last(weighted.transpose(1, 2)), z.degree - 1)


def _single_point(xs, ys) -> Polynomial:
    """The reference's one-point quirk: X + (y0 - x0), not the constant y0
    (polynomial.rs:244-247, 269-272)."""
    c = torch.cat([FR.sub(ys[..., 0:1], xs[..., 0:1]), FR.one((1,), xs.device)], dim=-1)
    return Polynomial(c, 1)


def lagrange_interpolation_with_tree(xs, ys, tree: SubProductTree) -> Polynomial:
    """Interpolation reusing a built SubProductTree (polynomial.rs:237-264):
    c_i = y_i / m'(x_i) with m the root, then one linear-mod-combination.
    Keeps the one-point quirk of `lagrange_interpolation`."""
    if xs.shape[-1] == 1:
        return _single_point(xs, ys)
    w = poly_derivative(tree.product).eval_many(xs)  # m'(x_i)
    return tree.linear_mod_combination(FR.mul(ys, FR.batch_inv(w)))


def multi_eval_tree(poly: Polynomial, xs):
    """`poly` at any (8, k) point batch through the remainder tree (k padded
    to a power of two with copies of x_0, the padded lanes discarded)."""
    from .newton import eval_points_tree

    k = xs.shape[-1]
    kp = 1 << max(1, (k - 1).bit_length())
    if kp != k:
        xs = torch.cat([xs, xs[..., :1].expand(FR.W, kp - k)], dim=-1)
    tree = SubProductTree.from_points(xs)
    return eval_points_tree(poly.trimmed(), tree.levels, poly.num_coeffs())[..., :k]


def vanishing_poly(xs) -> Polynomial:
    """Z(X) = prod (X - x_i) for any point count: level-synchronous batched
    products, odd nodes set aside and folded in at the end (the reference
    builds Z with op_tree, coeff_form.rs:150-159)."""
    level = _leaves(xs)
    spare = []  # odd nodes, at most one per level
    while level.shape[1] > 1:
        if level.shape[1] % 2 == 1:
            spare.append(level[:, -1, :])
            level = level[:, :-1, :]
        out_len = 2 * level.shape[-1] - 1
        level = _mul_ntt(level[:, 0::2, :], level[:, 1::2, :], out_len)
    root = level[:, 0, :]
    for s in spare:
        root = _mul_ntt(root, s, root.shape[-1] + s.shape[-1] - 1)
    return Polynomial(root, root.shape[-1] - 1)


def poly_derivative(p: Polynomial) -> Polynomial:
    """Formal derivative (polynomial.rs:249-254)."""
    n = p.num_coeffs()
    if n <= 1:
        return Polynomial.new_zero(p.device)
    idx = torch.from_numpy(FR.encode(list(range(1, n)))).to(p.device)
    return Polynomial(FR.mul(p.trimmed()[..., 1:], idx), p.degree - 1)


def lagrange_interpolation(xs, ys) -> Polynomial:
    """The degree < k interpolant through (x_i, y_i) (polynomial.rs:237-293):
    m = prod (X - x_i), c_i = y_i / m'(x_i), r = sum_i c_i m/(X - x_i).
    Keeps the reference's one-point quirk (X + (y0 - x0))."""
    k = xs.shape[-1]
    if k == 1:
        return _single_point(xs, ys)
    z = vanishing_poly(xs)
    w = _eval_many(poly_derivative(z).trimmed(), xs)  # m'(x_i)
    cs = FR.mul(ys, FR.batch_inv(w))
    q, _ = _div_by_linear(z.trimmed(), xs)  # (8, k, k)
    weighted = FR.mul(q, cs[..., None])
    return Polynomial(FR.sum_last(weighted.transpose(1, 2)), k - 1)


__all__ = [
    "SubProductTree", "lagrange_interpolation", "lagrange_interpolation_with_tree",
    "multi_eval_tree", "poly_derivative", "vanishing_poly",
]
