from .polynomial import Polynomial, op_tree
from .subproduct import (
    SubProductTree,
    lagrange_interpolation,
    lagrange_interpolation_with_tree,
    multi_eval_tree,
    poly_derivative,
    vanishing_poly,
)
from .newton import inv_series, newton_divmod

__all__ = [
    "Polynomial",
    "op_tree",
    "SubProductTree",
    "vanishing_poly",
    "poly_derivative",
    "lagrange_interpolation",
    "lagrange_interpolation_with_tree",
    "multi_eval_tree",
    "inv_series",
    "newton_divmod",
]
