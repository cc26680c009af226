"""NTT layer of the port: the radix-2 evaluation domain over Fr and its
value container."""

from .domain import Domain, compute_omega
from .evaluation_domain import EvaluationDomain
from .mxu import dft_axis2, mxu_available

__all__ = ["Domain", "EvaluationDomain", "compute_omega", "dft_axis2", "mxu_available"]
