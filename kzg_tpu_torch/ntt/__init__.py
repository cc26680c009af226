"""NTT layer of the port: the radix-2 evaluation domain over Fr."""

from .domain import Domain, compute_omega

__all__ = ["Domain", "compute_omega"]
