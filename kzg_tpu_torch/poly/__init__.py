from .polynomial import Polynomial

__all__ = ["Polynomial"]
