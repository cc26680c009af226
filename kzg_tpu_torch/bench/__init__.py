"""Measurement helpers of the port. Only the field-multiply probe
(`peaks.mul_peak`) is here; the criterion-style harness and the scaling
runs of `kzg_tpu/bench/` are not ported."""

from .peaks import MulPeak, mul_peak

__all__ = ["MulPeak", "mul_peak"]
