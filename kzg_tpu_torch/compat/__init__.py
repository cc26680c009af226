"""Interop layer: canonical blstrs/ZCash byte encodings (a copy of
`kzg_tpu/compat/serialize.py`; see that module's note on why it is copied).
The JAX package's device-batch helpers for batch witnesses belong to the
batched opening, which this port has not reached yet."""

from .serialize import (
    DecodeError,
    fr_to_bytes,
    fr_from_bytes,
    g1_compress,
    g1_decompress,
    g1_uncompressed,
    g1_from_uncompressed,
    g2_compress,
    g2_decompress,
    g2_uncompressed,
    g2_from_uncompressed,
    polynomial_to_bytes,
    polynomial_from_bytes,
    params_to_bytes,
    params_from_bytes,
)

__all__ = [
    "DecodeError",
    "fr_to_bytes", "fr_from_bytes",
    "g1_compress", "g1_decompress", "g1_uncompressed", "g1_from_uncompressed",
    "g2_compress", "g2_decompress", "g2_uncompressed", "g2_from_uncompressed",
    "polynomial_to_bytes", "polynomial_from_bytes",
    "params_to_bytes", "params_from_bytes",
]
