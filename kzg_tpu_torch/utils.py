"""Numeric helpers (port of `kzg_tpu/utils.py`; parity with the
reference's src/utils.rs:1-53).

The reference uses a De Bruijn table log2 (utils.rs:6-20); Python ints have
bit_length, so these are thin, exact equivalents kept for API parity.
"""


def log2(x: int) -> int:
    """Floor log2 for x >= 1 (reference utils.rs:6-20)."""
    if x < 1:
        raise ValueError("log2 of non-positive value")
    return x.bit_length() - 1


def log2_ceil(x: int) -> int:
    """Ceil log2 for x >= 1 (reference utils.rs:22-30)."""
    if x < 1:
        raise ValueError("log2_ceil of non-positive value")
    return (x - 1).bit_length() if x > 1 else 0


def is_power_of_two(x: int) -> bool:
    """(reference utils.rs:51-53)"""
    return x > 0 and (x & (x - 1)) == 0


def next_power_of_two(x: int) -> int:
    return 1 << log2_ceil(max(1, x))


def pad_to_power_of_two(values, pad_value=0):
    """Right-pad a list to the next power-of-two length
    (reference utils.rs:32-39)."""
    values = list(values)
    n = next_power_of_two(len(values))
    return values + [pad_value] * (n - len(values))
