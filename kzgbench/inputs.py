"""Inputs from the seed: sub-seeds by label, and random field words made on
the device in a few large calls.

`_fr_words` is a frozen copy of `kzg_tpu_torch/bench/paths.py::_fr_words`,
so that a change to the program cannot change what the benchmark feeds it.
"""

import hashlib
import random

from .reference.bls import R


def derive(seed: int, *labels) -> int:
    """A 63-bit sub-seed of `seed` for the given labels: the same seed and
    labels give the same number, different labels independent ones."""
    text = repr((int(seed),) + tuple(labels)).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1


def rng(seed: int, *labels) -> random.Random:
    return random.Random(derive(seed, *labels))


def fr_point(seed: int, *labels) -> int:
    """A field element in [1, r) drawn from the seed and labels."""
    return rng(seed, *labels).randrange(1, R)


def _fr_words(torch, gen, n, dev, R):
    low = torch.randint(-(1 << 31), 1 << 31, (7, n), generator=gen, device=dev,
                        dtype=torch.int64)
    top = torch.randint(0, R >> 224, (1, n), generator=gen, device=dev, dtype=torch.int64)
    return torch.cat([low, top]).to(torch.int32)


def fr_words(seed: int, label: str, n: int, device):
    """(8, n) int32 words of n field elements below r, on `device`, from a
    generator on that device seeded by (seed, label)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(derive(seed, label))
    return _fr_words(torch, gen, n, device, R)
