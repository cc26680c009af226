"""Trusted setup: the SRS power ladders g^(s^i), h^(s^i) (port of the
host-engine path of `kzg_tpu/kzg/srs.py`).

Params hold affine batches, the form the MSM consumes: gs = (x, y, inf)
with (12, n) words, hs = (x, y, inf) with (12, 2, n) Fp2 words. `save` and
`load` use the JAX package's `.npz` format (16-bit limbs in uint32,
`srs.py:49-62`), so an SRS saved by either package loads into the other.

Only the native host engine builds the SRS in this slice (the device
ladders of `setup_device` are a later slice). The ladder is cut into one
chunk per CPU core: each chunk starts from base * s^offset and runs the
engine's power ladder on its own thread (ctypes releases the interpreter
lock), which yields the same affine points as one serial ladder.
"""

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from ..config import resolve_device
from ..constants import R
from ..curve import g1_to_device, g2_to_device
from ..fields.limb import pack16, unpack16


def _to_limbs16(words: torch.Tensor) -> np.ndarray:
    """(12, ...) packed words -> the JAX package's (24, ...) uint32 limbs."""
    return unpack16(words.cpu()).numpy().astype(np.uint32)


def _from_limbs16(limbs: np.ndarray, device) -> torch.Tensor:
    return pack16(torch.from_numpy(limbs.astype(np.int64))).to(resolve_device(device))


def _mask(flags, device) -> torch.Tensor:
    """A bool infinity mask on `device` (None: the configured default)."""
    return torch.from_numpy(np.asarray(flags, dtype=bool)).to(resolve_device(device))


@dataclass
class KZGParams:
    """SRS: gs = G1 affine batch of g^(s^i), i < n; hs = the same over G2
    (reference KZGParams, lib.rs:14-19)."""

    gs: tuple
    hs: tuple
    n: int

    def save(self, path: str):
        np.savez(
            path,
            g_x=_to_limbs16(self.gs[0]), g_y=_to_limbs16(self.gs[1]),
            g_i=self.gs[2].cpu().numpy(),
            h_x=_to_limbs16(self.hs[0]), h_y=_to_limbs16(self.hs[1]),
            h_i=self.hs[2].cpu().numpy(),
            n=self.n,
        )

    @classmethod
    def from_numpy(cls, gs_np, hs_np, n: int, device=None) -> "KZGParams":
        """From the JAX package's arrays: gs_np = ((24, n) x, (24, n) y,
        (n,) inf) and hs_np = ((24, 2, n) x, (24, 2, n) y, (n,) inf), limbs
        as uint32 16-bit values. device=None: the configured default."""
        gs = (_from_limbs16(np.asarray(gs_np[0]), device),
              _from_limbs16(np.asarray(gs_np[1]), device),
              _mask(gs_np[2], device))
        hs = (_from_limbs16(np.asarray(hs_np[0]), device),
              _from_limbs16(np.asarray(hs_np[1]), device),
              _mask(hs_np[2], device))
        return cls(gs=gs, hs=hs, n=int(n))

    @classmethod
    def load(cls, path: str, device=None) -> "KZGParams":
        with np.load(path if path.endswith(".npz") else path + ".npz") as z:
            gs = tuple(z[k] for k in ("g_x", "g_y", "g_i"))
            hs = tuple(z[k] for k in ("h_x", "h_y", "h_i"))
            n = int(z["n"])
        return cls.from_numpy(gs, hs, n, device)


def _powers_parallel(mul, powers, base, s: int, n: int):
    """[base * s^i for i < n] as one engine power ladder per chunk, the
    chunks on a thread pool."""
    workers = max(1, min(os.cpu_count() or 1, n // 256 or 1))
    step = -(-n // workers)
    # chunk bases serially: the first engine call initialises its tables
    starts = list(range(0, n, step))
    bases = [mul(base, pow(s, off, R)) for off in starts]
    with ThreadPoolExecutor(max_workers=len(starts)) as pool:
        futs = [pool.submit(powers, b, s, min(step, n - off)) for b, off in zip(bases, starts)]
        return [p for f in futs for p in f.result()]


def _setup_host(s: int, num_coeffs: int, device=None) -> KZGParams:
    from .. import native
    from ..oracle import g1_generator, g2_generator

    s %= R
    gpts = _powers_parallel(native.g1_mul, native.g1_powers, g1_generator(), s, num_coeffs)
    hpts = _powers_parallel(native.g2_mul, native.g2_powers, g2_generator(), s, num_coeffs)
    gx, gy, _ = g1_to_device(gpts, device)
    hx, hy, _ = g2_to_device(hpts, device)
    ginf = _mask([p is None for p in gpts], device)
    hinf = _mask([p is None for p in hpts], device)
    return KZGParams(gs=(gx, gy, ginf), hs=(hx, hy, hinf), n=num_coeffs)


def setup(s: int, num_coeffs: int, device=None) -> KZGParams:
    """Build an SRS for polynomials with up to num_coeffs coefficients from
    the secret s (reference setup(), lib.rs:38-55), on `device` (None: the
    configured default device, the card)."""
    return _setup_host(s, num_coeffs, device)


def csprng_setup(num_coeffs: int, device=None) -> KZGParams:
    """Random setup from OS entropy (reference csprng_setup, lib.rs:60-64)."""
    s = int.from_bytes(os.urandom(48), "little") % R
    return setup(s, num_coeffs, device)

