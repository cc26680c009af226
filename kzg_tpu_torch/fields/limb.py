"""Multi-word modular arithmetic over torch tensors (port of
`kzg_tpu/fields/limb.py`).

Layout, decided once for the whole port: a field element is a column of
little-endian 32-bit words stored as int32, shape ``(W, *batch)`` with
W = 8 for Fr and W = 12 for Fp (limb-major, so element i's word l sits at
``l * n + i`` in a flat batch and a kernel's loads coalesce). Elements are
kept in Montgomery form and normalised to ``[0, modulus)``.

The JAX package keeps 16-bit limbs in uint32 (16 for Fr, 24 for Fp); packed
as ``lo | hi << 16`` they become these words, with the SAME Montgomery
radix (2^256 / 2^384). So both packages hold the same integers, and
`pack16`/`unpack16` convert one layout to the other without loss.

Ring ops (`add`, `sub`, `mul`, `sqr`, `mul_const`, `to_mont`, `from_mont`)
go through kernel K1 on CUDA tensors and through its plain PyTorch twin on
CPU tensors (`fields/cuda_field.py`), and so does `pow_static` (with `inv`)
through K1's Fermat chain, one launch a power (`cuda_field.field_pow`).
Everything else here (`batch_inv`, the prefix scans, `sum_last`) is plain
tensor code whose field math is those ops. `as_plain()` gives a twin of the
field whose ops are the plain versions on every device (the reference that
`chip_smoke.py` holds the kernels against on the card).
"""

import numpy as np
import torch

from ..config import resolve_device
from . import cuda_field
from .cuda_field import pack16, unpack16  # noqa: F401  (layout converters)

DTYPE = torch.int32


def _words(x: int, n: int) -> np.ndarray:
    """Little-endian 32-bit words of a nonnegative int, as (n,) int32."""
    return np.frombuffer(int(x).to_bytes(4 * n, "little"), dtype="<u4").astype(
        np.uint32
    ).view(np.int32).copy()


def ints_to_words(xs, n: int) -> np.ndarray:
    """ints (each < 2^(32n)) -> (n, len(xs)) int32 words."""
    buf = b"".join(int(x).to_bytes(4 * n, "little") for x in xs)
    arr = np.frombuffer(buf, dtype="<u4").reshape(len(xs), n)
    return np.array(arr.T, dtype=np.uint32, order="C").view(np.int32)


def words_to_ints(arr) -> list:
    """(n, ...) int32 words (numpy or tensor) -> list of ints, batch flattened."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    arr = np.asarray(arr)
    n = arr.shape[0]
    flat = np.ascontiguousarray(arr.reshape(n, -1).T).astype("<u4")
    buf = flat.tobytes()
    step = 4 * n
    return [int.from_bytes(buf[i:i + step], "little") for i in range(0, len(buf), step)]


class LimbField:
    """Modular arithmetic for one prime field at a fixed word count."""

    bdim = 1  # leading non-batch axes of an element: the word axis

    def __init__(self, modulus: int, n_words: int, name: str, kernel_id: int,
                 plain: bool = False):
        assert modulus < (1 << (32 * n_words))
        self.modulus = modulus
        self.W = n_words
        self.name = name
        self.kernel_id = kernel_id  # field index of the C interface: 0 Fr, 1 Fp
        self.plain = plain
        self.mont_r = 1 << (32 * n_words)
        self.r2_int = self.mont_r * self.mont_r % modulus
        self.mod_words = _words(modulus, n_words)
        self.r2_words = _words(self.r2_int, n_words)
        self.one_mont_words = _words(self.mont_r % modulus, n_words)
        self.one_std_words = _words(1, n_words)
        # -p^-1 mod 2^16 (the plain twin's digit) and mod 2^32 (the kernel's)
        self.nprime16 = (-pow(modulus, -1, 1 << 16)) % (1 << 16)
        self.nprime32 = (-pow(modulus, -1, 1 << 32)) % (1 << 32)

    def as_plain(self) -> "LimbField":
        """This field with every ring op on the plain PyTorch twin of K1,
        whatever the device."""
        return LimbField(self.modulus, self.W, self.name, self.kernel_id, plain=True)

    # ---- constructors --------------------------------------------------------

    def _col(self, words_np: np.ndarray, batch_ndim: int, device) -> torch.Tensor:
        t = torch.from_numpy(words_np.copy()).to(resolve_device(device))
        return t.reshape((self.W,) + (1,) * batch_ndim)

    def zeros(self, batch_shape=(), device=None) -> torch.Tensor:
        """Zeros on `device` (None: the configured default device)."""
        return torch.zeros((self.W,) + tuple(batch_shape), dtype=DTYPE,
                           device=resolve_device(device))

    def one(self, batch_shape=(), device=None) -> torch.Tensor:
        """Montgomery one, broadcast to a batch shape (a contiguous copy),
        on `device` (None: the configured default device)."""
        col = self._col(self.one_mont_words, len(batch_shape), device)
        return col.expand((self.W,) + tuple(batch_shape)).contiguous()

    # ---- host converters -----------------------------------------------------

    def from_ints(self, xs) -> np.ndarray:
        """(W, n) standard-form words (NOT Montgomery) from ints."""
        return ints_to_words([x % self.modulus for x in xs], self.W)

    def to_ints(self, arr) -> list:
        return words_to_ints(arr)

    def encode(self, xs) -> np.ndarray:
        """ints -> Montgomery-form (W, n) int32 numpy array (host math)."""
        m, r = self.modulus, self.mont_r
        return ints_to_words([(x % m) * r % m for x in xs], self.W)

    def decode(self, t: torch.Tensor) -> list:
        """Montgomery-form (W, ...) tensor -> list of ints."""
        return words_to_ints(self.from_mont(t))

    # ---- ring ops ------------------------------------------------------------

    def _binary(self, op, a, b):
        fn = cuda_field.binary_plain if self.plain else cuda_field.binary
        return fn(self, op, a, b)

    def add(self, a, b):
        return self._binary(cuda_field.ADD, a, b)

    def sub(self, a, b):
        return self._binary(cuda_field.SUB, a, b)

    def neg(self, a):
        """-a, with -0 = 0 (p - a would not be canonical at a = 0)."""
        return self.sub(torch.zeros_like(a), a)

    def mul(self, a, b):
        """Montgomery multiply: (a * b * R^-1) mod p."""
        return self._binary(cuda_field.MUL, a, b)

    def sqr(self, a):
        return self.mul(a, a)

    def mul_const(self, a, c_words: np.ndarray):
        """Montgomery multiply by a (W,) host constant."""
        fn = cuda_field.mul_const_plain if self.plain else cuda_field.mul_const
        return fn(self, a, c_words)

    def to_mont(self, a):
        return self.mul_const(a, self.r2_words)

    def from_mont(self, a):
        return self.mul_const(a, self.one_std_words)

    # ---- predicates ----------------------------------------------------------

    def is_zero(self, a):
        return (a == 0).all(dim=0)

    def eq(self, a, b):
        return (a == b).all(dim=0)

    def expand(self, cond):
        """A batch-shaped mask, broadcastable against elements."""
        return cond[None]

    def select(self, cond, a, b):
        """cond: batch-shaped bool; picks a where true."""
        return torch.where(cond[None], a, b)

    # ---- powers and inverses -------------------------------------------------

    def pow_static(self, a, e: int):
        """a^e for a Python-int exponent (square and multiply, LSB first):
        one launch of K1's chain kernel on a CUDA tensor, its plain loop on a
        CPU tensor or on the plain field."""
        fn = cuda_field.field_pow_plain if self.plain else cuda_field.field_pow
        return fn(self, a, e)

    def inv(self, a):
        """Fermat inverse a^(m-2); inv(0) = 0 by convention."""
        return self.pow_static(a, self.modulus - 2)

    def _prefix_scan(self, op, x, reverse: bool = False):
        """Inclusive running fold of `op` along the last axis: a doubling
        scan (ceil(log2 n) rounds of one whole-array op each)."""
        n = x.shape[-1]
        if n == 1:
            return x
        if reverse:
            x = torch.flip(x, dims=(-1,))
        idx = torch.arange(n, device=x.device)
        s = 1
        while s < n:
            shifted = torch.roll(x, s, dims=-1)
            x = torch.where(idx >= s, op(x, shifted), x)
            s <<= 1
        if reverse:
            x = torch.flip(x, dims=(-1,))
        return x

    def prefix_mul(self, x, reverse: bool = False):
        """Inclusive running product along the last axis, log-depth."""
        return self._prefix_scan(self.mul, x, reverse)

    def prefix_add(self, x, reverse: bool = False):
        """Inclusive running sum along the last axis, log-depth."""
        return self._prefix_scan(self.add, x, reverse)

    def sum_last(self, a):
        """Sum of field elements along the last axis: a pairwise tree of
        field adds (log-depth; the JAX package's raw-limb-sum trick relies on
        16-bit limbs with headroom that full 32-bit words do not have)."""
        while a.shape[-1] > 1:
            if a.shape[-1] % 2:
                a = torch.cat([a, torch.zeros_like(a[..., :1])], dim=-1)
            a = self.add(a[..., 0::2], a[..., 1::2])
        return a[..., 0]

    def batch_inv(self, a):
        """Inversion along the LAST axis with a pairwise product tree
        (Montgomery's trick in tree form, as `kzg_tpu/fields/limb.py:406`):
        up-sweep of pairwise products, one Fermat inverse at the root,
        down-sweep to the leaves. inv(0) = 0 elementwise."""
        zero_mask = self.is_zero(a)
        batch = a.shape[1:]
        x = torch.where(zero_mask[None], self.one(batch, a.device), a)
        n = x.shape[-1]
        npow = 1 << max(0, (n - 1).bit_length())
        if npow != n:
            pad = self.one(tuple(batch[:-1]) + (npow - n,), a.device)
            x = torch.cat([x, pad], dim=-1)
        levels = [x]
        while x.shape[-1] > 1:
            x = self.mul(x[..., 0::2], x[..., 1::2])
            levels.append(x)
        inv = self.inv(x)
        for lev in levels[-2::-1]:
            inv_left = self.mul(inv, lev[..., 1::2])
            inv_right = self.mul(inv, lev[..., 0::2])
            inv = torch.stack([inv_left, inv_right], dim=-1).reshape(lev.shape)
        inv = inv[..., :n]
        return torch.where(zero_mask[None], torch.zeros_like(inv), inv)
