"""DFT-as-matmul NTT blocks (port of `kzg_tpu/ntt/mxu.py`): 8-bit limb-plane
integer products on the tensor cores and kernel K9, the reduce epilogue.

A size-C DFT block is a matrix product, Y[k] = sum_j W[k, j] X[j], and
multi-word modular arithmetic splits it into integer products:

  * an element (Montgomery form, 8 packed words) is 32 base-256 planes;
  * the product's base-256 digit sums are EXACT integer matrix products over
    the (plane, j) axes: y_d[k, t] = sum_{a + b = d} sum_j W_a[k, j] x_b[j, t],
    written as ONE (64 C, 32 C) @ (32 C, T) product of 8-bit operands with a
    block-banded left side (Wbig[d C + k, b C + j] = plane_{d - b}(W)[k, j]);
  * no sum overflows 32 bits: 255^2 * 32 plane pairs * 128 terms = 2.7e8;
  * kernel K9 (`mxu_reduce`, `csrc/mxu_kernels.cu`; replaces
    `_make_reduce_kernel`, `kzg_tpu/ntt/mxu.py:135`) does, per element, the
    base-256 carry ripple, folds the part at and above 2^504 back with
    2^504 mod r, and Montgomery-reduces to the canonical element.

W holds Montgomery-form entries, so the product accumulates
(sum w x) R^2 and ONE Montgomery reduction per output element restores
Montgomery form. Composed with the four-step recursion of `ntt/domain.py`,
a 2^20 NTT is three such passes (C = 128, 64, 128), two twiddle multiplies
and the transposes.

The product itself is a library call, as in the JAX package (its
`jax.lax.dot_general`): on a card `torch._int_mm`, the int8 tensor-core
product with an int32 result. It takes SIGNED 8-bit operands, so both sides
are shifted by 128 (for a byte that is `x ^ 0x80` read as int8) and the
shift is added back exactly: W X = W' X' + 128 rowsum(W') + 128 colsum(X')
+ 128^2 K. The right side is handed over column-major (a transposed view
of a (T, 32 C) array, which is how `to_planes` lays it out): the library's
int8 path wants that layout and is 7x slower on a row-major one (0.61
against 4.27 ms at (8192 x 4096) @ (4096 x 8192) on an H100). The plain
version of the product, used for CPU tensors and by
the plain twin of a domain, is a float64 `torch.matmul` (every sum is below
2^53, so it is exact as well). Half of Wbig is structurally zero (the
band); neither route uses that yet.

`dft_axis2` is the drop-in for `Domain._ntt_axis2` on blocks of up to
2^_MAX_EXP points: natural order in and out, the inverse direction folds the
block's own 1/C into W.
"""

import numpy as np
import torch

from .. import kernels
from ..constants import R
from ..fields import FR, cuda_field

# 8-bit planes of an element: Fr = 8 words = 32 planes
PLANES = 4 * FR.W
# digit rows of the plane convolution (digits 0 .. 2 PLANES - 2, padded to
# 2 PLANES)
OUT_DIGITS = 2 * PLANES
# digits from here up are folded back with 2^(8 FOLD_DIGIT) mod r
FOLD_DIGIT = OUT_DIGITS - 1  # 63: 2^504
_K_FOLD = [(pow(2, 8 * FOLD_DIGIT, R) >> (16 * i)) & 0xFFFF for i in range(2 * FR.W)]

_MAX_EXP = 7  # DFT blocks of up to 128 points

_K9 = kernels.REGISTRY["mxu_reduce"]


def _to_planes_np(words: np.ndarray) -> np.ndarray:
    """(W, ...) packed 32-bit words -> (4 W, ...) uint8 planes, plane p
    holding bits 8 p .. 8 p + 7 of the element."""
    w = np.asarray(words).astype(np.int64) & 0xFFFFFFFF
    out = np.empty((4 * w.shape[0],) + w.shape[1:], np.uint8)
    for k in range(4):
        out[k::4] = (w >> (8 * k)) & 0xFF
    return out


def _w_big_np(exp: int, inverse: bool) -> np.ndarray:
    """The (OUT_DIGITS C, PLANES C) uint8 block-banded left side of the DFT
    product for a block of C = 2^exp points, Montgomery-form entries; the
    inverse direction folds in the block's own 1 / C."""
    from .domain import Domain

    dom = Domain(exp)
    C = 1 << exp
    base = dom.omega_inv if inverse else dom.omega
    scale = pow(C, -1, R) if inverse else 1
    ints = []
    for k in range(C):
        wk = pow(base, k, R)
        cur = scale % R
        for _ in range(C):  # row k: scale * base^(k j), j = 0 .. C - 1
            ints.append(cur)
            cur = cur * wk % R
    planes = _to_planes_np(FR.encode(ints).reshape(FR.W, C, C))  # (PLANES, C, C)
    big = np.zeros((OUT_DIGITS, C, PLANES, C), np.uint8)
    for d in range(OUT_DIGITS):
        for b in range(max(0, d - PLANES + 1), min(PLANES, d + 1)):
            big[d, :, b, :] = planes[d - b]
    return big.reshape(OUT_DIGITS * C, PLANES * C)


_WBIG_NP = {}
_WBIG_DEV = {}


def _wbig(exp: int, inverse: bool) -> np.ndarray:
    key = (exp, inverse)
    if key not in _WBIG_NP:
        _WBIG_NP[key] = _w_big_np(exp, inverse)
    return _WBIG_NP[key]


def _wbig_device(exp: int, inverse: bool, device, signed: bool):
    """The table on `device`, cached: float64 for the plain product, or
    (int8 table shifted by 128, int32 row correction) for `torch._int_mm`."""
    key = (exp, inverse, torch.device(device), signed)
    if key not in _WBIG_DEV:
        w = torch.from_numpy(_wbig(exp, inverse)).to(device)
        if signed:
            shifted = w.bitwise_xor(0x80).view(torch.int8)
            rows = shifted.sum(dim=1, dtype=torch.int32)
            _WBIG_DEV[key] = (shifted, 128 * rows + 128 * 128 * w.shape[1])
        else:
            _WBIG_DEV[key] = w.to(torch.float64)
    return _WBIG_DEV[key]


def mxu_available(device) -> bool:
    """Whether a transform of a tensor on `device` takes the matmul-DFT
    path: config.ntt_mxu "off" never, "force" always, "auto" on a card."""
    from ..config import get_config

    mode = get_config().ntt_mxu
    if mode == "off":
        return False
    if mode == "force":
        return True
    return torch.device(device).type == "cuda"


# ---- the product ---------------------------------------------------------------------

def digit_sums_plain(exp: int, inverse: bool, planes: torch.Tensor) -> torch.Tensor:
    """Wbig @ planes by a float64 matmul, exact (sums below 2^53), on any
    device: (PLANES C, T) uint8 -> (OUT_DIGITS C, T) int32."""
    w = _wbig_device(exp, inverse, planes.device, signed=False)
    return torch.matmul(w, planes.to(torch.float64)).to(torch.int32)


def digit_sums(exp: int, inverse: bool, planes: torch.Tensor) -> torch.Tensor:
    """Wbig @ planes: (PLANES C, T) uint8 -> (OUT_DIGITS C, T) int32, exact.
    CPU tensors take the float64 product, CUDA tensors `torch._int_mm` on
    operands shifted by 128 with the shift added back (module docstring)."""
    if planes.device.type == "cpu":
        return digit_sums_plain(exp, inverse, planes)
    if planes.device.type != "cuda":
        raise kernels.KernelError(f"no matmul-DFT product for device {planes.device}")
    w, row_fix = _wbig_device(exp, inverse, planes.device, signed=True)
    t = planes.shape[1]
    pad = (-t) % 8  # _int_mm wants a column count that is a multiple of 8
    xt = planes.t().contiguous().bitwise_xor(0x80).view(torch.int8)  # (T, 32 C)
    if pad:
        xt = torch.cat([xt, xt.new_zeros((pad, xt.shape[1]))])
    y = torch._int_mm(w, xt.t())
    y += row_fix[:, None]
    y += (128 * xt.sum(dim=1, dtype=torch.int32))[None, :]
    return y[:, :t] if pad else y


# ---- K9: the reduce epilogue -----------------------------------------------------------

def mxu_reduce_plain(y: torch.Tensor) -> torch.Tensor:
    """Plain version of K9 on any device, the arithmetic of `_reduce_body`
    (`kzg_tpu/ntt/mxu.py:103`) on int64 tensors: (OUT_DIGITS, B) digit sums
    (each in [0, 2^29)) -> (8, B) canonical Montgomery Fr words."""
    y = y.to(torch.int64)
    digs = []
    carry = torch.zeros_like(y[0])
    for i in range(OUT_DIGITS):
        t = y[i] + carry
        digs.append(t & 0xFF)
        carry = t >> 8
    b = digs[FOLD_DIGIT] + (carry << 8)  # the part at and above 2^504
    l16 = [digs[2 * k] + (digs[2 * k + 1] << 8) for k in range(FOLD_DIGIT // 2)]
    l16.append(digs[FOLD_DIGIT - 1])
    for j, kj in enumerate(_K_FOLD):  # + b * (2^504 mod r)
        l16[j] = l16[j] + b * kj
    t, _ = cuda_field._normalize(torch.stack(l16))  # below 2^512: no carry out
    # Montgomery reduction of the 32 limbs, one 16-bit digit a round
    mod = cuda_field._limbs_const(FR.mod_words, y.device)
    L = 2 * FR.W
    for i in range(L):
        m = ((t[i] & 0xFFFF) * FR.nprime16) & 0xFFFF
        t[i:i + L].addcmul_(m, mod)
        t[i + 1] += t[i] >> 16  # row i is now 0 mod 2^16
    hi, carry = cuda_field._normalize(t[L:])
    return cuda_field.pack16(cuda_field._reduce_once(hi, carry, mod))


def mxu_reduce(y: torch.Tensor) -> torch.Tensor:
    """K9: (OUT_DIGITS, B) int32 digit sums -> (8, B) Montgomery Fr words;
    the plain version for CPU tensors, the CUDA kernel for CUDA tensors."""
    if y.device.type == "cpu":
        return mxu_reduce_plain(y)
    if y.device.type != "cuda":
        raise kernels.KernelError(f"no reduce kernel for device {y.device}")
    if y.dtype != torch.int32 or y.dim() != 2 or y.shape[0] != OUT_DIGITS:
        raise kernels.KernelError(
            f"mxu_reduce: expected int32 ({OUT_DIGITS}, B) digit sums, got "
            f"{y.dtype} {tuple(y.shape)}")
    y = y.contiguous()
    n = y.shape[1]
    out = torch.empty((FR.W, n), dtype=torch.int32, device=y.device)
    if n == 0:
        return out
    rc = kernels.library().kzg_mxu_reduce(
        out.data_ptr(), y.data_ptr(), n, kernels.stream_handle(y.device))
    kernels.check_status(rc, f"mxu_reduce {tuple(y.shape)}")
    _K9.launches += 1
    return out


# ---- the DFT block transform -------------------------------------------------------------

def to_planes(x: torch.Tensor, exp: int) -> torch.Tensor:
    """(8, *lead, C, bt) words -> the product's right side, (PLANES C, T)
    uint8 with T = prod(lead) * bt, row p C + j = plane p of block row j,
    stored column-major (the transposed view of a contiguous (T, PLANES C)
    array: the layout the int8 product is fast on). The bytes of a
    little-endian word are its four planes, so this is one byte view and
    one transposing copy."""
    C = 1 << exp
    xm = x.movedim(-2, 1).reshape(FR.W, C, -1).contiguous()
    t = xm.shape[-1]
    rows = xm.view(torch.uint8).reshape(FR.W, C, t, 4).permute(2, 0, 3, 1)  # (T, word, byte, j)
    return rows.reshape(t, PLANES * C).t()


def dft_axis2(exp: int, inverse: bool, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
    """Size-2^exp DFT over axis -2 of (8, *lead, C, bt) by the matmul path.
    Natural order in and out; the inverse folds this block's 1 / C.
    plain=True runs the plain product and the plain version of K9 whatever
    the device."""
    if exp > _MAX_EXP:
        raise ValueError(f"DFT block 2^{exp} exceeds 2^{_MAX_EXP}")
    C = 1 << exp
    lead = tuple(x.shape[1:-2])
    bt = x.shape[-1]
    planes = to_planes(x, exp)
    if plain:
        out = mxu_reduce_plain(digit_sums_plain(exp, inverse, planes).reshape(OUT_DIGITS, -1))
    else:
        out = mxu_reduce(digit_sums(exp, inverse, planes).reshape(OUT_DIGITS, -1))
    return out.reshape((FR.W, C) + lead + (bt,)).movedim(1, -2)
