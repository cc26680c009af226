"""Kernel K1: elementwise Montgomery field arithmetic, and its plain twin.

Replaces the Pallas elementwise field kernels `FieldKernels.try_binary` /
`try_mul_const` (`kzg_tpu/fields/pallas_field.py:433,442`, launched by
`_run_elementwise`, `:273-305`), which serve `LimbField.add/sub/mul/sqr/
mul_const/to_mont/from_mont` (`kzg_tpu/fields/limb.py:188-287`).

CUDA side (`csrc/field_kernels.cu`, arithmetic in `csrc/field.cuh`): one
thread per element, the 8 (Fr) or 12 (Fp) 32-bit words of each operand in
registers, CIOS Montgomery multiplication with 64-bit products and one
conditional subtraction into [0, p). Bound on the H100: integer multiply
throughput for `mul` (a 12-word product is 288 32x32->64 multiply-adds),
device-memory bytes for `add`/`sub` (3 x 48 B per Fp element, ~10 integer
ops per word). Limb-major `(W, n)` layout makes every word load and store
coalesced: thread i touches word l at `l * n + i`.

Plain twin (`binary_plain`, `mul_const_plain`): the same function in
PyTorch integer ops. It unpacks each 32-bit word into two 16-bit limbs held
in int64 (16x16-bit products and their column sums stay far below 2^63;
torch has no usable uint32 arithmetic), runs the same Montgomery
algorithm one 16-bit digit at a time, and repacks. Both produce the
canonical Montgomery integers, so they agree bit for bit.

`binary` / `mul_const` are the wrappers: a CPU tensor takes the plain twin,
a CUDA tensor launches K1 (or raises), any other device raises.

Kernel K5 (`ntt_stage`, `csrc/ntt_kernels.cu`), the NTT butterfly stage
that replaces `make_ntt_stage` (`pallas_field.py:346`), is wrapped here too,
with its plain twins `ntt_stage_plain` (the butterfly) and
`ntt_stage_layout_plain` (the whole stage with K5's twiddle indexing and
interleaved output).

Kernel K8 (`mul_chain`, `csrc/field_kernels.cu`) replaces `make_mul_chain`
(`pallas_field.py:323`): acc = a, then k times acc = acc * b, in one
launch. It is the speed-of-light probe of `bench.peaks.mul_peak`: timing
two chain lengths and taking the difference cancels launch and dispatch.
One thread an element, operands loaded once, the k dependent CIOS products
in registers, one store; k is a launch argument and the loop is kept
rolled. Bound: k (2 N^2 + N) multiply-adds an element; the bytes are three
rows whatever k. Plain version: `mul_chain_plain`.

`field_pow` (`csrc/field_kernels.cu`, counted as `field_pow`) is K1's
Fermat chain in one launch: a^e for a Python-int exponent, square and
multiply LSB first, as the chain of K1 launches that `pow_static` ran
(`kzg_tpu/fields/limb.py:303-320` over `_run_elementwise`,
`pallas_field.py:295`). One element a warp; each step's two products
(acc * base and base^2) run side by side on the two half-warps, each spread
over 16 lanes (`csrc/coop.cuh`). Bound: the latency of nbits dependent
products. Plain version: `field_pow_plain`; `field_pow_chain` is the
route it replaced (one K1 launch a step), kept for the bench.
"""

import ctypes

import numpy as np
import torch

from .. import kernels

_K1 = kernels.REGISTRY["field_elementwise"]

ADD, SUB, MUL = 0, 1, 2
_MASK16 = 0xFFFF


# ---- packed-word layout (see fields/limb.py) --------------------------------

def unpack16(words: torch.Tensor) -> torch.Tensor:
    """(W, *batch) int32 packed words -> (2W, *batch) int64 16-bit limbs.
    Goes through int64 with a 32-bit mask: an arithmetic shift of an int32
    word >= 2^31 would sign-extend into the high limb."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([w & _MASK16, w >> 16], dim=1).reshape(
        (2 * words.shape[0],) + tuple(words.shape[1:])
    )


def pack16(limbs: torch.Tensor) -> torch.Tensor:
    """(2W, *batch) int64 limbs in [0, 2^16) -> (W, *batch) int32 words
    (values >= 2^31 wrap to the negative int32 with the same bits)."""
    v = limbs[0::2] | (limbs[1::2] << 16)
    return torch.where(v >= (1 << 31), v - (1 << 32), v).to(torch.int32)


def _limbs_const(words_np: np.ndarray, device) -> torch.Tensor:
    """(W,) host words -> (2W, 1) int64 limb column on `device`."""
    t = torch.from_numpy(np.ascontiguousarray(words_np, dtype=np.int32))
    return unpack16(t.to(device)).reshape(-1, 1)


# ---- plain twin: 16-bit digits in int64 --------------------------------------

def _normalize(d: torch.Tensor):
    """Exact carry resolution of signed int64 digit rows: returns (limbs in
    [0, 2^16), carry out of the top limb). Vector passes move every carry
    one limb up; the loop ends when no digit is out of range."""
    d = d.clone()
    top = torch.zeros_like(d[0])
    while True:
        hi = d >> 16  # arithmetic shift = floor division, also for negatives
        if not bool(hi.any()):
            return d, top
        d &= _MASK16
        d[1:] += hi[:-1]
        top += hi[-1]


def _reduce_once(t: torch.Tensor, carry: torch.Tensor, mod: torch.Tensor):
    """(t + carry * 2^(16L)) - mod when that is >= 0, else t; t normalised,
    the value below 2 * mod."""
    d, borrow = _normalize(t - mod)
    return torch.where(((borrow + carry) >= 0)[None], d, t)


def _add16(a, b, mod):
    s, carry = _normalize(a + b)
    return _reduce_once(s, carry, mod)


def _sub16(a, b, mod):
    d, borrow = _normalize(a - b)
    plus, _ = _normalize(d + mod)
    return torch.where((borrow < 0)[None], plus, d)


def _mont_mul16(a, b, mod, nprime16: int):
    """Montgomery product a * b * 2^(-16L) mod p, operand scanning over
    16-bit digits with lazy carries (each row of `t` is one digit position;
    a row's digit may exceed 2^16 until the final normalisation)."""
    L = a.shape[0]
    t = torch.zeros((2 * L,) + tuple(a.shape[1:]), dtype=torch.int64, device=a.device)
    for i in range(L):
        win = t[i:i + L]
        win.addcmul_(a[i], b)
        m = ((t[i] & _MASK16) * nprime16) & _MASK16
        win.addcmul_(m, mod)
        t[i + 1] += t[i] >> 16  # row i is now 0 mod 2^16
    hi, carry = _normalize(t[L:])
    return _reduce_once(hi, carry, mod)


def _flat(x: torch.Tensor, W: int) -> torch.Tensor:
    return x.reshape(W, -1)


def binary_plain(field, op: int, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of K1 on any device: add / sub / mul of packed
    (W, *batch) int32 tensors (broadcast against each other)."""
    a, b = torch.broadcast_tensors(a, b)
    shape = a.shape
    x = unpack16(_flat(a, field.W))
    y = unpack16(_flat(b, field.W))
    mod = _limbs_const(field.mod_words, a.device)
    if op == ADD:
        r = _add16(x, y, mod)
    elif op == SUB:
        r = _sub16(x, y, mod)
    elif op == MUL:
        r = _mont_mul16(x, y, mod, field.nprime16)
    else:
        raise ValueError(f"bad op {op}")
    return pack16(r).reshape(shape)


def mul_const_plain(field, a: torch.Tensor, c_words: np.ndarray) -> torch.Tensor:
    """Plain twin of K1's multiply-by-constant (`c_words`: (W,) host words)."""
    c = torch.from_numpy(np.ascontiguousarray(c_words, dtype=np.int32)).to(a.device)
    return binary_plain(field, MUL, a, c.reshape((field.W,) + (1,) * (a.dim() - 1)))


# ---- K1 wrappers -------------------------------------------------------------

def _check_operand(field, x: torch.Tensor, device):
    if x.dtype != torch.int32:
        raise kernels.KernelError(f"{field.name}: expected int32 words, got {x.dtype}")
    if x.dim() < 1 or x.shape[0] != field.W:
        raise kernels.KernelError(
            f"{field.name}: expected ({field.W}, ...) words, got {tuple(x.shape)}"
        )
    if x.device != device:
        raise kernels.KernelError(f"{field.name}: operands on {x.device} and {device}")


def _device_kind(x: torch.Tensor) -> str:
    kind = x.device.type
    if kind not in ("cpu", "cuda"):
        raise kernels.KernelError(f"no field kernel for device {x.device}")
    return kind


def binary(field, op: int, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K1 add / sub / mul: the plain twin for CPU tensors, the CUDA kernel
    for CUDA tensors."""
    a, b = torch.broadcast_tensors(a, b)
    if _device_kind(a) == "cpu":
        return binary_plain(field, op, a, b)
    _check_operand(field, a, a.device)
    _check_operand(field, b, a.device)
    a = a.contiguous()
    b = b.contiguous()
    out = torch.empty_like(a)
    n = a.numel() // field.W
    if n == 0:
        return out
    rc = kernels.library().kzg_field_binary(
        field.kernel_id, op, out.data_ptr(), a.data_ptr(), b.data_ptr(), n,
        kernels.stream_handle(a.device),
    )
    kernels.check_status(rc, f"{field.name} elementwise op {op}")
    _K1.launches += 1
    return out


def mul_const(field, a: torch.Tensor, c_words: np.ndarray) -> torch.Tensor:
    """K1 Montgomery multiply by a (W,) host constant (mul_const, to_mont,
    from_mont). The constant travels as a kernel argument, by value."""
    if _device_kind(a) == "cpu":
        return mul_const_plain(field, a, c_words)
    _check_operand(field, a, a.device)
    a = a.contiguous()
    out = torch.empty_like(a)
    n = a.numel() // field.W
    if n == 0:
        return out
    c = np.ascontiguousarray(c_words, dtype=np.uint32)
    if c.shape != (field.W,):
        raise kernels.KernelError(f"{field.name}: constant must be ({field.W},) words")
    rc = kernels.library().kzg_field_mul_const(
        field.kernel_id, out.data_ptr(), a.data_ptr(),
        c.ctypes.data_as(ctypes.c_void_p), n, kernels.stream_handle(a.device),
    )
    kernels.check_status(rc, f"{field.name} mul_const")
    _K1.launches += 1
    return out


# ---- standalone entries over K1 ------------------------------------------------------
#
# `make_mul` / `make_add` / `make_sub` of `kzg_tpu/fields/pallas_field.py:
# 312,367,377`: each returns the two-operand function of one field, which
# launches K1 on CUDA tensors and runs the plain twin on CPU tensors.

def _make_binary(field, op: int, name: str):
    def fn(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return binary(field, op, a, b)

    fn.__name__ = name
    fn.__doc__ = f"Elementwise Montgomery {name} over {field.name} words, (W, *batch)."
    return fn


def make_mul(field):
    return _make_binary(field, MUL, "mul")


def make_add(field):
    return _make_binary(field, ADD, "add")


def make_sub(field):
    return _make_binary(field, SUB, "sub")


# ---- K8: the multiply chain ---------------------------------------------------------

_K8 = kernels.REGISTRY["mul_chain"]


def mul_chain_plain(field, k: int, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of K8 on any device: acc = a, then k sequential
    Montgomery products acc = acc * b over (W, *batch) words."""
    a, b = torch.broadcast_tensors(a, b)
    mod = _limbs_const(field.mod_words, a.device)
    acc = unpack16(_flat(a, field.W))
    y = unpack16(_flat(b, field.W))
    for _ in range(k):
        acc = _mont_mul16(acc, y, mod, field.nprime16)
    return pack16(acc).reshape(a.shape)


def mul_chain(field, k: int, a: torch.Tensor, b: torch.Tensor,
              cooperative: bool = False) -> torch.Tensor:
    """K8: a * b^k * R^-k in one launch (k >= 0 dependent Montgomery
    products). The plain version for CPU tensors, the CUDA kernel for CUDA
    tensors: one thread an element, or with `cooperative` one warp an
    element, each product spread over 16 lanes as kernel K4 runs it
    (`csrc/coop.cuh`). Both give the same words."""
    if k < 0:
        raise ValueError("chain length must be >= 0")
    a, b = torch.broadcast_tensors(a, b)
    if _device_kind(a) == "cpu":
        return mul_chain_plain(field, k, a, b)
    _check_operand(field, a, a.device)
    _check_operand(field, b, a.device)
    a = a.contiguous()
    b = b.contiguous()
    out = torch.empty_like(a)
    n = a.numel() // field.W
    if n == 0:
        return out
    lib = kernels.library()
    entry = lib.kzg_field_mul_chain_coop if cooperative else lib.kzg_field_mul_chain
    rc = entry(field.kernel_id, out.data_ptr(), a.data_ptr(), b.data_ptr(), k, n,
               kernels.stream_handle(a.device))
    kernels.check_status(rc, f"{field.name} mul_chain k={k}")
    _K8.launches += 1
    return out


def make_mul_chain(field, k: int):
    """`make_mul_chain` of `kzg_tpu/fields/pallas_field.py:323`: the
    two-operand function running k dependent multiplies in one launch."""
    def fn(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return mul_chain(field, k, a, b)

    fn.__name__ = f"mul_chain_{k}"
    fn.__doc__ = f"acc = a; {k} times acc = acc * b (Montgomery) over {field.name} words."
    return fn


# ---- K1's Fermat chain: a^e in one launch ---------------------------------------------

_POW = kernels.REGISTRY["field_pow"]


def _pow_loop(field, mul, a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e by square and multiply, LSB first, on the two-operand `mul`."""
    acc = field.one(tuple(a.shape[1:]), a.device)
    base = a
    while e:
        if e & 1:
            acc = mul(acc, base)
        e >>= 1
        if e:
            base = mul(base, base)
    return acc


def field_pow_plain(field, a: torch.Tensor, e: int) -> torch.Tensor:
    """Plain version of `field_pow` on any device: the square-and-multiply
    loop on the plain Montgomery product."""
    return _pow_loop(field, lambda x, y: binary_plain(field, MUL, x, y), a, e)


def field_pow_chain(field, a: torch.Tensor, e: int) -> torch.Tensor:
    """The same loop with every product a K1 launch on a CUDA tensor: the
    chain `field_pow` replaced (`bench.ladder` times the two)."""
    return _pow_loop(field, lambda x, y: binary(field, MUL, x, y), a, e)


def field_pow(field, a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e (Montgomery words, (W, *batch)) for a Python-int exponent
    0 <= e < 2^(32 W). The plain version for CPU tensors; for CUDA tensors
    one launch of the chain kernel, whatever e."""
    if e < 0 or e.bit_length() > 32 * field.W:
        raise ValueError(f"exponent must be in [0, 2^{32 * field.W})")
    if _device_kind(a) == "cpu":
        return field_pow_plain(field, a, e)
    _check_operand(field, a, a.device)
    a = a.contiguous()
    out = torch.empty_like(a)
    n = a.numel() // field.W
    if n == 0:
        return out
    e_words = np.frombuffer(e.to_bytes(4 * field.W, "little"), dtype="<u4").copy()
    rc = kernels.library().kzg_field_pow(
        field.kernel_id, out.data_ptr(), a.data_ptr(),
        e_words.ctypes.data_as(ctypes.c_void_p), e.bit_length(), n,
        kernels.stream_handle(a.device),
    )
    kernels.check_status(rc, f"{field.name} field_pow ({e.bit_length()} bits)")
    _POW.launches += 1
    return out


# ---- K5: one NTT butterfly stage ----------------------------------------------------

_K5 = kernels.REGISTRY["ntt_stage"]


def _fr():
    from . import FR  # fields/__init__ builds FR from this module

    return FR


def ntt_stage_plain(a: torch.Tensor, b: torch.Tensor, w: torch.Tensor):
    """Plain twin of the butterfly of K5 and of `make_ntt_stage`
    (`kzg_tpu/fields/pallas_field.py:346`): (a + b, (a - b) * w) over
    Montgomery Fr (8, ...) words, broadcast, on any device."""
    fr = _fr()
    return binary_plain(fr, ADD, a, b), binary_plain(fr, MUL, binary_plain(fr, SUB, a, b), w)


def ntt_stage_layout_plain(x: torch.Tensor, tw: torch.Tensor, s: int) -> torch.Tensor:
    """Plain twin of K5 on any device: stage s of the DIF loop over
    x (8, nb, m, bt), transforms along axis 2. Butterfly j < m/2 pairs rows
    j and j + m/2 with twiddle tw[:, j & ~(2^s - 1)] and writes rows 2j and
    2j + 1 (`kzg_tpu/ntt/domain.py:327-345, 394-410`)."""
    W, nb, m, bt = x.shape
    h = m // 2
    j = torch.arange(h, device=x.device)
    w = tw[:, j & ~((1 << s) - 1)].reshape(W, 1, h, 1)
    u, v = ntt_stage_plain(x[:, :, :h], x[:, :, h:], w)
    return torch.stack([u, v], dim=3).reshape(x.shape)


def ntt_stage(x: torch.Tensor, tw: torch.Tensor, s: int) -> torch.Tensor:
    """K5: one DIF butterfly stage (see `ntt_stage_layout_plain`), the
    plain twin for CPU tensors, the CUDA kernel for CUDA tensors.
    x: (8, nb, m, bt) int32 Montgomery Fr words; tw: (8, >= m/2) the
    domain's half twiddle table. Returns a new (8, nb, m, bt) tensor."""
    if _device_kind(x) == "cpu":
        return ntt_stage_layout_plain(x, tw, s)
    fr = _fr()
    _check_operand(fr, x, x.device)
    _check_operand(fr, tw, x.device)
    if x.dim() != 4 or tw.dim() != 2 or x.shape[2] % 2 or tw.shape[1] < x.shape[2] // 2:
        raise kernels.KernelError(
            f"ntt_stage: x must be (8, nb, m, bt) with m even and tw (8, >= m/2), "
            f"got {tuple(x.shape)} and {tuple(tw.shape)}"
        )
    _, nb, m, bt = x.shape
    x = x.contiguous()
    tw = tw.contiguous()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    rc = kernels.library().kzg_ntt_stage(
        out.data_ptr(), x.data_ptr(), tw.data_ptr(), nb, m, bt, tw.shape[1], s,
        kernels.stream_handle(x.device),
    )
    kernels.check_status(rc, f"ntt_stage {tuple(x.shape)} s={s}")
    _K5.launches += 1
    return out
