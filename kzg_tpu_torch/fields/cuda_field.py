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

Kernel K5 replaces `make_ntt_stage` (`pallas_field.py:346`) in two
entries, wrapped here. `ntt_block` (`csrc/ntt_block.cuh`, counted as
`ntt_block`) is the Domain's route: one launch transforms every column of
an (8, nb, m, bt) array, m <= 2^12, all stages in shared memory, natural
order out, with per-element scales (`NttScale`: the coset powers, 1/d,
the four-step twiddle) fused before and after and an optional output
column stride (the four-step transpose); plain twin `ntt_block_plain`.
`ntt_stage` (`csrc/ntt_kernels.cu`) is one butterfly stage a launch, the
route as it was (the stage loop of `Domain.as_plain()` / `as_stages()`),
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

`field_scan` (`csrc/scan.cuh`, `csrc/scan_kernels.cu`, counted as
`field_scan`) replaces the rounds of K1 launches of `_prefix_scan` and
`sum_last` (`kzg_tpu/fields/limb.py:337,385` over `_run_elementwise`,
`pallas_field.py:295`): an inclusive scan of mul or add along the last
axis, forward or reverse, of an array, of a column broadcast along n
(never built), or only each row's fold. A block stages a tile of 1024
elements of one row in shared memory with coalesced loads, each thread
folds a run of 4 in registers, the runs' totals are scanned across the warp
by shuffles and across the warps through shared memory. Longer rows take a
pass for the tiles' totals, the totals' own scan, and a pass from each
tile's carry: 1-3 launches up to 2^20 elements. Its pair mode scans each
row both ways in one pass, exclusive, the two halves of the output written
in place (`batch_inv`'s prefix and suffix products, with no copy of the
input reversed). Bound: the bytes in and out
at these widths, or n products; the launches it saves are the point.
Plain version: `field_scan_plain` (the doubling rounds and the pairwise
tree on the plain twin); `field_scan_chain` is the same rounds on K1, the
route it replaced.
"""

import ctypes
from dataclasses import dataclass

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


# ---- field_scan: prefix scans and folds in a few tile passes ---------------------------

_SCAN = kernels.REGISTRY["field_scan"]
SCAN_THREADS = 256  # csrc/scan.cuh kScanThreads
SCAN_RUN = 4  # kScanRun: elements a thread
SCAN_TILE = SCAN_THREADS * SCAN_RUN  # kScanTile: elements a block
SCAN_REVERSE, SCAN_PAIR, SCAN_EXCLUSIVE = 1, 2, 4  # kScanReverse, kScanPair, kScanExclusive
SCAN_MODES = ("array", "column", "total", "pair")


def _identity(field, op, shape, device) -> torch.Tensor:
    if op == MUL:
        return field.one(shape, device)
    return torch.zeros((field.W,) + tuple(shape), dtype=torch.int32, device=device)


def _doubling_scan(field, binop, op, x: torch.Tensor, reverse: bool) -> torch.Tensor:
    """Inclusive running fold along the last axis by doubling: ceil(log2 n)
    rounds of one whole-array `binop`, a roll and a select each."""
    n = x.shape[-1]
    if n <= 1:
        return x
    if reverse:
        x = torch.flip(x, dims=(-1,))
    idx = torch.arange(n, device=x.device)
    s = 1
    while s < n:
        x = torch.where(idx >= s, binop(field, op, x, torch.roll(x, s, dims=-1)), x)
        s <<= 1
    if reverse:
        x = torch.flip(x, dims=(-1,))
    return x


def _fold_tree(field, binop, op, a: torch.Tensor) -> torch.Tensor:
    """Fold along the last axis: a pairwise tree of whole-array `binop`s,
    an identity appended at odd levels."""
    if a.shape[-1] == 0:
        return _identity(field, op, a.shape[1:-1], a.device)
    while a.shape[-1] > 1:
        if a.shape[-1] % 2:
            a = torch.cat([a, _identity(field, op, a.shape[1:-1] + (1,), a.device)], dim=-1)
        a = binop(field, op, a[..., 0::2], a[..., 1::2])
    return a[..., 0]


def _scan_loop(field, binop, op, x, reverse, mode, n):
    if mode == "column":
        x = x[..., None].expand(tuple(x.shape) + (n,))
    if mode == "total":
        return _fold_tree(field, binop, op, x)
    if mode == "pair":
        if x.shape[-1] == 0:
            return torch.stack([x, x])
        ident = _identity(field, op, x.shape[1:-1] + (1,), x.device)
        pre = _doubling_scan(field, binop, op, x, False)
        suf = _doubling_scan(field, binop, op, x, True)
        return torch.stack([torch.cat([ident, pre[..., :-1]], dim=-1),
                            torch.cat([suf[..., 1:], ident], dim=-1)])
    return _doubling_scan(field, binop, op, x, reverse)


def _check_scan_args(op, mode, n):
    if op not in (ADD, MUL):
        raise ValueError(f"scan op must be ADD or MUL, got {op}")
    if mode not in SCAN_MODES:
        raise ValueError(f"scan mode must be one of {SCAN_MODES}, got {mode!r}")
    if mode == "column" and (n is None or n < 0):
        raise ValueError("a column scan needs a length n >= 0")


def field_scan_plain(field, op: int, x: torch.Tensor, reverse: bool = False,
                     mode: str = "array", n=None) -> torch.Tensor:
    """Plain version of `field_scan` on any device: the doubling scan (a
    fold: the pairwise tree) on the plain K1 twin."""
    _check_scan_args(op, mode, n)
    return _scan_loop(field, binary_plain, op, x, reverse, mode, n)


def field_scan_chain(field, op: int, x: torch.Tensor, reverse: bool = False,
                     mode: str = "array", n=None) -> torch.Tensor:
    """The same rounds with every operation a K1 launch on a CUDA tensor:
    the chain `field_scan` replaced (the smoke times the two)."""
    _check_scan_args(op, mode, n)
    return _scan_loop(field, binary, op, x, reverse, mode, n)


def _scan_pass(field, op, src, n, rows, flags, out=None, totals=None, carry=None):
    """One launch of the scan kernel: src = (tensor, word, row and element
    strides)."""
    t, ws, rs, es = src
    ptr = lambda v: None if v is None else v.data_ptr()  # noqa: E731
    rc = kernels.library().kzg_field_scan(
        field.kernel_id, op, ptr(out), t.data_ptr(), ws, rs, es, ptr(totals), ptr(carry),
        n, rows, flags, kernels.stream_handle(t.device))
    kernels.check_status(rc, f"{field.name} field_scan op {op} n={n} rows={rows}")
    _SCAN.launches += 1


def _scan_tiles(field, op, src, n, rows, flags, total):
    """The scan (or, with `total`, the fold) of n >= 1 elements a row: one
    tile pass when n fits a tile; else the tiles' totals, their own scan
    (or fold), and a pass that runs each tile from its carry. The scan's
    words are (W, rows, n) in number; with SCAN_PAIR laid out (2, W,
    rows / 2, n)."""
    dev = src[0].device
    tiles = -(-n // SCAN_TILE)
    if tiles == 1:
        if total:
            out = torch.empty((field.W, rows), dtype=torch.int32, device=dev)
            _scan_pass(field, op, src, n, rows, flags, totals=out)
        else:
            out = torch.empty((field.W, rows, n), dtype=torch.int32, device=dev)
            _scan_pass(field, op, src, n, rows, flags, out=out)
        return out
    tot = torch.empty((field.W, rows, tiles), dtype=torch.int32, device=dev)
    _scan_pass(field, op, src, n, rows, flags, totals=tot)
    tsrc = (tot, rows * tiles, tiles, 1)
    if total:
        return _scan_tiles(field, op, tsrc, tiles, rows, 0, True)
    carry = _scan_tiles(field, op, tsrc, tiles, rows, 0, False)
    out = torch.empty((field.W, rows, n), dtype=torch.int32, device=dev)
    _scan_pass(field, op, src, n, rows, flags, out=out, carry=carry)
    return out


def field_scan(field, op: int, x: torch.Tensor, reverse: bool = False,
               mode: str = "array", n=None) -> torch.Tensor:
    """Inclusive scan of `op` (ADD or MUL) along the last axis of Montgomery
    words, forward or `reverse`:
      "array":  x (W, *batch, n) -> (W, *batch, n);
      "column": x (W, *batch), repeated n times along a new last axis
                without building it -> (W, *batch, n) (MUL: x^1 .. x^n);
      "total":  x (W, *batch, n) -> (W, *batch), the fold of each row;
      "pair":   x (W, *batch, n) -> (2, W, *batch, n), the exclusive prefix
                and the exclusive suffix fold of each row (identity at the
                ends), in one pass over x (`reverse` is ignored).
    The plain version for CPU tensors; for CUDA tensors the scan kernel, one
    to three launches a call up to 2^20 elements a row."""
    _check_scan_args(op, mode, n)
    if _device_kind(x) == "cpu":
        return field_scan_plain(field, op, x, reverse, mode, n)
    _check_operand(field, x, x.device)
    if mode == "column":
        batch = tuple(x.shape[1:])
        col = x.reshape(field.W, -1).contiguous()  # a column is W x rows words
        rows = col.shape[1]
        src = (col, rows, 1, 0)
        shape = (field.W,) + batch + (n,)
    else:
        if x.dim() < 2:
            raise kernels.KernelError(f"{field.name} field_scan: expected (W, ..., n) words")
        n = x.shape[-1]
        batch = tuple(x.shape[1:-1])
        flat = x.contiguous().reshape(field.W, -1, n)
        rows = flat.shape[1]
        src = (flat, rows * n, n, 1)
        shape = (field.W,) + batch + (() if mode == "total" else (n,))
        if mode == "pair":
            rows, shape = 2 * rows, (2,) + shape
    if rows > 65535:
        raise kernels.KernelError(f"{field.name} field_scan: {rows} rows, at most 65535")
    if rows == 0 or n == 0:
        if mode == "total":
            return _identity(field, op, batch, x.device)
        return torch.empty(shape, dtype=torch.int32, device=x.device)
    flags = (SCAN_PAIR | SCAN_EXCLUSIVE) if mode == "pair" else (SCAN_REVERSE if reverse else 0)
    return _scan_tiles(field, op, src, n, rows, flags, mode == "total").reshape(shape)


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


# ---- K5 as a block transform: whole sub-transforms a launch ---------------------------

_K5B = kernels.REGISTRY["ntt_block"]
NTT_TILE_EXP = 12  # elements a tile, log2 (csrc/ntt_block.cuh kNttTileExp)
NTT_MAX_THREADS = 1024
_SCALE_MODES = {"const": 1, "linear": 2, "product": 3}


@dataclass(frozen=True)
class NttScale:
    """A per-element factor of `ntt_block`'s input (pre) or output (post).
    Tables are element-major (len, 8) int32 Montgomery words on the data's
    device. `kind`: "const" (lo[0]), "linear" (base^e with e = r * bt + c:
    row r, column c of the transform) or "product" (e = r * (c // div)).
    base^e = hi[e >> s] * lo[e & (2^s - 1)], or lo[e] when hi is None."""

    kind: str
    lo: torch.Tensor
    hi: torch.Tensor | None = None
    s: int = 0
    div: int = 1

    def exponents(self, m: int, bt: int, device) -> torch.Tensor:
        """(m, bt) int64 exponents e of rows r < m, columns c < bt."""
        r = torch.arange(m, device=device).reshape(m, 1)
        c = torch.arange(bt, device=device).reshape(1, bt)
        return r * bt + c if self.kind == "linear" else r * (c // self.div)

    def values(self, m: int, bt: int, mul) -> torch.Tensor:
        """(8, m, bt) words of the factor (a (8, 1, 1) column for "const"),
        the split tables joined with `mul`."""
        if self.kind == "const":
            return self.lo[0].reshape(8, 1, 1)
        e = self.exponents(m, bt, self.lo.device)
        if self.hi is None:
            return self.lo[e].permute(2, 0, 1)
        lo = self.lo[e & ((1 << self.s) - 1)].permute(2, 0, 1)
        return mul(self.hi[e >> self.s].permute(2, 0, 1), lo)


def _scaled_plain(x: torch.Tensor, sc: NttScale | None) -> torch.Tensor:
    """x (8, nb, m, bt) times the scale, on the plain twin."""
    if sc is None:
        return x
    fr = _fr()

    def mul(a, b):
        return binary_plain(fr, MUL, a, b)

    return mul(x, sc.values(x.shape[2], x.shape[3], mul).unsqueeze(1))


def _out_layout(x: torch.Tensor, out_bt: int) -> torch.Tensor:
    """(8, nb, m, bt) -> (8, nb * bt / out_bt, m, out_bt): the same columns
    q = b * bt + c, each of its m rows, with another column stride."""
    W, nb, m, bt = x.shape
    if out_bt == bt:
        return x
    cols = x.permute(0, 1, 3, 2).reshape(W, nb * bt // out_bt, out_bt, m)
    return cols.permute(0, 1, 3, 2).contiguous()


def ntt_block_plain(x: torch.Tensor, tw: torch.Tensor, pre: NttScale | None = None,
                    post: NttScale | None = None, out_bt: int | None = None) -> torch.Tensor:
    """Plain twin of `ntt_block` on any device: every column of x
    (8, nb, m, bt) times `pre`, transformed along axis 2 by the DIF stages
    of the stage table tw ((m, 8): tw[h + j] = omega_m^(j m / 2h)), in
    natural order, laid out with column stride out_bt (default bt), times
    `post`. The forward NTT for the powers of omega, the inverse one
    without its 1/m for those of omega^-1."""
    fr = _fr()
    W, nb, m, bt = x.shape
    x = _scaled_plain(x, pre)
    tws = tw.t()
    h = m // 2
    while h >= 1:
        xs = x.reshape(W, nb, m // (2 * h), 2, h, bt)
        a, b = xs[:, :, :, 0], xs[:, :, :, 1]
        w = tws[:, h:2 * h].reshape(W, 1, 1, h, 1)
        u = binary_plain(fr, ADD, a, b)
        v = binary_plain(fr, MUL, binary_plain(fr, SUB, a, b), w)
        x = torch.stack([u, v], dim=3).reshape(W, nb, m, bt)
        h //= 2
    rev = torch.from_numpy(bitrev_perm(m.bit_length() - 1)).to(x.device)
    x = torch.index_select(x, 2, rev)
    return _scaled_plain(_out_layout(x, out_bt or bt), post)


def bitrev_perm(log_n: int) -> np.ndarray:
    """The bit-reversal permutation of 2^log_n indices."""
    idx = np.arange(1 << log_n)
    rev = np.zeros_like(idx)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


def ntt_block_cols(log_m: int, ncol: int, sms: int) -> int:
    """Columns a tile: two tiles an SM where the columns allow it, at least
    256 elements a tile, at most 2^NTT_TILE_EXP and no more columns than
    there are (the fastest tiles of `bench.ntt`'s sweep at 2^15 and 2^20,
    H100)."""
    per = max(1, ncol // (2 * sms)).bit_length() - 1
    floor = max(0, 8 - log_m)
    return 1 << min(max(per, floor), NTT_TILE_EXP - log_m, (ncol - 1).bit_length())


def ntt_block_threads(log_m: int, cols: int, blocks: int, sms: int) -> int:
    """Threads a block: one a butterfly of the tile up to 256, or up to
    NTT_MAX_THREADS where the blocks do not fill the SMs (a single 2^12
    transform), a multiple of 32 (`bench.ntt`'s sweep, H100)."""
    top = NTT_MAX_THREADS if blocks < sms else 256
    return min(top, max(32, -(-((cols << log_m) // 2) // 32) * 32))


def _scale_args(sc: NttScale | None, device):
    if sc is None:
        return (None, None, 0, 0, 1)
    if sc.kind not in _SCALE_MODES:
        raise kernels.KernelError(f"ntt_block: scale kind {sc.kind!r}")
    for t in (sc.lo,) if sc.hi is None else (sc.lo, sc.hi):
        if (t.dtype != torch.int32 or t.device != device or t.dim() != 2 or t.shape[1] != 8
                or not t.is_contiguous()):
            raise kernels.KernelError(
                f"ntt_block: scale tables must be contiguous int32 (len, 8) on {device}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")
    return (None if sc.hi is None else sc.hi.data_ptr(), sc.lo.data_ptr(),
            _SCALE_MODES[sc.kind], sc.s, sc.div)


def ntt_block(x: torch.Tensor, tw: torch.Tensor, pre: NttScale | None = None,
              post: NttScale | None = None, out_bt: int | None = None,
              cols: int | None = None, threads: int | None = None,
              entry=None) -> torch.Tensor:
    """K5 as a block transform (see `ntt_block_plain`): one launch
    transforms every column of x (8, nb, m, bt), m = 2^e <= 2^NTT_TILE_EXP,
    with the pre and post scales and the output's column stride out_bt.
    The plain twin for CPU tensors, the CUDA kernel for CUDA tensors.
    `cols` (a power of two) overrides the columns a tile
    (`ntt_block_cols`) and `threads` the threads a block (a multiple of 32
    up to NTT_MAX_THREADS; `ntt_block_threads`) and `entry` (a C function
    of `kzg_ntt_block`'s signature) the library's: the bench's sweep.
    Returns a new (8, nb * bt / out_bt, m, out_bt) tensor."""
    if x.dim() != 4 or tw.dim() != 2:
        raise kernels.KernelError(
            f"ntt_block: x must be (8, nb, m, bt) and tw (m, 8), got {tuple(x.shape)} and "
            f"{tuple(tw.shape)}")
    W, nb, m, bt = x.shape
    out_bt = out_bt or bt
    log_m = m.bit_length() - 1
    ncol = nb * bt
    if (m < 2 or m != 1 << log_m or log_m > NTT_TILE_EXP or tuple(tw.shape) != (m, 8)
            or ncol % out_bt):
        raise kernels.KernelError(
            f"ntt_block: m a power of two in [2, 2^{NTT_TILE_EXP}], tw (m, 8), out_bt | nb bt; "
            f"got x {tuple(x.shape)}, tw {tuple(tw.shape)}, out_bt {out_bt}")
    if _device_kind(x) == "cpu":
        return ntt_block_plain(x, tw, pre, post, out_bt)
    fr = _fr()
    _check_operand(fr, x, x.device)
    if tw.dtype != torch.int32 or tw.device != x.device:
        raise kernels.KernelError(f"ntt_block: tw must be int32 on {x.device}")
    x = x.contiguous()
    tw = tw.contiguous()
    out = torch.empty((W, ncol // out_bt, m, out_bt), dtype=torch.int32, device=x.device)
    if ncol == 0:
        return out
    index = x.device.index if x.device.index is not None else torch.cuda.current_device()
    sms = kernels.sm_count(index)
    cols = cols or ntt_block_cols(log_m, ncol, sms)
    log_cols = cols.bit_length() - 1
    if cols != 1 << log_cols or log_m + log_cols > NTT_TILE_EXP:
        raise kernels.KernelError(f"ntt_block: {cols} columns of 2^{log_m} exceed a tile")
    threads = threads or ntt_block_threads(log_m, cols, -(-ncol // cols), sms)
    rc = (entry or kernels.library().kzg_ntt_block)(
        out.data_ptr(), x.data_ptr(), tw.data_ptr(), ncol, log_m, bt, out_bt, log_cols, threads,
        *_scale_args(pre, x.device), *_scale_args(post, x.device),
        kernels.stream_handle(x.device))
    kernels.check_status(rc, f"ntt_block {tuple(x.shape)} out_bt={out_bt} cols={cols}")
    _K5B.launches += 1
    return out
