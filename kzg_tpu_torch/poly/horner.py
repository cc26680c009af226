"""Kernel `fr_horner`: the linear division f / (X - x) and the evaluation
f(x) by Horner's rule, and its plain twin.

Replaces the K1 chain of `kzg_tpu/poly/polynomial.py:122-145`
(`_div_by_linear`: three log-depth scans, an inverse and the products
around them, one whole-array K1 launch each) and, in its remainder-only
mode, `_eval_many` (`:94-118`), for f (8, n) and k points x (8, k):

    h_n = carry (0 when none),  h_j = f_j + x h_{j+1},
    q_j = h_{j+1} (0 <= j < n - 1),  rem = h_0 = f(x) + x^n carry.

The carry in and the carry out (rem) let a division run one chunk of
coefficients a call, high to low: a chunk's quotient is q here with the
carry in as its top entry, and its carry out is rem
(`poly.polynomial._div_stream_chunk`, the streamed division of
`kzg_tpu/poly/polynomial.py:217-228`).

CUDA side (`csrc/scan.cuh`, `horner_kernel`): tiles of 1024 coefficients,
each thread's run of 4 folded with carry 0, the carries scanned across the
warp by shuffles (S = S_low + x^(4 d) S_high) and down the block's warps,
then each run re-run from its true carry. A call is one tile pass up to
1023 coefficients, three (two for the remainder alone) up to 2^20: the
tiles' values with carry 0, the division of those values by
(Y - x^1024) for the carries into the tiles (the same kernel, recursively),
and a pass that runs every tile from its carry. Bound: f read and q written
once, 2 products and 2 adds a coefficient a point. Every value is the
canonical residue, so the words equal the reference's, also at x = 0
(h_j = f_j: the reference's coefficient shift).

Plain twin (`fr_horner_plain`): the reference's formulation over the plain
field (the suffix-sum division; the chunked power method for the
remainder alone). `fr_horner_chain` is the same formulation with every
field operation a K1 launch and every scan the doubling rounds of K1
launches: the chain the kernel replaced, kept for the smoke's timing.
"""

import torch

from .. import kernels
from ..fields import FR, cuda_field
from ..fields.cuda_field import ADD, MUL, SCAN_TILE

_HORNER = kernels.REGISTRY["fr_horner"]
_FR_PLAIN = FR.as_plain()
EVAL_CHUNK = 4096  # the power method's table width (kzg_tpu/poly/polynomial.py:104)


def _with_carry(f: torch.Tensor, carry, k: int) -> torch.Tensor:
    """f (8, n) -> (8, 1 or k, n), the carry appended at position n."""
    f = f[:, None, :]
    if carry is not None:
        f = torch.cat([f.expand(FR.W, k, f.shape[-1]), carry[..., None]], dim=-1)
    return f


def division_formula(F, scan, f, x, carry=None):
    """(q (8, k, n - 1), rem (8, k)) by the reference's suffix sums:
    q_j = x^-(j+1) sum_{i > j} f_i x^i, rem = sum f_i x^i; the x == 0
    column takes the coefficient shift. F: the field of the products,
    scan: a `field_scan` (plain, chain or kernel)."""
    n0 = f.shape[-1]
    k = x.shape[-1]
    f = _with_carry(f, carry, k)
    n = f.shape[-1]
    pw = scan(F, MUL, x, mode="column", n=n)  # x^1 .. x^n
    powx = torch.cat([F.one((k, 1), x.device), pw[..., : n - 1]], dim=-1)
    s = scan(F, ADD, F.mul(f, powx), reverse=True)  # inclusive suffix sums
    rem = s[..., 0]
    pwinv = scan(F, MUL, F.inv(x), mode="column", n=n - 1)  # inv(0) = 0
    q = F.mul(s[..., 1:], pwinv)
    q = torch.where(F.is_zero(x)[None, :, None], f[..., 1:].expand_as(q), q)
    return q[..., : n0 - 1], rem


def evaluation_formula(F, scan, f, x, carry=None):
    """f(x) + x^n carry at (8, k) points by the reference's chunked power
    method: inner products against a power table of width
    min(EVAL_CHUNK, n), Horner in x^c over the chunks, high to low."""
    k = x.shape[-1]
    f = _with_carry(f, carry, k)
    n = f.shape[-1]
    c = min(EVAL_CHUNK, n)
    npad = -(-n // c) * c
    f = torch.nn.functional.pad(f, (0, npad - n))
    pw = scan(F, MUL, x, mode="column", n=c)  # x^1 .. x^c
    powers = torch.cat([F.one((k, 1), x.device), pw[..., : c - 1]], dim=-1)
    x_c = pw[..., c - 1]
    acc = torch.zeros((F.W, k), dtype=torch.int32, device=x.device)
    for j in range(npad // c - 1, -1, -1):
        inner = scan(F, ADD, F.mul(f[..., j * c:(j + 1) * c], powers), mode="total")
        acc = F.add(F.mul(acc, x_c), inner)
    return acc


def _formulas(F, scan, f, x, carry, rem_only):
    if rem_only:
        return None, evaluation_formula(F, scan, f, x, carry)
    return division_formula(F, scan, f, x, carry)


def fr_horner_plain(f, x, carry=None, rem_only=False):
    """Plain twin of `fr_horner` on any device."""
    return _formulas(_FR_PLAIN, cuda_field.field_scan_plain, f, x, carry, rem_only)


def fr_horner_chain(f, x, carry=None, rem_only=False):
    """The formulation with every operation a K1 launch (the scans as
    doubling rounds): the chain `fr_horner` replaced."""
    return _formulas(FR, cuda_field.field_scan_chain, f, x, carry, rem_only)


def _horner_pass(f, fws, frs, x, cin, n, k, q=None, rem=None, totals=None, xpow=None,
                 tile_carry=None):
    ptr = lambda v: None if v is None else v.data_ptr()  # noqa: E731
    rc = kernels.library().kzg_fr_horner(
        ptr(q), ptr(rem), ptr(totals), ptr(xpow), f.data_ptr(), fws, frs, x.data_ptr(),
        ptr(cin), ptr(tile_carry), n, k, kernels.stream_handle(x.device))
    kernels.check_status(rc, f"fr_horner n={n} k={k}")
    _HORNER.launches += 1


def _horner_tiles(f, fws, frs, x, cin, n, k, rem_only):
    """One tile pass when the coefficients (and the carry in) fit a tile;
    else the tiles' values, their division by (Y - x^SCAN_TILE) for the
    carries into the tiles, and a pass from those carries."""
    dev = x.device
    tiles = -(-(n + (cin is not None)) // SCAN_TILE)
    rem = torch.empty((FR.W, k), dtype=torch.int32, device=dev)
    if tiles == 1:
        if rem_only:
            _horner_pass(f, fws, frs, x, cin, n, k, totals=rem)
            return None, rem
        q = torch.empty((FR.W, k, n - 1), dtype=torch.int32, device=dev)
        _horner_pass(f, fws, frs, x, cin, n, k, q=q, rem=rem)
        return q, rem
    tot = torch.empty((FR.W, k, tiles), dtype=torch.int32, device=dev)
    y = torch.empty((FR.W, k), dtype=torch.int32, device=dev)
    _horner_pass(f, fws, frs, x, cin, n, k, totals=tot, xpow=y)
    tile_q, rem = _horner_tiles(tot, k * tiles, tiles, y, None, tiles, k, rem_only)
    if rem_only:
        return None, rem
    q = torch.empty((FR.W, k, n - 1), dtype=torch.int32, device=dev)
    _horner_pass(f, fws, frs, x, cin, n, k, q=q, tile_carry=tile_q)
    return q, rem


def _check(name, t, shape):
    if t.dtype != torch.int32:
        raise kernels.KernelError(f"fr_horner: {name} must be int32 words, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise kernels.KernelError(f"fr_horner: {name} must be {tuple(shape)}, got "
                                  f"{tuple(t.shape)}")


MAX_POINTS = 65535  # points a launch: the grid's second axis


def fr_horner(f: torch.Tensor, x: torch.Tensor, carry=None, rem_only: bool = False):
    """f / (X - x) for f (8, n) Montgomery Fr words and k points x (8, k),
    with an optional carry in (8, k) above f's top coefficient. Returns
    (q (8, k, n - 1), rem (8, k)), or (None, rem) with `rem_only`. The
    plain twin for CPU tensors; for CUDA tensors the Horner kernel, one to
    three launches up to 2^20 coefficients and MAX_POINTS points."""
    if x.dim() != 2 or f.dim() != 2 or f.shape[-1] < 1:
        raise kernels.KernelError(f"fr_horner: f (8, n >= 1) and x (8, k), got "
                                  f"{tuple(f.shape)} and {tuple(x.shape)}")
    k, n = x.shape[-1], f.shape[-1]
    for name, t in (("f", f), ("carry", carry)):
        if t is not None and t.device != x.device:
            raise kernels.KernelError(f"fr_horner: {name} on {t.device}, x on {x.device}")
    if cuda_field._device_kind(x) == "cpu":
        return fr_horner_plain(f, x, carry, rem_only)
    _check("x", x, (FR.W, k))
    _check("f", f, (FR.W, n))
    if carry is not None:
        _check("carry", carry, (FR.W, k))
    if not 1 <= k <= MAX_POINTS:
        parts = [fr_horner(f, x[:, i:i + MAX_POINTS],
                           None if carry is None else carry[:, i:i + MAX_POINTS], rem_only)
                 for i in range(0, k, MAX_POINTS)]
        rem = torch.cat([x[:, :0]] + [r for _, r in parts], dim=1)
        if rem_only:
            return None, rem
        q0 = torch.empty((FR.W, 0, n - 1), dtype=torch.int32, device=x.device)
        return torch.cat([q0] + [q for q, _ in parts], dim=1), rem
    x = x.contiguous()
    f = f.contiguous()
    carry = None if carry is None else carry.contiguous()
    return _horner_tiles(f, n, 0, x, carry, n, k, rem_only)
