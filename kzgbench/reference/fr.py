"""Exact arithmetic modulo r over whole arrays, in plain PyTorch, for the
reference: polynomial evaluation at a few points and the Montgomery
decoding of coefficient words, on whichever device holds the words.

Numbers are split into 16-bit limbs. Every product of two limbs is below
2^32, and every sum the matrix products below form has at most 2^12 of
them (below 2^44), so float64 matrix products are exact: each partial sum
is an integer below 2^53, whatever order the library adds in. Carries are
propagated in int64.

Words follow the program's input layout: an (8, n) int32 array, word j of
element i at [j, i], least significant word first.
"""

import torch

from .bls import R

LIMBS = 16                   # 16-bit limbs of a 256-bit number
MONT_INV = pow(1 << 256, -1, R)  # the inverse of the Montgomery factor 2^256
_NPRIME = (-pow(R, -1, 1 << 256)) % (1 << 256)
_CHUNK = 1 << 20             # elements a pass, to bound the float64 temporaries


def int_limbs(v: int, count: int = LIMBS):
    return [(v >> (16 * k)) & 0xFFFF for k in range(count)]


def limbs_of_words(words: torch.Tensor) -> torch.Tensor:
    """(8, n) int32 words -> (n, 16) int64 limbs, least significant first."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([w & 0xFFFF, w >> 16], dim=1).reshape(2 * words.shape[0], -1).T.contiguous()


def _carry(cols: torch.Tensor, out_limbs: int) -> torch.Tensor:
    """Column sums (m, c) int64, each below 2^62, -> (m, out_limbs) 16-bit
    limbs of the same number. The number must fit in out_limbs limbs."""
    m, c = cols.shape
    out = torch.empty((m, out_limbs), dtype=torch.int64, device=cols.device)
    carry = torch.zeros(m, dtype=torch.int64, device=cols.device)
    for k in range(out_limbs):
        v = carry + cols[:, k] if k < c else carry
        out[:, k] = v & 0xFFFF
        carry = v >> 16
    if bool((carry != 0).any()):
        raise ValueError("limb carry overflow")
    return out


def _const_product(a: torch.Tensor, const: int, out_cols: int) -> torch.Tensor:
    """Column sums (m, out_cols) of the products a * const, from limbs a
    (m, 16) and a constant below 2^256; columns at or above out_cols are
    dropped (a product modulo 2^(16 out_cols))."""
    cl = int_limbs(const)
    t = torch.zeros((LIMBS, out_cols), dtype=torch.float64, device=a.device)
    for i in range(LIMBS):
        for j in range(LIMBS):
            if i + j < out_cols:
                t[i, i + j] = cl[j]
    return (a.to(torch.float64) @ t).to(torch.int64)


def _sub_r_if_above(a: torch.Tensor) -> torch.Tensor:
    """a (m, 17) limbs below 2r -> a mod r as (m, 16) limbs."""
    rl = torch.tensor(int_limbs(R, 17), dtype=torch.int64, device=a.device)
    diff = torch.empty_like(a)
    borrow = torch.zeros(a.shape[0], dtype=torch.int64, device=a.device)
    for k in range(a.shape[1]):
        v = a[:, k] - rl[k] - borrow
        borrow = (v < 0).to(torch.int64)
        diff[:, k] = v + (borrow << 16)
    keep = (borrow != 0)[:, None]  # a < r: keep a
    return torch.where(keep, a, diff)[:, :LIMBS]


def from_mont(limbs: torch.Tensor) -> torch.Tensor:
    """Montgomery reduction a 2^-256 mod r of (m, 16) limbs, each number
    below r: m = a (-1/r) mod 2^256, then (a + m r) / 2^256, then one
    conditional subtraction. Returns (m, 16) limbs below r."""
    out = []
    for lo in range(0, limbs.shape[0], _CHUNK):
        a = limbs[lo:lo + _CHUNK]
        m = _carry(_const_product(a, _NPRIME, LIMBS), LIMBS + 3)[:, :LIMBS]
        cols = _const_product(m, R, 2 * LIMBS - 1)
        cols[:, :LIMBS] += a
        t = _carry(cols, 2 * LIMBS + 1)
        out.append(_sub_r_if_above(t[:, LIMBS:]))
    return torch.cat(out) if out else limbs[:, :LIMBS]


def limbs_to_ints(limbs: torch.Tensor) -> list:
    """(m, k) 16-bit limbs -> Python ints (for tests and small samples)."""
    rows = limbs.cpu().tolist()
    return [sum(v << (16 * k) for k, v in enumerate(row)) for row in rows]


def ints_to_limbs(values, device) -> torch.Tensor:
    """Python ints below 2^256 -> (m, 16) int64 limbs."""
    buf = b"".join(v.to_bytes(32, "little") for v in values)
    return torch.frombuffer(bytearray(buf), dtype=torch.int16).to(
        device=device, dtype=torch.int64).reshape(-1, LIMBS) & 0xFFFF


def _power_limbs(xs, count: int, stride: int, device) -> torch.Tensor:
    """(count, 16, P) float64 limbs of x^(stride k) mod r, k < count, for
    each point x of xs."""
    cols = []
    for x in xs:
        step = pow(x, stride, R)
        v, col = 1, []
        for _ in range(count):
            col.append(v)
            v = v * step % R
        cols.append(ints_to_limbs(col, device))
    return torch.stack(cols, dim=-1).to(torch.float64)


def _coefficient_limbs(words: torch.Tensor, lo: int, hi: int, mont: bool, keep_bits):
    """Limbs (hi - lo, 16) of coefficients lo..hi-1 and whether they still
    carry the Montgomery factor: decoded first where keep_bits asks for the
    low bits of the values themselves."""
    limbs = limbs_of_words(words[:, lo:hi])
    if keep_bits is None:
        return limbs, mont
    if mont:
        limbs = from_mont(limbs)
    mask = torch.tensor([min(0xFFFF, (1 << max(0, keep_bits - 16 * k)) - 1)
                         for k in range(LIMBS)], dtype=torch.int64, device=limbs.device)
    return limbs & mask, False


def evaluate(words: torch.Tensor, xs, mont: bool = True, keep_bits: int | None = None) -> list:
    """sum_i a_i x^i mod r at every point x of xs, for coefficients given
    as (8, n) words: a_i is the word value times 2^-256 when mont (the
    program's Montgomery words), the value itself otherwise. keep_bits
    keeps only the low bits of each a_i (the control's narrow scalars).

    Blocked as sum_j x^(K j) S_j with S_j = sum_k a_(K j + k) x^k, K a power
    of two near sqrt(n): S_j exactly by one float64 matrix product over the
    limb pairs, its columns carried into limbs, then the outer sum by a
    second product, and the last few hundred column sums on the host."""
    n = words.shape[-1]
    dev = words.device
    xs = [x % R for x in xs]
    npts = len(xs)
    k_len = 1 << ((max(n, 2) - 1).bit_length() + 1) // 2
    j_len = -(-n // k_len)
    b = _power_limbs(xs, k_len, 1, dev).reshape(k_len, LIMBS * npts)
    a = _power_limbs(xs, j_len, k_len, dev)  # (J, 16, P)
    total = torch.zeros((npts, LIMBS, 2 * LIMBS + 1), dtype=torch.int64, device=dev)
    rows = max(1, _CHUNK // k_len)
    scale = mont
    for j0 in range(0, j_len, rows):
        j1 = min(j_len, j0 + rows)
        blk, scale = _coefficient_limbs(words, j0 * k_len, j1 * k_len, mont, keep_bits)
        if blk.shape[0] < (j1 - j0) * k_len:
            blk = torch.cat([blk, blk.new_zeros(((j1 - j0) * k_len - blk.shape[0], LIMBS))])
        w = blk.reshape(j1 - j0, k_len, LIMBS).permute(0, 2, 1).to(torch.float64)
        m = (w.reshape(-1, k_len) @ b).reshape(j1 - j0, LIMBS, LIMBS, npts).to(torch.int64)
        cols = torch.zeros((j1 - j0, 2 * LIMBS - 1, npts), dtype=torch.int64, device=dev)
        for i in range(LIMBS):
            cols[:, i:i + LIMBS] += m[:, i]
        s = _carry(cols.permute(0, 2, 1).reshape(-1, 2 * LIMBS - 1), 2 * LIMBS + 1)
        s = s.reshape(j1 - j0, npts, 2 * LIMBS + 1).permute(1, 0, 2).to(torch.float64)
        aj = a[j0:j1].permute(2, 1, 0)  # (P, 16, J)
        total += torch.bmm(aj, s).to(torch.int64)
    out = []
    for g in total.cpu().tolist():
        v = sum(c << (16 * (i + k)) for i, row in enumerate(g) for k, c in enumerate(row)) % R
        out.append(v * MONT_INV % R if scale else v)
    return out
