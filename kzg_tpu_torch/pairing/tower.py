"""The Fp2 / Fp6 / Fp12 tower over the port's Fp (port of
`kzg_tpu/pairing/tower.py`):

    Fp2  = Fp[u]  / (u^2 + 1)
    Fp6  = Fp2[v] / (v^3 - xi),  xi = u + 1
    Fp12 = Fp6[w] / (w^2 - v)

Layout, as the reference's (L, k, *batch): an Fp12 element is one
(12, 12, *batch) int32 tensor of Montgomery Fp words, the second axis
[c0.c0.a, c0.c0.b, c0.c1.a, c0.c1.b, c0.c2.a, c0.c2.b, c1.c0.a, ...], i.e.
index 2 (3 i + j) + k holds the w^i v^j u^k coefficient; Fp6 is
(12, 6, *batch) and Fp2 (12, 2, *batch).

Every Fp operation is kernel K1 on a CUDA tensor (its plain twin on a CPU
tensor), and every inverse one `field_pow` launch (`FP.inv`). Within each
tower level the independent products are stacked along a batch axis and
go through ONE K1 launch: a level's components are viewed as a batch of
the level below (`_f2_batch`, `_f6_batch`), so `f12_mul` is one Karatsuba
`f6_mul` over three Fp6 pairs, which is one `f2_mul` over eighteen Fp2
pairs, which is one K1 product of 54 Fp pairs. The values are canonical
residues, so the words equal the reference's whatever the order of the
products.

Frobenius constants are derived from Python ints at import (no magic
constants), cached on each device at first use.
"""

import torch

from ..config import resolve_device
from ..constants import P
from ..fields import FP

_W = FP.W

# ---------------------------------------------------------------------------
# batch views: a level's components as a batch of the level below
# ---------------------------------------------------------------------------


def _f2_batch(x, k: int):
    """(12, 2k, *b) -> (12, 2, k, *b): the k Fp2 components as a batch (a
    view where the layout allows)."""
    return x.reshape((_W, k, 2) + x.shape[2:]).transpose(1, 2)


def _f2_unbatch(x):
    """(12, 2, k, *b) -> (12, 2k, *b), the inverse of `_f2_batch`."""
    return x.transpose(1, 2).reshape((_W, 2 * x.shape[2]) + x.shape[3:])


def _f6_batch(x):
    """(12, 12, *b) -> (12, 6, 2, *b): c0 and c1 as a batch of Fp6."""
    return x.reshape((_W, 2, 6) + x.shape[2:]).transpose(1, 2)


def _stack(parts, dim: int = 2):
    return torch.stack(parts, dim=dim)


# ---------------------------------------------------------------------------
# Fp2: (12, 2, *batch), u^2 = -1
# ---------------------------------------------------------------------------


def f2_mul(x, y):
    """Karatsuba: ac - bd, (a + b)(c + d) - ac - bd; the three products in
    one K1 launch, four launches in all."""
    x, y = torch.broadcast_tensors(x, y)
    s = FP.add(_stack([x[:, 0], y[:, 0]], 1), _stack([x[:, 1], y[:, 1]], 1))  # a+b, c+d
    pr = FP.mul(torch.cat([x, s[:, :1]], 1), torch.cat([y, s[:, 1:]], 1))  # ac, bd, t
    d = FP.sub(_stack([pr[:, 0], pr[:, 2]], 1), _stack([pr[:, 1], pr[:, 0]], 1))
    return _stack([d[:, 0], FP.sub(d[:, 1], pr[:, 1])], 1)


def f2_sqr(x):
    """(a + b)(a - b), 2ab: both products in one K1 launch."""
    a, b = x[:, 0], x[:, 1]
    pr = FP.mul(_stack([FP.add(a, b), a], 1), _stack([FP.sub(a, b), b], 1))
    return _stack([pr[:, 0], FP.add(pr[:, 1], pr[:, 1])], 1)


def f2_conj(x):
    return _stack([x[:, 0], FP.neg(x[:, 1])], 1)


def f2_mul_xi(x):
    """Multiply by xi = 1 + u: (a + bu)(1 + u) = (a - b) + (a + b)u."""
    a, b = x[:, 0], x[:, 1]
    return _stack([FP.sub(a, b), FP.add(a, b)], 1)


def f2_inv(x):
    """(a - bu) / (a^2 + b^2): one `field_pow` for the norm's inverse."""
    sq = FP.mul(x, x)  # a^2, b^2
    ninv = FP.inv(FP.add(sq[:, 0], sq[:, 1]))
    pr = FP.mul(x, ninv[:, None])
    return _stack([pr[:, 0], FP.neg(pr[:, 1])], 1)


def f2_zero(batch=(), device=None):
    return FP.zeros((2,) + tuple(batch), device)


def f2_one(batch=(), device=None):
    return _stack([FP.one(batch, device), FP.zeros(batch, device)], 1)


def f2_encode(c0: int, c1: int, device=None):
    """Host ints c0 + c1 u -> a (12, 2) Montgomery constant on `device`."""
    return torch.from_numpy(FP.encode([c0, c1])).to(resolve_device(device))


# ---------------------------------------------------------------------------
# Fp6: (12, 6, *batch) = 3 x Fp2, v^3 = xi
# ---------------------------------------------------------------------------


def _c6(x, i):
    return x[:, 2 * i: 2 * i + 2]


def _pack6(c0, c1, c2):
    return torch.cat([c0, c1, c2], dim=1)


def f6_mul(x, y):
    """Karatsuba over Fp2 (the reference's formulas): t_i = a_i b_i and the
    three cross products (a1 + a2)(b1 + b2), (a0 + a1)(b0 + b1),
    (a0 + a2)(b0 + b2) as ONE `f2_mul` over six stacked pairs."""
    x, y = torch.broadcast_tensors(x, y)
    a, b = _f2_batch(x, 3), _f2_batch(y, 3)  # (12, 2, 3, *b)
    lo, hi = [1, 0, 0], [2, 1, 2]
    s = FP.add(torch.cat([a[:, :, lo], b[:, :, lo]], 2), torch.cat([a[:, :, hi], b[:, :, hi]], 2))
    pr = f2_mul(torch.cat([a, s[:, :, :3]], 2), torch.cat([b, s[:, :, 3:]], 2))
    t0, t1, t2 = pr[:, :, 0], pr[:, :, 1], pr[:, :, 2]
    u = FP.sub(pr[:, :, 3:], _stack([t1, t0, t0]))
    u = FP.sub(u, _stack([t2, t1, t2]))  # m12 - t1 - t2, m01 - t0 - t1, m02 - t0 - t2
    xi = f2_mul_xi(_stack([u[:, :, 0], t2]))
    c = FP.add(_stack([t0, u[:, :, 1], u[:, :, 2]]), _stack([xi[:, :, 0], xi[:, :, 1], t1]))
    return _f2_unbatch(c)


def f6_sqr(x):
    return f6_mul(x, x)


def f6_mul_v(x):
    """(c0 + c1 v + c2 v^2) * v = c2 xi + c0 v + c1 v^2."""
    return _pack6(f2_mul_xi(_c6(x, 2)), _c6(x, 0), _c6(x, 1))


def f6_inv(x):
    """The reference's formula; its six independent products in one
    `f2_mul`, the three of the norm in a second, one `f2_inv`."""
    a = _f2_batch(x, 3)  # a, b, c
    pr = f2_mul(a[:, :, [0, 1, 2, 0, 1, 0]], a[:, :, [0, 2, 2, 1, 1, 2]])  # a2 bc c2 ab b2 ac
    xi = f2_mul_xi(pr[:, :, [1, 2]])  # xi bc, xi c^2
    t = FP.sub(_stack([pr[:, :, 0], xi[:, :, 1], pr[:, :, 4]]),
               _stack([xi[:, :, 0], pr[:, :, 3], pr[:, :, 5]]))  # t0, t1, t2
    n = f2_mul(a[:, :, [0, 2, 1]], t)  # a t0, c t1, b t2
    denom = FP.add(n[:, :, 0], f2_mul_xi(FP.add(n[:, :, 1], n[:, :, 2])))
    return _f2_unbatch(f2_mul(t, f2_inv(denom).unsqueeze(2)))


def f6_zero(batch=(), device=None):
    return FP.zeros((6,) + tuple(batch), device)


def f6_one(batch=(), device=None):
    return _pack6(f2_one(batch, device), f2_zero(batch, device), f2_zero(batch, device))


# ---------------------------------------------------------------------------
# Fp12: (12, 12, *batch) = 2 x Fp6, w^2 = v
# ---------------------------------------------------------------------------


def _c12(x, i):
    return x[:, 6 * i: 6 * i + 6]


def _pack12(c0, c1):
    return torch.cat([c0, c1], dim=1)


def f12_mul(x, y):
    """Karatsuba over Fp6: a0 b0, a1 b1 and (a0 + a1)(b0 + b1) as ONE
    `f6_mul` over three stacked pairs (54 Fp products in one K1 launch)."""
    x, y = torch.broadcast_tensors(x, y)
    a, b = _f6_batch(x), _f6_batch(y)  # (12, 6, 2, *b)
    s = FP.add(_stack([a[:, :, 0], b[:, :, 0]]), _stack([a[:, :, 1], b[:, :, 1]]))
    pr = f6_mul(torch.cat([a, s[:, :, :1]], 2), torch.cat([b, s[:, :, 1:]], 2))
    t0, t1 = pr[:, :, 0], pr[:, :, 1]
    c0 = FP.add(t0, f6_mul_v(t1))
    c1 = FP.sub(FP.sub(pr[:, :, 2], t0), t1)
    return _pack12(c0, c1)


def f12_sqr(x):
    """Complex squaring, (a0 + a1 w)^2 with w^2 = v: t = a0 a1 and
    (a0 + a1)(a0 + v a1) as one `f6_mul` over two stacked pairs."""
    a0, a1 = _c12(x, 0), _c12(x, 1)
    s = FP.add(_stack([a0, a0]), _stack([a1, f6_mul_v(a1)]))
    pr = f6_mul(_stack([a0, s[:, :, 0]]), _stack([a1, s[:, :, 1]]))
    t = pr[:, :, 0]
    c0 = FP.sub(pr[:, :, 1], FP.add(t, f6_mul_v(t)))
    return _pack12(c0, FP.add(t, t))


def f12_conj(x):
    """x^(p^6): negate the odd part."""
    return _pack12(_c12(x, 0), FP.neg(_c12(x, 1)))


def f12_inv(x):
    """1 / (a0 + a1 w) = (a0 - a1 w) / (a0^2 - v a1^2): the two squares in
    one `f6_mul`, one `f6_inv`, both products by it in one `f6_mul`."""
    a = _f6_batch(x)
    sq = f6_mul(a, a)
    dinv = f6_inv(FP.sub(sq[:, :, 0], f6_mul_v(sq[:, :, 1])))
    pr = f6_mul(a, dinv.unsqueeze(2))
    return _pack12(pr[:, :, 0], FP.neg(pr[:, :, 1]))


def f12_zero(batch=(), device=None):
    return FP.zeros((12,) + tuple(batch), device)


def f12_one(batch=(), device=None):
    return _pack12(f6_one(batch, device), f6_zero(batch, device))


def f12_is_one(x):
    """Batch-shaped bool: x == 1."""
    return (x == f12_one(tuple(x.shape[2:]), x.device)).all(dim=0).all(dim=0)


def f12_eq(x, y):
    return (x == y).all(dim=0).all(dim=0)


def f12_select(cond, x, y):
    return torch.where(cond[None, None], x, y)


# ---- Frobenius ------------------------------------------------------------
# gamma constants: xi^((p - 1) k / 6), derived from Python ints (as
# oracle/field.py's _xi_pow)


def _xi_pow_int(num: int, den: int):
    """(a, b) ints with (1 + u)^((p - 1) num / den) = a + b u."""
    e = (P - 1) * num // den
    a, b = 1, 0
    ba, bb = 1, 1  # base = 1 + u
    while e:
        if e & 1:
            a, b = (a * ba - b * bb) % P, (a * bb + b * ba) % P
        ba, bb = (ba * ba - bb * bb) % P, (2 * ba * bb) % P
        e >>= 1
    return a, b


def _f2_mul_int(x, y):
    return (x[0] * y[0] - x[1] * y[1]) % P, (x[0] * y[1] + x[1] * y[0]) % P


_G6_1 = _xi_pow_int(1, 3)  # Fp6 frobenius, c1
_G6_2 = _xi_pow_int(2, 3)  # Fp6 frobenius, c2
_G12_1 = _xi_pow_int(1, 6)  # Fp12 frobenius, odd part
# the factor of each Fp2 component of an Fp12 element after its conjugate,
# components 1 .. 5 (component 0 takes none)
_FROB12 = (_G6_1, _G6_2, _G12_1, _f2_mul_int(_G6_1, _G12_1), _f2_mul_int(_G6_2, _G12_1))
_FROB_DEV = {}


def _frob_consts(device, which):
    """(12, 2, k) constants on `device`: "f6" = (g1, g2), "f12" = _FROB12."""
    key = (str(device), which)
    if key not in _FROB_DEV:
        consts = (_G6_1, _G6_2) if which == "f6" else _FROB12
        _FROB_DEV[key] = _stack([f2_encode(*c, device=device) for c in consts])
    return _FROB_DEV[key]


def _frobenius(x, k: int, which: str):
    """Conjugate every Fp2 component of an Fp6 (k = 3) or Fp12 (k = 6)
    element, then multiply components 1 .. k - 1 by the constants in one
    `f2_mul`."""
    c = _f2_batch(x, k)
    c = _stack([c[:, 0], FP.neg(c[:, 1])], 1)
    g = _frob_consts(x.device, which)
    g = g.reshape(tuple(g.shape) + (1,) * (c.dim() - 3))
    return _f2_unbatch(torch.cat([c[:, :, :1], f2_mul(c[:, :, 1:], g)], 2))


def f6_frobenius(x):
    return _frobenius(x, 3, "f6")


def f12_frobenius(x):
    """x^p: the reference's f6_frobenius of both halves and the odd half
    times xi^((p - 1) / 6), with the constants multiplied in advance."""
    return _frobenius(x, 6, "f12")


# ---- cyclotomic arithmetic -------------------------------------------------


def f12_cyclotomic_sqr(x):
    """Granger-Scott compressed squaring, valid ONLY in the cyclotomic
    subgroup (anything after the easy part of the final exponentiation):
    three Fp4 squarings over the pairs (z0, z1), (z2, z3), (z4, z5), their
    nine Fp2 squares in one `f2_sqr`."""
    z = _f2_batch(x, 6)  # z0, z4, z3, z2, z1, z5
    a = z[:, :, [0, 3, 1]]  # z0, z2, z4: each pair's first
    b = z[:, :, [4, 2, 5]]  # z1, z3, z5
    sq = f2_sqr(torch.cat([a, b, FP.add(a, b)], 2))
    t0, t1 = sq[:, :, 0:3], sq[:, :, 3:6]
    c0 = FP.add(f2_mul_xi(t1), t0)  # each Fp4 square: c0 + c1 s
    c1 = FP.sub(FP.sub(sq[:, :, 6:9], t0), t1)
    # z0' = 3 T0 - 2 z0, z4' = 3 S0 - 2 z4, z3' = 3 U0 - 2 z3 and
    # z1' = 3 T1 + 2 z1, z5' = 3 S1 + 2 z5, z2' = 3 xi U1 + 2 z2
    tm = c0
    tp = torch.cat([c1[:, :, :2], f2_mul_xi(c1[:, :, 2:])], 2)
    d = torch.cat([FP.sub(tm, z[:, :, [0, 1, 2]]), FP.add(tp, z[:, :, [4, 5, 3]])], 2)
    out = FP.add(FP.add(d, d), torch.cat([tm, tp], 2))  # z0 z4 z3 z1 z5 z2
    return _f2_unbatch(out[:, :, [0, 1, 2, 5, 3, 4]])


def _subset_table(fs):
    """T[mask] = prod_{i in mask} fs[i] for every mask of len(fs) bits, the
    products of each popcount level as one stacked `f12_mul`."""
    k = len(fs)
    table = {0: None}
    for i, f in enumerate(fs):
        table[1 << i] = f
    for bits in range(2, k + 1):
        masks = [m for m in range(1 << k) if bin(m).count("1") == bits]
        lows = [m & -m for m in masks]
        pr = f12_mul(_stack([table[m ^ low] for m, low in zip(masks, lows)]),
                     _stack([table[low] for low in lows]))
        for j, m in enumerate(masks):
            table[m] = pr[:, :, j]
    return table


def f12_joint_pow_frobenius(f, exps, use_cyclotomic: bool = True):
    """prod_i (f^(p^i))^(exps[i]) for static integer exponents by one
    Shamir joint ladder, MSB first: a squaring a bit (cyclotomic when f is
    in the cyclotomic subgroup) and a multiply by the table entry the bit
    column selects. The bit columns are constants, so a column of zeros
    skips its multiply (the reference multiplies by T[0] = 1: the same
    value)."""
    k = len(exps)
    if not 1 <= k <= 6:
        raise ValueError("between 1 and 6 exponents")
    nbits = max(e.bit_length() for e in exps)
    if nbits == 0:
        return f12_one(tuple(f.shape[2:]), f.device)
    fs = [f]
    for _ in range(k - 1):
        fs.append(f12_frobenius(fs[-1]))
    table = _subset_table(fs)
    masks = [sum(((e >> (nbits - 1 - j)) & 1) << i for i, e in enumerate(exps))
             for j in range(nbits)]
    sqr = f12_cyclotomic_sqr if use_cyclotomic else f12_sqr
    acc = table[masks[0]]
    for mask in masks[1:]:
        acc = sqr(acc)
        if mask:
            acc = f12_mul(acc, table[mask])
    return acc


# ---- powers ----------------------------------------------------------------


def f12_pow_static(x, e: int):
    """x^e for a Python-int exponent by square and multiply, LSB first."""
    acc = f12_one(tuple(x.shape[2:]), x.device)
    base = x
    while e:
        if e & 1:
            acc = f12_mul(acc, base)
        e >>= 1
        if e:
            base = f12_sqr(base)
    return acc


# ---- host converters -------------------------------------------------------


def f12_from_oracle(o, device=None):
    """Oracle Fp12 -> (12, 12) words on `device`."""
    cs = []
    for c6 in (o.c0, o.c1):
        for c2 in (c6.c0, c6.c1, c6.c2):
            cs += [c2.a.n, c2.b.n]
    return torch.from_numpy(FP.encode(cs)).to(resolve_device(device))


def f12_to_oracle(x):
    """(12, 12) words -> oracle Fp12 (host)."""
    from ..oracle.field import Fp, Fp2, Fp6, Fp12

    vals = FP.decode(x.reshape(_W, 12))
    f2s = [Fp2(Fp(vals[2 * i]), Fp(vals[2 * i + 1])) for i in range(6)]
    return Fp12(Fp6(*f2s[0:3]), Fp6(*f2s[3:6]))
