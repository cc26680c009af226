"""Branch-free Jacobian group law over Fp (G1) and Fp2 (G2), generic over a
field adapter (port of `kzg_tpu/curve/ops.py`).

The formulas are ported verbatim (dbl-2009-l, add-2007-bl, madd-2007-bl,
a = 0, which never reference b) with the same exceptional-case selects, so
over the same field they give the JAX package's `CurveOps` outputs limb for
limb. Points are (X, Y, Z) tuples of field elements; Z == 0 encodes
infinity, and infinity is written (1, 1, 0) in Montgomery form.

The field adapter is a `LimbField` for G1 (elements (W, *batch)) or an
`Fp2Adapter` for G2 (elements (W, 2, *batch), c0 then c1 on axis 1). Each
has `bdim`, the number of leading non-batch axes, and `expand`, which lifts
a batch mask onto elements. Over `FP` the field math goes through kernel K1
on CUDA tensors; over `FP.as_plain()` (or `Fp2Adapter(FP.as_plain())`) it
is the plain PyTorch twin of the point kernels (curve/cuda_ops.py).
"""

import torch


class Fp2Adapter:
    """Quadratic extension Fp[u]/(u^2 + 1) over a LimbField: element shape
    (W, 2, *batch). Karatsuba `mul` and the (a + b)(a - b) `sqr` of
    `kzg_tpu/curve/ops.py:70-137`; the independent Fp multiplications of
    each run as ONE batched field multiply (the components stacked on axis
    1), which gives the same words in fewer launches."""

    bdim = 2

    def __init__(self, field):
        self.f = field
        self.W = field.W
        self.name = f"{field.name}2"

    def add(self, a, b):
        return self.f.add(a, b)

    def sub(self, a, b):
        return self.f.sub(a, b)

    def neg(self, a):
        return self.f.neg(a)

    def mul(self, x, y):
        f = self.f
        x, y = torch.broadcast_tensors(x, y)
        ab_cd = f.add(torch.stack([x[:, 0], y[:, 0]], dim=1), torch.stack([x[:, 1], y[:, 1]], dim=1))
        lhs = torch.cat([x, ab_cd[:, :1]], dim=1)  # a, b, a + b
        rhs = torch.cat([y, ab_cd[:, 1:]], dim=1)  # c, d, c + d
        prods = f.mul(lhs, rhs)
        ac, bd, t = prods[:, 0], prods[:, 1], prods[:, 2]
        re = f.sub(ac, bd)
        im = f.sub(f.sub(t, ac), bd)
        return torch.stack([re, im], dim=1)

    def sqr(self, x):
        f = self.f
        a, b = x[:, 0], x[:, 1]
        lhs = torch.stack([f.add(a, b), a], dim=1)
        rhs = torch.stack([f.sub(a, b), b], dim=1)
        prods = f.mul(lhs, rhs)  # (a + b)(a - b), ab
        ab = prods[:, 1]
        return torch.stack([prods[:, 0], f.add(ab, ab)], dim=1)

    def is_zero(self, a):
        return (a == 0).all(dim=0).all(dim=0)

    def eq(self, a, b):
        return (a == b).all(dim=0).all(dim=0)

    def expand(self, cond):
        return cond[None, None]

    def zeros(self, batch_shape=(), device=None):
        return self.f.zeros((2,) + tuple(batch_shape), device)

    def one(self, batch_shape=(), device=None):
        return torch.stack(
            [self.f.one(batch_shape, device), self.f.zeros(batch_shape, device)], dim=1
        )

    def batch_inv(self, x):
        """(a + bu)^-1 = (a - bu) / (a^2 + b^2), the norm inverted with the
        base field's batch_inv along the last axis; inv(0) = 0."""
        f = self.f
        a, b = x[:, 0], x[:, 1]
        sq = f.mul(x, x)  # a^2, b^2
        ninv = f.batch_inv(f.add(sq[:, 0], sq[:, 1]))
        prods = f.mul(x, ninv[:, None])  # a / n, b / n
        return torch.stack([prods[:, 0], f.neg(prods[:, 1])], dim=1)


class CurveOps:
    """Jacobian group law on y^2 = x^3 + b over the field adapter `f` (a
    LimbField for G1, an Fp2Adapter for G2)."""

    def __init__(self, f, name="G1"):
        self.f = f
        self.name = name

    # ---- constructors ----------------------------------------------------------

    def infinity(self, batch_shape=(), device=None):
        one = self.f.one(batch_shape, device)
        return (one, one.clone(), self.f.zeros(batch_shape, device))

    def from_affine(self, x, y):
        return (x, y, self.f.one(x.shape[self.f.bdim:], x.device))

    # ---- predicates ------------------------------------------------------------

    def is_inf(self, p):
        return self.f.is_zero(p[2])

    def select(self, cond, p, q):
        e = self.f.expand(cond)
        return tuple(torch.where(e, a, b) for a, b in zip(p, q))

    def eq(self, p, q):
        """Projective equality with infinity handled."""
        f = self.f
        z1z1 = f.sqr(p[2])
        z2z2 = f.sqr(q[2])
        xe = f.eq(f.mul(p[0], z2z2), f.mul(q[0], z1z1))
        ye = f.eq(f.mul(p[1], f.mul(q[2], z2z2)), f.mul(q[1], f.mul(p[2], z1z1)))
        pi, qi = self.is_inf(p), self.is_inf(q)
        return (pi & qi) | (~(pi ^ qi) & xe & ye)

    # ---- group law -------------------------------------------------------------

    def neg(self, p):
        return (p[0], self.f.neg(p[1]), p[2])

    def dbl(self, p):
        """dbl-2009-l (a = 0): 2M + 5S."""
        f = self.f
        x, y, z = p
        a = f.sqr(x)
        b = f.sqr(y)
        c = f.sqr(b)
        t = f.sqr(f.add(x, b))
        d = f.sub(f.sub(t, a), c)
        d = f.add(d, d)
        e = f.add(f.add(a, a), a)
        ff = f.sqr(e)
        x3 = f.sub(ff, f.add(d, d))
        c8 = f.add(c, c)
        c8 = f.add(c8, c8)
        c8 = f.add(c8, c8)
        y3 = f.sub(f.mul(e, f.sub(d, x3)), c8)
        yz = f.mul(y, z)
        z3 = f.add(yz, yz)
        return (x3, y3, z3)

    def add(self, p, q):
        """add-2007-bl with full exceptional-case handling via selects."""
        f = self.f
        x1, y1, z1 = p
        x2, y2, z2 = q
        z1z1 = f.sqr(z1)
        z2z2 = f.sqr(z2)
        u1 = f.mul(x1, z2z2)
        u2 = f.mul(x2, z1z1)
        s1 = f.mul(y1, f.mul(z2, z2z2))
        s2 = f.mul(y2, f.mul(z1, z1z1))
        h = f.sub(u2, u1)
        i = f.sqr(f.add(h, h))
        j = f.mul(h, i)
        r = f.sub(s2, s1)
        r = f.add(r, r)
        v = f.mul(u1, i)
        x3 = f.sub(f.sub(f.sqr(r), j), f.add(v, v))
        s1j = f.mul(s1, j)
        y3 = f.sub(f.mul(r, f.sub(v, x3)), f.add(s1j, s1j))
        zz = f.sub(f.sub(f.sqr(f.add(z1, z2)), z1z1), z2z2)
        z3 = f.mul(zz, h)
        out = (x3, y3, z3)
        h0 = f.is_zero(h)
        r0 = f.is_zero(r)
        same = h0 & r0
        opposite = h0 & ~r0
        if bool(same.any()):  # rare: compute the doubling only when needed
            out = self.select(same, self.dbl(p), out)
        out = self.select(opposite, self.infinity(h0.shape, h0.device), out)
        out = self.select(self.is_inf(q), p, out)
        out = self.select(self.is_inf(p), q, out)
        return out

    def madd(self, p, q_affine, q_inf):
        """Mixed add (q affine with an explicit infinity/skip mask):
        madd-2007-bl, 7M + 4S."""
        f = self.f
        x1, y1, z1 = p
        x2, y2 = q_affine
        z1z1 = f.sqr(z1)
        u2 = f.mul(x2, z1z1)
        s2 = f.mul(y2, f.mul(z1, z1z1))
        h = f.sub(u2, x1)
        hh = f.sqr(h)
        i = f.add(hh, hh)
        i = f.add(i, i)
        j = f.mul(h, i)
        r = f.sub(s2, y1)
        r = f.add(r, r)
        v = f.mul(x1, i)
        x3 = f.sub(f.sub(f.sqr(r), j), f.add(v, v))
        y1j = f.mul(y1, j)
        y3 = f.sub(f.mul(r, f.sub(v, x3)), f.add(y1j, y1j))
        z3 = f.sub(f.sub(f.sqr(f.add(z1, h)), z1z1), hh)
        out = (x3, y3, z3)
        h0 = f.is_zero(h)
        r0 = f.is_zero(r)
        same = h0 & r0
        opposite = h0 & ~r0
        if bool(same.any()):
            out = self.select(same, self.dbl(p), out)
        out = self.select(opposite, self.infinity(h0.shape, h0.device), out)
        q_jac = (x2, y2, f.one(h0.shape, h0.device))
        out = self.select(self.is_inf(p), q_jac, out)
        out = self.select(q_inf, p, out)
        return out

    def madd_multi(self, acc, q_affine, skip, neg=None):
        """S bucket-loop steps in sequence: acc += q_affine[s] for s = 0 ..
        S - 1 under per-(step, lane) masks (the step loop of
        `kzg_tpu/curve/pallas_ops.py:838-859`). acc is a Jacobian batch of
        shape `batch`; q_affine = (qx, qy) with a step axis before the batch
        axes, (W[, 2], S, *batch); skip / neg are (S, *batch) bool: skip
        keeps the lane, neg adds -q = (x, -y)."""
        bd = self.f.bdim
        for s in range(skip.shape[0]):
            x2, y2 = q_affine[0].select(bd, s), q_affine[1].select(bd, s)
            if neg is not None:
                y2 = torch.where(self.f.expand(neg[s]), self.f.neg(y2), y2)
            acc = self.madd(acc, (x2, y2), skip[s])
        return acc

    # ---- scalar multiplication and joins -----------------------------------------

    def scalar_mul_bits(self, p, bits):
        """p * k where bits is (nbits, *batch) of 0/1 (LSB first):
        double-and-add, batched over points."""
        acc = self.infinity(bits.shape[1:], bits.device)
        base = p
        for i in range(bits.shape[0]):
            acc = self.select(bits[i] != 0, self.add(acc, base), acc)
            base = self.dbl(base)
        return acc

    def scalar_mul_digits(self, p, digits, c: int):
        """p * k by a windowed MSB-first ladder (`kzg_tpu/curve/ops.py:
        316-374`): digits (W, *batch) integers in [0, 2^c), digits[0] the
        MOST significant window.

        Builds the 2^c - 1 multiples of p and normalises them to affine
        (`ladder_table`), then runs W rounds of c doublings and one
        skip-masked `madd` with the table entry each lane's digit selects
        (`ladder_rounds`)."""
        tx, ty, p_inf = self.ladder_table(p, c)
        return self.ladder_rounds(tx, ty, p_inf, digits, c)

    def ladder_table(self, p, c: int):
        """The ladder's table: the multiples 1 .. 2^c - 1 of p, stacked on a
        table axis after the word axes, normalised with one batched
        `to_affine`. They come by doubling blocks: from the multiples 1 .. N,
        one batched `add` of N p to each gives N + 1 .. 2N (2N = N + N
        through the add's doubling case), so c launches build the table
        (the reference adds p once an entry, 2^c - 2 launches; the affine
        words are the same). Returns (tx, ty) of shape (W[, 2], T, *batch)
        and p's infinity mask."""
        if c < 1:
            raise ValueError("window must be >= 1")
        bd = self.f.bdim
        t_count = (1 << c) - 1
        table = tuple(t.unsqueeze(bd) for t in p)  # multiples 1 .. N
        while table[0].shape[bd] < t_count:
            n = table[0].shape[bd]
            k = min(n, t_count - n)
            top = tuple(t.narrow(bd, n - 1, 1).expand(t.shape[:bd] + (k,) + t.shape[bd + 1:])
                        for t in table)
            new = self.add(top, tuple(t.narrow(bd, 0, k) for t in table))
            table = tuple(torch.cat([t, u], dim=bd) for t, u in zip(table, new))
        tx, ty, _ = self.to_affine(table)
        return tx, ty, self.is_inf(p)

    def ladder_rounds(self, tx, ty, p_inf, digits, c: int):
        """The ladder's rounds on a `ladder_table`: from infinity, per window
        (MSB first) c doublings, then one `madd` with entry digit - 1. Digit
        0 lanes read a clamped entry and are skipped; every multiple of an
        infinite p is infinite, so those lanes are skipped too."""
        bd = self.f.bdim
        t_count = (1 << c) - 1
        digits = digits.to(torch.int64)

        def sel(tab, d):
            idx = (d - 1).clamp(0, t_count - 1)
            idx = idx.reshape((1,) * (bd + 1) + tuple(idx.shape))
            idx = idx.expand(tab.shape[:bd] + (1,) + tab.shape[bd + 1:])
            return torch.gather(tab, bd, idx).squeeze(bd)

        acc = self.infinity(digits.shape[1:], tx.device)
        for w in range(digits.shape[0]):
            for _ in range(c):
                acc = self.dbl(acc)
            d = digits[w]
            acc = self.madd(acc, (sel(tx, d), sel(ty, d)), (d == 0) | p_inf)
        return acc

    def window_join(self, s_all, c: int):
        """Pippenger Horner join sum_w 2^(c*w) * s_all[..., w] over the last
        axis -> batch-() point: per window, MSB first, c doublings (infinity
        kept fixed, as the Pallas `horner_join` does) then one full add."""
        w_count = s_all[0].shape[-1]
        acc = self.infinity((), s_all[0].device)
        for i in range(w_count):
            for _ in range(c):
                acc = self.select(self.is_inf(acc), acc, self.dbl(acc))
            acc = self.add(acc, tuple(t[..., w_count - 1 - i] for t in s_all))
        return acc

    # ---- affine conversion ---------------------------------------------------------

    def to_affine(self, p):
        """Batch normalise: returns (x, y, inf_mask). The Z inverses are one
        `batch_inv` along the last batch axis, the leading batch axes its
        rows (a batch of no axis is one row of one), so the scan's launches
        follow the last axis's length alone, whatever the rows."""
        f = self.f
        x, y, z = p
        inf = self.is_inf(p)
        zsafe = torch.where(f.expand(inf), f.one(inf.shape, z.device), z)
        rows = zsafe if inf.dim() else zsafe.unsqueeze(-1)
        zinv = f.batch_inv(rows).reshape(zsafe.shape)
        zi2 = f.sqr(zinv)
        zi3 = f.mul(zinv, zi2)
        return (f.mul(x, zi2), f.mul(y, zi3), inf)
