"""BLS12-381 in plain Python integers: the two prime fields' constants, G1
and G2 in Jacobian coordinates, scalar multiplication and the ZCash
compressed encoding (48 bytes for G1, 96 for G2).

The benchmark's reference: it imports nothing of the program. Constants are
those of the curve's specification (draft-irtf-cfrg-pairing-friendly-curves,
section 4.2.1); the generators' encodings are checked against the standard
bytes by the tests.
"""

P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001

G1_X = 0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB
G1_Y = 0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1
G2_X = (0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
        0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E)
G2_Y = (0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
        0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE)


class _Fp:
    """Fp as Python ints."""

    zero, one = 0, 1

    @staticmethod
    def add(a, b):
        return (a + b) % P

    @staticmethod
    def sub(a, b):
        return (a - b) % P

    @staticmethod
    def mul(a, b):
        return a * b % P

    @staticmethod
    def small(a, k):
        return a * k % P

    @staticmethod
    def inv(a):
        return pow(a, -1, P)

    @staticmethod
    def is_zero(a):
        return a == 0


class _Fp2:
    """Fp2 = Fp[u] / (u^2 + 1) as pairs (c0, c1)."""

    zero, one = (0, 0), (1, 0)

    @staticmethod
    def add(a, b):
        return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)

    @staticmethod
    def sub(a, b):
        return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)

    @staticmethod
    def mul(a, b):
        t0, t1 = a[0] * b[0], a[1] * b[1]
        return ((t0 - t1) % P, ((a[0] + a[1]) * (b[0] + b[1]) - t0 - t1) % P)

    @staticmethod
    def small(a, k):
        return (a[0] * k % P, a[1] * k % P)

    @staticmethod
    def inv(a):
        d = pow(a[0] * a[0] + a[1] * a[1], -1, P)
        return (a[0] * d % P, -a[1] * d % P)

    @staticmethod
    def is_zero(a):
        return a == (0, 0)


class Group:
    """A short Weierstrass group y^2 = x^3 + b (a = 0) over field F, points
    as Jacobian triples (X, Y, Z) with Z = 0 for infinity."""

    def __init__(self, field, gen_x, gen_y):
        self.F = field
        self.gen = (gen_x, gen_y, field.one)
        self.inf = (field.one, field.one, field.zero)

    def is_inf(self, p):
        return self.F.is_zero(p[2])

    def dbl(self, p):
        F = self.F
        if self.is_inf(p) or F.is_zero(p[1]):
            return self.inf
        x, y, z = p
        a = F.mul(x, x)
        b = F.mul(y, y)
        c = F.mul(b, b)
        t = F.add(x, b)
        d = F.small(F.sub(F.sub(F.mul(t, t), a), c), 2)
        e = F.small(a, 3)
        f = F.mul(e, e)
        x3 = F.sub(f, F.small(d, 2))
        y3 = F.sub(F.mul(e, F.sub(d, x3)), F.small(c, 8))
        z3 = F.small(F.mul(y, z), 2)
        return (x3, y3, z3)

    def add(self, p, q):
        F = self.F
        if self.is_inf(p):
            return q
        if self.is_inf(q):
            return p
        z1z1 = F.mul(p[2], p[2])
        z2z2 = F.mul(q[2], q[2])
        u1 = F.mul(p[0], z2z2)
        u2 = F.mul(q[0], z1z1)
        s1 = F.mul(F.mul(p[1], q[2]), z2z2)
        s2 = F.mul(F.mul(q[1], p[2]), z1z1)
        h = F.sub(u2, u1)
        rr = F.small(F.sub(s2, s1), 2)
        if F.is_zero(h):
            return self.dbl(p) if F.is_zero(rr) else self.inf
        i = F.small(h, 2)
        i = F.mul(i, i)
        j = F.mul(h, i)
        v = F.mul(u1, i)
        x3 = F.sub(F.sub(F.mul(rr, rr), j), F.small(v, 2))
        y3 = F.sub(F.mul(rr, F.sub(v, x3)), F.small(F.mul(s1, j), 2))
        zs = F.add(p[2], q[2])
        z3 = F.mul(F.sub(F.sub(F.mul(zs, zs), z1z1), z2z2), h)
        return (x3, y3, z3)

    def neg(self, p):
        return (p[0], self.F.sub(self.F.zero, p[1]), p[2])

    def mul(self, p, k: int):
        """k p for an integer k >= 0, by 4-bit windows from the top."""
        if k == 0 or self.is_inf(p):
            return self.inf
        table = [self.inf, p]
        for _ in range(14):
            table.append(self.add(table[-1], p))
        acc = self.inf
        for shift in range((k.bit_length() + 3) // 4 * 4 - 4, -1, -4):
            for _ in range(4):
                acc = self.dbl(acc)
            d = (k >> shift) & 15
            if d:
                acc = self.add(acc, table[d])
        return acc

    def affine(self, p):
        """(x, y), or None at infinity."""
        if self.is_inf(p):
            return None
        F = self.F
        zi = F.inv(p[2])
        zi2 = F.mul(zi, zi)
        return (F.mul(p[0], zi2), F.mul(p[1], F.mul(zi2, zi)))

    def from_affine(self, xy):
        return self.inf if xy is None else (xy[0], xy[1], self.F.one)

    def eq(self, p, q):
        return self.affine(p) == self.affine(q)


G1 = Group(_Fp, G1_X, G1_Y)
G2 = Group(_Fp2, G2_X, G2_Y)

_COMPRESSED, _INFINITY, _SORT = 0x80, 0x40, 0x20


def g1_compress(p) -> bytes:
    """ZCash encoding of a G1 point given in Jacobian coordinates."""
    xy = G1.affine(p)
    if xy is None:
        return bytes([_COMPRESSED | _INFINITY]) + bytes(47)
    x, y = xy
    out = bytearray(x.to_bytes(48, "big"))
    out[0] |= _COMPRESSED | (_SORT if y > P - y else 0)
    return bytes(out)


def g2_compress(p) -> bytes:
    """ZCash encoding of a G2 point: x as c1 || c0, the sort bit from y's
    c1, or from c0 where c1 is 0."""
    xy = G2.affine(p)
    if xy is None:
        return bytes([_COMPRESSED | _INFINITY]) + bytes(95)
    (x0, x1), (y0, y1) = xy
    out = bytearray(x1.to_bytes(48, "big") + x0.to_bytes(48, "big"))
    big = y1 > P - y1 if y1 else y0 > P - y0
    out[0] |= _COMPRESSED | (_SORT if big else 0)
    return bytes(out)
