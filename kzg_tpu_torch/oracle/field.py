"""Copy of `kzg_tpu/oracle/field.py`. The `kzg_tpu` package imports JAX in
its `__init__`, so the port, which runs where JAX is absent, cannot import
even the JAX-free modules of that package.

Pure-Python BLS12-381 field tower: Fp, Fp2, Fp6, Fp12.

This is the *oracle*: a slow, obviously-correct implementation used (a) as
the differential-test reference for every TPU kernel and (b) as the initial
host-side pairing engine for verification. It mirrors the semantics the Rust
reference gets from blstrs/blst (reference Cargo.toml:27) without borrowing
any of its code.

Tower (zkcrypto-compatible):
    Fp2  = Fp[u]  / (u^2 + 1)
    Fp6  = Fp2[v] / (v^3 - xi),  xi = u + 1
    Fp12 = Fp6[w] / (w^2 - v)
"""

from ..constants import P


class Fp:
    __slots__ = ("n",)
    MOD = P

    def __init__(self, n: int):
        self.n = n % P

    def __add__(self, o):
        return Fp(self.n + o.n)

    def __sub__(self, o):
        return Fp(self.n - o.n)

    def __mul__(self, o):
        return Fp(self.n * o.n)

    def __neg__(self):
        return Fp(-self.n)

    def __eq__(self, o):
        return self.n == o.n

    def __hash__(self):
        return hash(("Fp", self.n))

    def is_zero(self):
        return self.n == 0

    def inv(self):
        return Fp(pow(self.n, -1, P))

    def square(self):
        return Fp(self.n * self.n)

    def mul_small(self, k: int):
        return Fp(self.n * k)

    def sqrt(self):
        # p % 4 == 3 -> candidate = self^((p+1)/4)
        c = Fp(pow(self.n, (P + 1) // 4, P))
        return c if c.square() == self else None

    @classmethod
    def zero(cls):
        return cls(0)

    @classmethod
    def one(cls):
        return cls(1)

    def __repr__(self):
        return f"Fp(0x{self.n:x})"


class Fp2:
    """a + b*u with u^2 = -1."""

    __slots__ = ("a", "b")

    def __init__(self, a: Fp, b: Fp):
        self.a, self.b = a, b

    @classmethod
    def from_ints(cls, a: int, b: int):
        return cls(Fp(a), Fp(b))

    def __add__(self, o):
        return Fp2(self.a + o.a, self.b + o.b)

    def __sub__(self, o):
        return Fp2(self.a - o.a, self.b - o.b)

    def __neg__(self):
        return Fp2(-self.a, -self.b)

    def __mul__(self, o):
        # (a+bu)(c+du) = (ac - bd) + (ad + bc)u
        ac = self.a * o.a
        bd = self.b * o.b
        return Fp2(ac - bd, (self.a + self.b) * (o.a + o.b) - ac - bd)

    def __eq__(self, o):
        return self.a == o.a and self.b == o.b

    def __hash__(self):
        return hash(("Fp2", self.a.n, self.b.n))

    def is_zero(self):
        return self.a.is_zero() and self.b.is_zero()

    def square(self):
        return self * self

    def mul_small(self, k: int):
        return Fp2(self.a.mul_small(k), self.b.mul_small(k))

    def mul_fp(self, s: Fp):
        return Fp2(self.a * s, self.b * s)

    def conj(self):
        return Fp2(self.a, -self.b)

    def inv(self):
        # (a+bu)^-1 = (a-bu)/(a^2+b^2)
        norm_inv = (self.a.square() + self.b.square()).inv()
        return Fp2(self.a * norm_inv, -(self.b) * norm_inv)

    def mul_xi(self):
        # multiply by xi = 1 + u: (a+bu)(1+u) = (a-b) + (a+b)u
        return Fp2(self.a - self.b, self.a + self.b)

    def frobenius(self):
        # x -> x^p is conjugation in Fp2
        return self.conj()

    def sqrt(self):
        """Square root in Fp2 (p^2 = 9 mod 16; use the p%4==3 trick)."""
        if self.is_zero():
            return self
        # candidate via a = self^((p-1)/2)? Use generic: alpha = a^2+b^2 etc.
        # Simple approach for p % 4 == 3 (Adj-Rodriguez):
        a1 = self.pow((P - 3) // 4)
        alpha = a1.square() * self
        x0 = a1 * self
        if alpha == Fp2(Fp(P - 1), Fp.zero()):
            cand = Fp2(-x0.b, x0.a)  # multiply by u
        else:
            cand = (alpha + Fp2.one()).pow((P - 1) // 2) * x0
        return cand if cand.square() == self else None

    def pow(self, e: int):
        result = Fp2.one()
        base = self
        while e > 0:
            if e & 1:
                result = result * base
            base = base.square()
            e >>= 1
        return result

    @classmethod
    def zero(cls):
        return cls(Fp.zero(), Fp.zero())

    @classmethod
    def one(cls):
        return cls(Fp.one(), Fp.zero())

    def __repr__(self):
        return f"Fp2(0x{self.a.n:x}, 0x{self.b.n:x})"


XI = Fp2.from_ints(1, 1)

# Frobenius coefficients for Fp6/Fp12: gamma1[i] = xi^((p-1)*i/6) etc. are
# computed on demand via pow below (slow but only computed once).
_XI_POW_CACHE = {}


def _xi_pow(num: int, den: int) -> Fp2:
    """xi^((p^1 - 1) * num/den) -- exponent guaranteed integral."""
    key = (num, den)
    if key not in _XI_POW_CACHE:
        e = (P - 1) * num // den
        assert (P - 1) * num % den == 0 or True
        _XI_POW_CACHE[key] = XI.pow(e)
    return _XI_POW_CACHE[key]


class Fp6:
    """c0 + c1*v + c2*v^2 with v^3 = xi."""

    __slots__ = ("c0", "c1", "c2")

    def __init__(self, c0: Fp2, c1: Fp2, c2: Fp2):
        self.c0, self.c1, self.c2 = c0, c1, c2

    def __add__(self, o):
        return Fp6(self.c0 + o.c0, self.c1 + o.c1, self.c2 + o.c2)

    def __sub__(self, o):
        return Fp6(self.c0 - o.c0, self.c1 - o.c1, self.c2 - o.c2)

    def __neg__(self):
        return Fp6(-self.c0, -self.c1, -self.c2)

    def __mul__(self, o):
        a0, a1, a2 = self.c0, self.c1, self.c2
        b0, b1, b2 = o.c0, o.c1, o.c2
        t0 = a0 * b0
        t1 = a1 * b1
        t2 = a2 * b2
        c0 = t0 + ((a1 + a2) * (b1 + b2) - t1 - t2).mul_xi()
        c1 = (a0 + a1) * (b0 + b1) - t0 - t1 + t2.mul_xi()
        c2 = (a0 + a2) * (b0 + b2) - t0 - t2 + t1
        return Fp6(c0, c1, c2)

    def __eq__(self, o):
        return self.c0 == o.c0 and self.c1 == o.c1 and self.c2 == o.c2

    def is_zero(self):
        return self.c0.is_zero() and self.c1.is_zero() and self.c2.is_zero()

    def square(self):
        return self * self

    def mul_fp2(self, s: Fp2):
        return Fp6(self.c0 * s, self.c1 * s, self.c2 * s)

    def mul_small(self, k: int):
        return Fp6(self.c0.mul_small(k), self.c1.mul_small(k), self.c2.mul_small(k))

    def mul_v(self):
        # (c0 + c1 v + c2 v^2) * v = c2*xi + c0 v + c1 v^2
        return Fp6(self.c2.mul_xi(), self.c0, self.c1)

    def inv(self):
        a, b, c = self.c0, self.c1, self.c2
        t0 = a.square() - (b * c).mul_xi()
        t1 = c.square().mul_xi() - a * b
        t2 = b.square() - a * c
        denom = (a * t0 + (c * t1 + b * t2).mul_xi()).inv()
        return Fp6(t0 * denom, t1 * denom, t2 * denom)

    def frobenius(self):
        c0 = self.c0.frobenius()
        c1 = self.c1.frobenius() * _xi_pow(1, 3)
        c2 = self.c2.frobenius() * _xi_pow(2, 3)
        return Fp6(c0, c1, c2)

    @classmethod
    def zero(cls):
        return cls(Fp2.zero(), Fp2.zero(), Fp2.zero())

    @classmethod
    def one(cls):
        return cls(Fp2.one(), Fp2.zero(), Fp2.zero())


class Fp12:
    """c0 + c1*w with w^2 = v."""

    __slots__ = ("c0", "c1")

    def __init__(self, c0: Fp6, c1: Fp6):
        self.c0, self.c1 = c0, c1

    def __add__(self, o):
        return Fp12(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o):
        return Fp12(self.c0 - o.c0, self.c1 - o.c1)

    def __neg__(self):
        return Fp12(-self.c0, -self.c1)

    def __mul__(self, o):
        a0, a1 = self.c0, self.c1
        b0, b1 = o.c0, o.c1
        t0 = a0 * b0
        t1 = a1 * b1
        c0 = t0 + t1.mul_v()
        c1 = (a0 + a1) * (b0 + b1) - t0 - t1
        return Fp12(c0, c1)

    def __eq__(self, o):
        return self.c0 == o.c0 and self.c1 == o.c1

    def is_zero(self):
        return self.c0.is_zero() and self.c1.is_zero()

    def square(self):
        return self * self

    def conj(self):
        """Conjugation = x^(p^6) (negates the odd part)."""
        return Fp12(self.c0, -self.c1)

    def mul_small(self, k: int):
        return Fp12(self.c0.mul_small(k), self.c1.mul_small(k))

    def inv(self):
        denom = (self.c0.square() - self.c1.square().mul_v()).inv()
        return Fp12(self.c0 * denom, -(self.c1) * denom)

    def frobenius(self):
        c0 = self.c0.frobenius()
        c1 = self.c1.frobenius().mul_fp2(_xi_pow(1, 6))
        return Fp12(c0, c1)

    def pow(self, e: int):
        if e < 0:
            return self.inv().pow(-e)
        result = Fp12.one()
        base = self
        while e > 0:
            if e & 1:
                result = result * base
            base = base.square()
            e >>= 1
        return result

    @classmethod
    def zero(cls):
        return cls(Fp6.zero(), Fp6.zero())

    @classmethod
    def one(cls):
        return cls(Fp6.one(), Fp6.zero())

    @classmethod
    def from_fp(cls, x: Fp):
        return cls(Fp6(Fp2(x, Fp.zero()), Fp2.zero(), Fp2.zero()), Fp6.zero())

    @classmethod
    def from_fp2(cls, x: Fp2):
        return cls(Fp6(x, Fp2.zero(), Fp2.zero()), Fp6.zero())
