"""Copy of `kzg_tpu/oracle/curve.py`. The `kzg_tpu` package imports JAX in
its `__init__`, so the port, which runs where JAX is absent, cannot import
even the JAX-free modules of that package.

Pure-Python BLS12-381 group ops and the optimal ate pairing (oracle).

Generic affine elliptic-curve arithmetic parameterised over the field class,
so the same code serves E(Fp), E'(Fp2), and E(Fp12) (the latter for the
Miller loop after untwisting). Points are `None` (infinity) or `(x, y)`
tuples of field elements.

The Rust reference obtains these ops from blstrs (reference src/lib.rs:1-10,
coeff_form.rs:126-142); this module re-derives them from the curve equation.
"""

from .field import Fp, Fp2, Fp6, Fp12
from ..constants import B_G1, B_G2, G1_GEN, G2_GEN, BLS_X, R


def ec_add(p, q):
    """Affine addition on y^2 = x^3 + b (any b; b never enters the formulas)."""
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if y1 == y2:
            if y1.is_zero():
                return None
            lam = x1.square().mul_small(3) * (y1 + y1).inv()
        else:
            return None
    else:
        lam = (y2 - y1) * (x2 - x1).inv()
    x3 = lam.square() - x1 - x2
    y3 = lam * (x1 - x3) - y1
    return (x3, y3)


def ec_neg(p):
    return None if p is None else (p[0], -p[1])


def ec_mul(p, k: int):
    k %= R
    acc = None
    add = p
    while k:
        if k & 1:
            acc = ec_add(acc, add)
        add = ec_add(add, add)
        k >>= 1
    return acc


def on_curve_g1(p) -> bool:
    if p is None:
        return True
    x, y = p
    return y.square() == x.square() * x + Fp(B_G1)


def on_curve_g2(p) -> bool:
    if p is None:
        return True
    x, y = p
    return y.square() == x.square() * x + Fp2.from_ints(*B_G2)


def g1_generator():
    return (Fp(G1_GEN[0]), Fp(G1_GEN[1]))


def g2_generator():
    return (Fp2.from_ints(*G2_GEN[0]), Fp2.from_ints(*G2_GEN[1]))


# --- Untwist: E'(Fp2) -> E(Fp12) ----------------------------------------
# E': y^2 = x^3 + 4*xi is an M-type twist; with w^6 = xi the map
# (x, y) -> (x/w^2, y/w^3) lands on y^2 = x^3 + 4 over Fp12.
def _w_inv_powers():
    # w^-2 = v^2/xi (even part), w^-3 = w * v^2 / xi^2 * xi = computed below.
    zero2 = Fp2.zero()
    one2 = Fp2.one()
    xi_inv = Fp2.from_ints(1, 1).inv()
    # w^-1 = w / v  (since w^2 = v)  -> w^-2 = 1/v = v^2 / xi
    v2_over_xi = Fp6(zero2, zero2, xi_inv)  # coefficient of v^2 is xi^-1 -> v^2/xi = 1/v
    w_m2 = Fp12(v2_over_xi, Fp6.zero())
    # w^-3 = w^-2 * w^-1 ; w^-1 = w * (1/v) = w * v^2/xi
    w_m1 = Fp12(Fp6.zero(), v2_over_xi)
    w_m3 = w_m2 * w_m1
    return w_m2, w_m3


_W_M2, _W_M3 = None, None


def untwist(q):
    """Map a point on E'(Fp2) to E(Fp12)."""
    global _W_M2, _W_M3
    if _W_M2 is None:
        _W_M2, _W_M3 = _w_inv_powers()
    if q is None:
        return None
    x, y = q
    return (Fp12.from_fp2(x) * _W_M2, Fp12.from_fp2(y) * _W_M3)


# --- Optimal ate pairing --------------------------------------------------

def _line(t, q, p):
    """Evaluate the line through t,q (or tangent if t==q) at p; all in Fp12."""
    xt, yt = t
    xp, yp = p
    if t == q:
        lam = xt.square().mul_small(3) * (yt + yt).inv()
    elif xt == q[0]:
        # vertical line x = xt
        return xp - xt
    else:
        lam = (q[1] - yt) * (q[0] - xt).inv()
    return yp - yt - lam * (xp - xt)


def miller_loop(p_g1, q_g2) -> Fp12:
    """Optimal ate Miller loop f_{|x|,Q}(P) with the BLS x-negation fixup."""
    if p_g1 is None or q_g2 is None:
        return Fp12.one()
    q = untwist(q_g2)
    p = (Fp12.from_fp(p_g1[0]), Fp12.from_fp(p_g1[1]))
    t = q
    f = Fp12.one()
    n = -BLS_X  # positive
    for i in range(n.bit_length() - 2, -1, -1):
        f = f.square() * _line(t, t, p)
        t = ec_add(t, t)
        if (n >> i) & 1:
            f = f * _line(t, q, p)
            t = ec_add(t, q)
    # x < 0: f <- conjugate(f)
    return f.conj()


def final_exponentiation(f: Fp12) -> Fp12:
    """f^((p^12-1)/r). Easy part via conj/inv + Frobenius; hard part by pow."""
    from ..constants import P
    # easy: f <- f^(p^6 - 1) = conj(f) * f^-1 ; then f <- f^(p^2 + 1)
    f = f.conj() * f.inv()
    f = f.frobenius().frobenius() * f
    # hard: f^((p^4 - p^2 + 1)/r)
    hard = (P**4 - P**2 + 1) // R
    return f.pow(hard)


def pairing(p_g1, q_g2) -> Fp12:
    return final_exponentiation(miller_loop(p_g1, q_g2))


def multi_pairing_check(pairs) -> bool:
    """True iff prod e(Pi, Qi) == 1; shares one final exponentiation."""
    f = Fp12.one()
    for p_g1, q_g2 in pairs:
        f = f * miller_loop(p_g1, q_g2)
    return final_exponentiation(f) == Fp12.one()
