"""The programs of the two pairing kernels (`csrc/pairing.cuh`), `miller_loop`
and `final_exp`, as stages of chains of Fp operations on numbered
shared-memory slots, and their header `csrc/pairing_schedule.cuh`.

The formulas are those of `pairing/tower.py` and `pairing/pairing.py` (the
port of `kzg_tpu/pairing/`), written once more over symbolic Fp values: a
`Trace` records every Fp product, add, sub and inverse they make, with
common subexpressions merged and the operations on a known zero dropped
(the embedded P and the untwisted Q are sparse: x * 0 = 0, x + 0 = x and
x - 0 = x give the same canonical words). `schedule` cuts the recorded
graph into STAGES, each a set of CHAINS that a block runs side by side, one
chain a half-warp, a block barrier closing the stage:

  * the operations ready at a stage (every operand written by an earlier
    one) go to the half-warps longest first (a product costs 1, an add or
    sub `LINEAR`), each to the least loaded;
  * an operation whose operands come from earlier stages or from ONE chain
    of this stage joins that chain while the chain stays within the
    stage's longest load (at least `MIN_BUDGET`);
  * an inverse is a stage of its own: the Fermat chain a^(p - 2), LSB
    first, 381 steps of acc * base and base^2 on the two half-warps of
    warp 0 (the `field_pow` kernel's chain, `csrc/field_kernels.cu`).

`build` gives every value a slot: the kernel's fixed regions (the
constants, the inputs, the state a program updates in place, the subset
table) and, for the rest, the lowest slot free from the stage after its
last reader. A program's result goes straight into its output slot where
the value it replaces has no reader left; otherwise a last stage copies it
(x + 0).

The kernels' control flow around the programs (the loop over the bits of
|x|, the chord step where a bit is 1, the product of the Miller values, the
joint ladder over the columns of `HARD_BASE_P`) is that of `simulate_miller`
and `simulate_final_exp`, which run the programs on Python integers
(Montgomery form, as the kernels): the CPU tests hold them to `tower.py`,
`pairing.py` and the JAX package word for word.

Regenerate the header after a change here:

    python -m kzg_tpu_torch.pairing.schedule --write
"""

import argparse
from dataclasses import dataclass, field
from pathlib import Path

from ..constants import BLS_X, P

MUL, ADD, SUB, INV = 0, 1, 2, 3
BARRIER = 0.1  # a block barrier, in products (the cost model's unit)


# the cost model, as measured on the card (PERF.md §6, rows 1e, 1f): an add or
# sub costs about 0.3 of a product on the 16-lane engine, and a stage's chains
# may run three of them whatever its load
LINEAR = 0.3
MIN_BUDGET = 0.9
# warps a block, a chain a half-warp: the Miller loop gains from 32, the final
# exponentiation not (`python3 -m kzg_tpu_torch.bench.pairing` times both)
MILLER_WARPS = 32
FINAL_WARPS = 16
FERMAT_BITS = (P - 2).bit_length()  # 381 steps of the in-kernel inverse
HEADER = Path(__file__).resolve().parent.parent / "csrc" / "pairing_schedule.cuh"

_MONT = (1 << 384) % P
_R_INV = pow(1 << 384, -1, P)

# |x| MSB first below its top bit: a tangent step every bit, a chord step
# where the bit is 1 (pairing.LOOP_BITS)
LOOP_BITS = tuple((-BLS_X >> i) & 1 for i in range((-BLS_X).bit_length() - 2, -1, -1))


# ---------------------------------------------------------------------------------------
# the constants: w^-2, w^-3 and the Frobenius factors, standard-form ints
# ---------------------------------------------------------------------------------------


def op_cost(kind):
    """An operation's cost in products."""
    return 1.0 if kind == MUL else LINEAR


def _f12_ints(o):
    """Oracle Fp12 -> its 12 Fp coefficients in the tower's order."""
    return [c.n for c6 in (o.c0, o.c1) for c2 in (c6.c0, c6.c1, c6.c2) for c in (c2.a, c2.b)]


def w_inv_ints():
    """w^-2 and w^-3, 12 ints each (the untwist's factors)."""
    from ..oracle.curve import _w_inv_powers

    return tuple(_f12_ints(w) for w in _w_inv_powers())


def frob_ints():
    """The five Fp2 factors of `tower._FROB12`, 10 ints."""
    from .tower import _FROB12

    return [c for pair in _FROB12 for c in pair]


# ---------------------------------------------------------------------------------------
# the trace: Fp operations on symbolic values
# ---------------------------------------------------------------------------------------


class Trace:
    """Records Fp operations. A value is an int id: a leaf (a slot of the
    kernel's fixed regions or a constant) or an operation (kind, a, b).
    Equal operations are one value; operations on a known zero (or a
    product by one) are not recorded."""

    def __init__(self, layout):
        self.layout = layout
        self.defs = []  # id -> ("leaf", slot) or (kind, a, b)
        self._memo = {}
        self.zero = self._leaf(layout.zero)
        self.one = self.const(1)

    def _leaf(self, slot):
        key = ("leaf", slot)
        if key not in self._memo:
            self._memo[key] = len(self.defs)
            self.defs.append(key)
        return self._memo[key]

    def slot(self, region, i=0):
        return self._leaf(self.layout.slot(region, i))

    def region(self, name):
        return [self.slot(name, i) for i in range(self.layout.size(name))]

    def const(self, v):
        v %= P
        return self.zero if v == 0 else self._leaf(self.layout.const_slot(v))

    def _op(self, kind, a, b):
        key = (kind, a, b)
        if key not in self._memo:
            self._memo[key] = len(self.defs)
            self.defs.append(key)
        return self._memo[key]

    def mul(self, a, b):
        if self.zero in (a, b):
            return self.zero
        if a == self.one:
            return b
        if b == self.one:
            return a
        return self._op(MUL, min(a, b), max(a, b))

    def add(self, a, b):
        if a == self.zero:
            return b
        if b == self.zero:
            return a
        return self._op(ADD, min(a, b), max(a, b))

    def sub(self, a, b):
        if b == self.zero:
            return a
        if a == b:
            return self.zero
        return self._op(SUB, a, b)

    def neg(self, a):
        return self.sub(self.zero, a)

    def inv(self, a):
        return self.zero if a == self.zero else self._op(INV, a, a)  # inv(0) = 0

    def is_op(self, v):
        return self.defs[v][0] != "leaf"


# ---- the tower over traced Fp values (the formulas of pairing/tower.py) ---------------
# Fp2: (a, b); Fp6: 3 Fp2; Fp12: 2 Fp6; flat Fp12: 12 values in the tower's order


def f2_add(t, x, y):
    return (t.add(x[0], y[0]), t.add(x[1], y[1]))


def f2_sub(t, x, y):
    return (t.sub(x[0], y[0]), t.sub(x[1], y[1]))


def f2_neg(t, x):
    return (t.neg(x[0]), t.neg(x[1]))


def f2_mul(t, x, y):
    """Karatsuba: ac - bd, (a + b)(c + d) - ac - bd."""
    ac, bd = t.mul(x[0], y[0]), t.mul(x[1], y[1])
    st = t.mul(t.add(x[0], x[1]), t.add(y[0], y[1]))
    return (t.sub(ac, bd), t.sub(t.sub(st, ac), bd))


def f2_sqr(t, x):
    a, b = x
    ab = t.mul(a, b)
    return (t.mul(t.add(a, b), t.sub(a, b)), t.add(ab, ab))


def f2_mul_xi(t, x):
    a, b = x
    return (t.sub(a, b), t.add(a, b))


def f2_inv(t, x):
    a, b = x
    ninv = t.inv(t.add(t.mul(a, a), t.mul(b, b)))
    return (t.mul(a, ninv), t.neg(t.mul(b, ninv)))


def f6_add(t, x, y):
    return [f2_add(t, a, b) for a, b in zip(x, y)]


def f6_sub(t, x, y):
    return [f2_sub(t, a, b) for a, b in zip(x, y)]


def f6_mul(t, x, y):
    """Karatsuba over Fp2 (tower.f6_mul)."""
    a, b = x, y
    lo, hi = (1, 0, 0), (2, 1, 2)
    sa = [f2_add(t, a[i], a[j]) for i, j in zip(lo, hi)]
    sb = [f2_add(t, b[i], b[j]) for i, j in zip(lo, hi)]
    t0, t1, t2 = (f2_mul(t, a[k], b[k]) for k in range(3))
    m12, m01, m02 = (f2_mul(t, sa[k], sb[k]) for k in range(3))
    u0 = f2_sub(t, f2_sub(t, m12, t1), t2)
    u1 = f2_sub(t, f2_sub(t, m01, t0), t1)
    u2 = f2_sub(t, f2_sub(t, m02, t0), t2)
    return [f2_add(t, t0, f2_mul_xi(t, u0)), f2_add(t, u1, f2_mul_xi(t, t2)), f2_add(t, u2, t1)]


def f6_mul_v(t, x):
    return [f2_mul_xi(t, x[2]), x[0], x[1]]


def f6_inv(t, x):
    a, b, c = x
    a2, bc, c2, ab, b2, ac = (f2_mul(t, u, v) for u, v in
                              ((a, a), (b, c), (c, c), (a, b), (b, b), (a, c)))
    t0 = f2_sub(t, a2, f2_mul_xi(t, bc))
    t1 = f2_sub(t, f2_mul_xi(t, c2), ab)
    t2 = f2_sub(t, b2, ac)
    n0, n1, n2 = f2_mul(t, a, t0), f2_mul(t, c, t1), f2_mul(t, b, t2)
    dinv = f2_inv(t, f2_add(t, n0, f2_mul_xi(t, f2_add(t, n1, n2))))
    return [f2_mul(t, u, dinv) for u in (t0, t1, t2)]


def split12(x):
    """Flat 12 values -> (c0, c1) Fp6 of Fp2 pairs."""
    f2s = [(x[2 * i], x[2 * i + 1]) for i in range(6)]
    return f2s[:3], f2s[3:]


def flat12(c0, c1):
    return [v for f2 in list(c0) + list(c1) for v in f2]


def f12_add(t, x, y):
    return [t.add(a, b) for a, b in zip(x, y)]


def f12_sub(t, x, y):
    return [t.sub(a, b) for a, b in zip(x, y)]


def f12_mul(t, x, y):
    """Karatsuba over Fp6 (tower.f12_mul)."""
    a0, a1 = split12(x)
    b0, b1 = split12(y)
    t0, t1 = f6_mul(t, a0, b0), f6_mul(t, a1, b1)
    m = f6_mul(t, f6_add(t, a0, a1), f6_add(t, b0, b1))
    return flat12(f6_add(t, t0, f6_mul_v(t, t1)), f6_sub(t, f6_sub(t, m, t0), t1))


def f12_sqr(t, x):
    """Complex squaring (tower.f12_sqr)."""
    a0, a1 = split12(x)
    tt = f6_mul(t, a0, a1)
    m = f6_mul(t, f6_add(t, a0, a1), f6_add(t, a0, f6_mul_v(t, a1)))
    return flat12(f6_sub(t, m, f6_add(t, tt, f6_mul_v(t, tt))), f6_add(t, tt, tt))


def f12_conj(t, x):
    return x[:6] + [t.neg(v) for v in x[6:]]


def f12_inv(t, x):
    a0, a1 = split12(x)
    d = f6_sub(t, f6_mul(t, a0, a0), f6_mul_v(t, f6_mul(t, a1, a1)))
    dinv = f6_inv(t, d)
    return flat12(f6_mul(t, a0, dinv), [f2_neg(t, u) for u in f6_mul(t, a1, dinv)])


def f12_frobenius(t, x):
    """x^p (tower.f12_frobenius): every Fp2 component conjugated, components
    1 .. 5 times the constants of `tower._FROB12`."""
    g = frob_ints()
    comps = [(x[2 * i], t.neg(x[2 * i + 1])) for i in range(6)]
    out = [comps[0]] + [f2_mul(t, comps[k], (t.const(g[2 * k - 2]), t.const(g[2 * k - 1])))
                        for k in range(1, 6)]
    return [v for f2 in out for v in f2]


def f12_cyclotomic_sqr(t, x):
    """Granger-Scott squaring (tower.f12_cyclotomic_sqr): components in the
    tower's order are z0, z4, z3, z2, z1, z5."""
    z = [(x[2 * i], x[2 * i + 1]) for i in range(6)]
    a = [z[0], z[3], z[1]]
    b = [z[4], z[2], z[5]]
    sq = [f2_sqr(t, u) for u in a + b + [f2_add(t, u, v) for u, v in zip(a, b)]]
    t0, t1 = sq[0:3], sq[3:6]
    c0 = [f2_add(t, f2_mul_xi(t, t1[k]), t0[k]) for k in range(3)]
    c1 = [f2_sub(t, f2_sub(t, sq[6 + k], t0[k]), t1[k]) for k in range(3)]
    tm, tp = c0, [c1[0], c1[1], f2_mul_xi(t, c1[2])]
    d = [f2_sub(t, tm[k], z[k]) for k in range(3)] + [f2_add(t, tp[k], z[i])
                                                       for k, i in enumerate((4, 5, 3))]
    out = [f2_add(t, f2_add(t, dk, dk), e) for dk, e in zip(d, tm + tp)]
    return [v for k in (0, 1, 2, 5, 3, 4) for v in out[k]]


def embed_fp(t, x):
    return [x] + [t.zero] * 11


def embed_fp2(t, x):
    return list(x) + [t.zero] * 10


def untwist(t, xq, yq):
    """E'(Fp2) -> E(Fp12): (x w^-2, y w^-3), the constants' zeros dropped."""
    w2, w3 = w_inv_ints()
    return (f12_mul(t, embed_fp2(t, xq), [t.const(v) for v in w2]),
            f12_mul(t, embed_fp2(t, yq), [t.const(v) for v in w3]))


def line_step(t, f, xt, yt, xp, yp, q=None):
    """One Miller step (pairing._line_step): with q None the tangent at T
    (f <- f^2 l_{T,T}(P), T <- 2T), else the chord through T and Q
    (f <- f l_{T,Q}(P), T <- T + Q); P embedded, all points affine."""
    if q is None:
        f = f12_sqr(t, f)
        x2 = f12_sqr(t, xt)
        num, den, other_x = f12_add(t, f12_add(t, x2, x2), x2), f12_add(t, yt, yt), xt
    else:
        num, den, other_x = f12_sub(t, q[1], yt), f12_sub(t, q[0], xt), q[0]
    lam = f12_mul(t, num, f12_inv(t, den))
    ell = f12_sub(t, f12_sub(t, embed_fp(t, yp), yt), f12_mul(t, lam, f12_sub(t, embed_fp(t, xp),
                                                                             xt)))
    x3 = f12_sub(t, f12_sub(t, f12_mul(t, lam, lam), xt), other_x)
    y3 = f12_sub(t, f12_mul(t, lam, f12_sub(t, xt, x3)), yt)
    return f12_mul(t, f, ell), x3, y3


# ---------------------------------------------------------------------------------------
# layouts, scheduling and slot allocation
# ---------------------------------------------------------------------------------------


@dataclass
class Layout:
    """A kernel's fixed slots: slot 0 holds zero, then the constants, then
    the named regions in order; temporaries start at `temp_base`."""

    consts: list  # standard-form ints, each non-zero and distinct
    regions: list  # (name, size)
    zero: int = 0
    base: dict = field(default_factory=dict)
    temp_base: int = 0

    def __post_init__(self):
        at = 1 + len(self.consts)
        for name, size in self.regions:
            self.base[name] = at
            at += size
        self.temp_base = at

    def const_slot(self, v):
        return 1 + self.consts.index(v)

    def slot(self, name, i=0):
        size = dict(self.regions)[name]
        if not 0 <= i < size:
            raise IndexError(f"{name}[{i}] outside {size}")
        return self.base[name] + i

    def size(self, name):
        return dict(self.regions)[name]


@dataclass
class Program:
    """One scheduled program: `stages`, each a list of chains, each a list of
    (kind, dst, a, b) slot operations (an inverse: (INV, dst, a, a), alone
    in its stage); it uses slots below `slots`."""

    name: str
    stages: list
    slots: int


def _schedule(t, outs, halves):
    """Stages of chains of value ids computing every value `outs` needs."""
    need, stack = set(), list(outs)
    while stack:
        v = stack.pop()
        if v in need or not t.is_op(v):
            continue
        need.add(v)
        stack.extend(t.defs[v][1:])
    remaining = sorted(need)  # ids are in trace order, a topological order
    avail = {}  # value -> stage that writes it (leaves: -1)

    def ready_at(v, s):
        return not t.is_op(v) or avail.get(v, s) < s

    stages = []
    while remaining:
        s = len(stages)
        ready = [v for v in remaining if all(ready_at(a, s) for a in t.defs[v][1:])]
        assert ready, "the trace has a cycle"
        inv = [v for v in ready if t.defs[v][0] == INV]
        if inv:
            avail[inv[0]] = s
            stages.append([[inv[0]]])
            remaining.remove(inv[0])
            continue
        chains, load, owner = [[] for _ in range(halves)], [0.0] * halves, {}
        for v in sorted(ready, key=lambda v: -op_cost(t.defs[v][0])):
            c = min(range(halves), key=load.__getitem__)
            chains[c].append(v)
            load[c] += op_cost(t.defs[v][0])
            owner[v] = c
        budget = max(max(load), MIN_BUDGET) + 1e-9
        for v in remaining:  # trace order: a value's operands come before it
            kind, *args = t.defs[v]
            if v in owner or kind == INV:
                continue
            homes = set()
            for a in args:
                if ready_at(a, s):
                    continue
                homes.add(owner.get(a, -1))
            if len(homes) != 1 or -1 in homes:
                continue
            c = homes.pop()
            if load[c] + op_cost(kind) <= budget:
                chains[c].append(v)
                load[c] += op_cost(kind)
                owner[v] = c
        for v in owner:
            avail[v] = s
        remaining = [v for v in remaining if v not in owner]
        stages.append([ch for ch in chains if ch])
    return stages


def build(layout, name, fn, warps):
    """Trace fn(t) -> [(slot, value)] outputs, schedule it on a block of
    `warps` warps and give every value a slot. Returns the Program."""
    t = Trace(layout)
    outs = fn(t)
    halves = 2 * warps
    stages = _schedule(t, [v for _, v in outs], halves)
    def_stage = {v: s for s, st in enumerate(stages) for ch in st for v in ch}
    leaf_slot = {v: d[1] for v, d in enumerate(t.defs) if d[0] == "leaf"}
    last = {}
    for s, st in enumerate(stages):
        for ch in st:
            for v in ch:
                for a in t.defs[v][1:]:
                    last[a] = max(last.get(a, -1), s)
    # outputs: straight into the output slot where safe, else a copy in a last stage
    end = len(stages)
    slot_of, copies, pinned = dict(leaf_slot), [], set()
    for o, v in outs:
        if not t.is_op(v) and leaf_slot[v] != o:
            copies.append((o, v))
            last[v] = end  # a leaf another output copies keeps its slot to the end
    for o, v in outs:
        if not t.is_op(v):
            continue
        old = [u for u, sl in leaf_slot.items() if sl == o]
        if v not in pinned and all(last.get(u, -1) < def_stage[v] for u in old):
            slot_of[v] = o
            pinned.add(v)
        else:
            copies.append((o, v))
            last[v] = end
    # temporaries: the lowest slot free from the stage after the last reader
    free, busy, top = [], [], layout.temp_base
    for s, st in enumerate(stages):
        for u, at in [b for b in busy if b[1] < s]:
            free.append(slot_of[u])
        busy = [b for b in busy if b[1] >= s]
        free.sort()
        for ch in st:
            for v in ch:
                if v in slot_of:
                    continue
                if free:
                    slot_of[v] = free.pop(0)
                else:
                    slot_of[v] = top
                    top += 1
                busy.append((v, last[v]))
    ops = [[[(t.defs[v][0], slot_of[v], slot_of[t.defs[v][1]], slot_of[t.defs[v][2]])
             for v in ch] for ch in st] for st in stages]
    if copies:
        per = -(-len(copies) // halves)
        cp = [(ADD, o, slot_of[v], layout.zero) for o, v in copies]
        ops.append([cp[i:i + per] for i in range(0, len(cp), per)])
    for st in ops:
        _check_stage(st, halves)
    return Program(name, ops, top)


def _check_stage(stage, halves):
    """Chains of one stage run at once: none may write a slot that another
    reads or writes; a product never writes one of its operands; an inverse
    is alone in its stage; a stage has a chain a half-warp at most."""
    sets = []
    for chain in stage:
        reads, writes = set(), set()
        for kind, d, a, b in chain:
            assert kind not in (MUL, INV) or d not in (a, b), "a product writes its own operand"
            assert kind != INV or (len(stage) == 1 and len(chain) == 1), "an inverse shares"
            reads |= {a, b} - writes
            writes.add(d)
        sets.append((reads, writes))
    assert len(stage) <= halves
    for i, (_, wi) in enumerate(sets):
        for j, (rj, wj) in enumerate(sets):
            assert i == j or not (wi & (rj | wj)), f"chains {i} and {j} of a stage collide"


def cost(prog: Program):
    """The cost model's time of a program, in products: each stage's most
    loaded chain (an inverse: its FERMAT_BITS products) and a barrier."""
    total = 0.0
    for st in prog.stages:
        if st[0][0][0] == INV:
            total += FERMAT_BITS
        else:
            total += max(sum(op_cost(op[0]) for op in ch) for ch in st)
        total += BARRIER
    return total


def critical_products(prog: Program):
    """Dependent products on the program's critical path as the block runs
    it: per stage, the most products one chain runs (an inverse: its
    FERMAT_BITS dependent products)."""
    return sum(FERMAT_BITS if st[0][0][0] == INV else max(sum(op[0] == MUL for op in ch)
                                                           for ch in st) for st in prog.stages)


def products(prog: Program):
    """The Fp products a program needs (an inverse: the squarings and
    multiplies its exponent needs, FERMAT_BITS - 1 + popcount(p - 2) - 1)."""
    inv = FERMAT_BITS - 2 + bin(P - 2).count("1")
    return sum(inv if op[0] == INV else op[0] == MUL
               for st in prog.stages for ch in st for op in ch)


# ---------------------------------------------------------------------------------------
# the two kernels' layouts and programs
# ---------------------------------------------------------------------------------------


def _region_out(t, name, values):
    return [(t.layout.slot(name, i), v) for i, v in enumerate(values)]


def miller_layout():
    w2, w3 = w_inv_ints()
    consts = [1] + sorted({v for v in w2 + w3 if v})
    return Layout(consts, [("XP", 1), ("YP", 1), ("Q", 4), ("XQ", 12), ("YQ", 12),
                           ("F", 12), ("XT", 12), ("YT", 12), ("INV", 4)])


def _miller_init(t):
    xq, yq = untwist(t, (t.slot("Q", 0), t.slot("Q", 1)), (t.slot("Q", 2), t.slot("Q", 3)))
    one = [t.one] + [t.zero] * 11
    return (_region_out(t, "XQ", xq) + _region_out(t, "YQ", yq) + _region_out(t, "XT", xq)
            + _region_out(t, "YT", yq) + _region_out(t, "F", one))


def _miller_step(chord):
    def fn(t):
        q = (t.region("XQ"), t.region("YQ")) if chord else None
        f, x3, y3 = line_step(t, t.region("F"), t.region("XT"), t.region("YT"), t.slot("XP"),
                              t.slot("YP"), q)
        return _region_out(t, "F", f) + _region_out(t, "XT", x3) + _region_out(t, "YT", y3)
    return fn


def _miller_conj(t):
    return _region_out(t, "F", f12_conj(t, t.region("F")))


def final_layout():
    return Layout([1] + frob_ints(), [("ACC", 12), ("X", 12), ("T", 15 * 12), ("INV", 4)])


def _table_entry(t, m):
    return [t.slot("T", 12 * (m - 1) + i) for i in range(12)]


def _final_mul(t):
    return _region_out(t, "ACC", f12_mul(t, t.region("ACC"), t.region("X")))


def _final_easy(t):
    """The easy part into T[1]: f^((p^6 - 1)(p^2 + 1))."""
    f = t.region("ACC")
    f = f12_mul(t, f12_conj(t, f), f12_inv(t, f))
    f = f12_mul(t, f12_frobenius(t, f12_frobenius(t, f)), f)
    return [(t.layout.slot("T", i), v) for i, v in enumerate(f)]


def _final_table(t):
    """T[m] = prod_{i in m} f^(p^i) for m = 2 .. 15 from T[1] = f (the
    popcount levels of tower._subset_table)."""
    tab = {1: _table_entry(t, 1)}
    for i in (1, 2, 3):
        tab[1 << i] = f12_frobenius(t, tab[1 << (i - 1)])
    for bits in (2, 3, 4):
        for m in range(16):
            if bin(m).count("1") == bits:
                low = m & -m
                tab[m] = f12_mul(t, tab[m ^ low], tab[low])
    return [(t.layout.slot("T", 12 * (m - 1) + i), v)
            for m in range(2, 16) for i, v in enumerate(tab[m])]


def _final_cyc(t):
    return _region_out(t, "ACC", f12_cyclotomic_sqr(t, t.region("ACC")))


def _final_cyc_mul(t):
    return _region_out(t, "ACC", f12_mul(t, f12_cyclotomic_sqr(t, t.region("ACC")),
                                         t.region("X")))


MILLER_PROGRAMS = (("init", _miller_init), ("tangent", _miller_step(False)),
                   ("chord", _miller_step(True)), ("conj", _miller_conj))
FINAL_PROGRAMS = (("mul", _final_mul), ("easy", _final_easy), ("table", _final_table),
                  ("cyc", _final_cyc), ("cyc_mul", _final_cyc_mul))


@dataclass(frozen=True)
class Kernel:
    name: str
    layout: Layout
    programs: dict  # name -> Program, in the header's order
    warps: int

    @property
    def slots(self):
        return max(p.slots for p in self.programs.values())


_CACHE = {}


def _kernel(name, layout_fn, progs, warps):
    key = (name, warps)
    if key not in _CACHE:
        layout = layout_fn()
        _CACHE[key] = Kernel(name, layout, {n: build(layout, n, fn, warps) for n, fn in progs},
                             warps)
    return _CACHE[key]


def miller_kernel(warps=MILLER_WARPS) -> Kernel:
    return _kernel("Miller", miller_layout, MILLER_PROGRAMS, warps)


def final_kernel(warps=FINAL_WARPS) -> Kernel:
    return _kernel("Final", final_layout, FINAL_PROGRAMS, warps)


def hard_columns():
    """The joint ladder's bit columns of HARD_BASE_P, MSB first: column j
    has bit i set where bit (nbits - 1 - j) of digit i is."""
    from .pairing import HARD_BASE_P

    nbits = max(h.bit_length() for h in HARD_BASE_P)
    return [sum(((h >> (nbits - 1 - j)) & 1) << i for i, h in enumerate(HARD_BASE_P))
            for j in range(nbits)]


# ---------------------------------------------------------------------------------------
# the programs and the kernels' control flow on Python integers (Montgomery form)
# ---------------------------------------------------------------------------------------


def mont(v):
    return v % P * _MONT % P


def unmont(v):
    return v * _R_INV % P


def run(prog: Program, mem):
    """One program on `mem`, a list of Montgomery integers indexed by slot,
    chain after chain (the checks of `_check_stage` make that the kernel's
    order). The inverse runs the kernel's Fermat chain, LSB first."""
    for st in prog.stages:
        for ch in st:
            for kind, d, a, b in ch:
                if kind == MUL:
                    mem[d] = mem[a] * mem[b] * _R_INV % P
                elif kind == ADD:
                    mem[d] = (mem[a] + mem[b]) % P
                elif kind == SUB:
                    mem[d] = (mem[a] - mem[b]) % P
                else:
                    mem[d] = fermat(mem[a])


def fermat(a):
    """a^(p - 2) in Montgomery form by the kernel's chain: acc * base and
    base^2 each step, acc taking the product where the exponent's bit is 1."""
    acc, base, e = _MONT, a, P - 2
    for s in range(FERMAT_BITS):
        prod = acc * base * _R_INV % P
        base = base * base * _R_INV % P
        if e >> s & 1:
            acc = prod
    return acc


def fresh_memory(kernel: Kernel):
    mem = [0] * kernel.slots
    for i, v in enumerate(kernel.layout.consts):
        mem[1 + i] = mont(v)
    return mem


def _put(mem, kernel, name, values):
    base = kernel.layout.slot(name)
    mem[base:base + len(values)] = list(values)


def _get(mem, kernel, name, count=None):
    base = kernel.layout.slot(name)
    return mem[base:base + (kernel.layout.size(name) if count is None else count)]


def simulate_miller(xp, yp, xq, yq, skip=False):
    """The miller_loop kernel on one lane: xp, yp Montgomery ints, xq, yq
    pairs of them; returns the 12 Montgomery ints of f_{|x|,Q}(P)
    conjugated (Fp12 one where the lane is skipped)."""
    k = miller_kernel()
    if skip:
        return [_MONT] + [0] * 11
    mem = fresh_memory(k)
    _put(mem, k, "XP", [xp])
    _put(mem, k, "YP", [yp])
    _put(mem, k, "Q", list(xq) + list(yq))
    run(k.programs["init"], mem)
    for bit in LOOP_BITS:
        run(k.programs["tangent"], mem)
        if bit:
            run(k.programs["chord"], mem)
    run(k.programs["conj"], mem)
    return _get(mem, k, "F")


def _product(k, fs, skip):
    """The final_exp kernel's product mode up to the exponentiation: the
    slots with ACC = the product of the lanes not in `skip` (one if none)."""
    mem = fresh_memory(k)
    skip = skip or [False] * len(fs)
    first = True
    _put(mem, k, "ACC", [_MONT] + [0] * 11)
    for f, sk in zip(fs, skip):
        if sk:
            continue
        _put(mem, k, "ACC" if first else "X", f)
        if not first:
            run(k.programs["mul"], mem)
        first = False
    return mem


def simulate_product(fs, skip=None):
    """The product the final_exp kernel exponentiates in product mode."""
    k = final_kernel()
    return _get(_product(k, fs, skip), k, "ACC")


def simulate_program(kernel: Kernel, name, regions):
    """One program of `kernel` on fresh slots holding `regions` ({region:
    Montgomery ints}); returns the slots."""
    mem = fresh_memory(kernel)
    for region, values in regions.items():
        _put(mem, kernel, region, values)
    run(kernel.programs[name], mem)
    return mem


def region(kernel: Kernel, mem, name, count=None):
    return _get(mem, kernel, name, count)


def simulate_final_exp(fs, skip=None, product=True):
    """The final_exp kernel: fs a list of lanes, each 12 Montgomery ints.
    product=True: one block multiplies the lanes not in `skip` (Fp12 one if
    none) and exponentiates the product, returning one element; else every
    lane is exponentiated by a block of its own, returning a list."""
    if not product:
        return [simulate_final_exp([f]) for f in fs]
    k = final_kernel()
    mem = _product(k, fs, skip)
    run(k.programs["easy"], mem)
    run(k.programs["table"], mem)
    cols = hard_columns()
    _put(mem, k, "ACC", _get(mem, k, "T")[12 * (cols[0] - 1):12 * cols[0]])
    for m in cols[1:]:
        if m:
            _put(mem, k, "X", _get(mem, k, "T")[12 * (m - 1):12 * m])
            run(k.programs["cyc_mul"], mem)
        else:
            run(k.programs["cyc"], mem)
    return _get(mem, k, "ACC")


def tower_program(fn, arity=1):
    """A standalone program of one traced tower function over flat Fp12
    operands A (and B), result in C, on a layout that holds every constant
    the tower uses: for the tests, which run it with `run_tower`."""
    w2, w3 = w_inv_ints()
    consts = [1] + sorted(set(frob_ints()) | {v for v in w2 + w3 if v})
    layout = Layout(consts, [("A", 12), ("B", 12), ("C", 12), ("INV", 4)])

    def traced(t):
        args = [t.region("A"), t.region("B")][:arity]
        return _region_out(t, "C", fn(t, *args))

    return build(layout, getattr(fn, "__name__", "tower"), traced, FINAL_WARPS), layout


def run_tower(prog_layout, *operands):
    """Run a `tower_program` on flat Fp12 operands (12 Montgomery ints each)."""
    prog, layout = prog_layout
    mem = [0] * max(prog.slots, layout.temp_base)
    for i, v in enumerate(layout.consts):
        mem[1 + i] = mont(v)
    for name, vals in zip("AB", operands):
        base = layout.slot(name)
        mem[base:base + 12] = list(vals)
    run(prog, mem)
    return mem[layout.slot("C"):layout.slot("C") + 12]


# ---------------------------------------------------------------------------------------
# the header
# ---------------------------------------------------------------------------------------


def _render_kernel(k: Kernel) -> str:
    ops, chains, stages, progs = [], [0], [0], [0]
    for prog in k.programs.values():
        for st in prog.stages:
            for ch in st:
                ops.extend(ch)
                chains.append(len(ops))
            stages.append(len(chains) - 1)
        progs.append(len(stages) - 1)
    tag = k.name

    def rows(items, per):
        return "\n".join("    " + " ".join(items[i:i + per]) for i in range(0, len(items), per))

    summary = [f"//   {n}: {len(p.stages)} stages, {sum(len(c) for s in p.stages for c in s)} "
               f"operations, {products(p)} products, {critical_products(p)} on the critical path"
               for n, p in k.programs.items()]
    lay = k.layout
    return "\n".join([
        f"// {tag}: {len(stages) - 1} stages, {len(chains) - 1} chains, {len(ops)} operations, "
        f"{k.slots} slots:",
        *summary,
        f"static __device__ const unsigned long long k{tag}Ops[{len(ops)}] = {{",
        rows([f"0x{kd | d << 16 | a << 32 | b << 48:x}ull," for kd, d, a, b in ops], 4),
        "};",
        f"static __device__ const uint32_t k{tag}Chains[{len(chains)}] = {{",
        rows([f"{v}," for v in chains], 12),
        "};",
        f"static __device__ const uint32_t k{tag}Stages[{len(stages)}] = {{",
        rows([f"{v}," for v in stages], 12),
        "};",
        f"static __device__ const uint32_t k{tag}Programs[{len(progs)}] = {{",
        rows([f"{v}," for v in progs], 12),
        "};",
        f"struct {tag}Prog {{",
        f"  static constexpr int kWarps = {k.warps}, kSlots = {k.slots}, "
        f"kConsts = {len(lay.consts)};",
        "  static constexpr int kZero = 0, kConst = 1, "
        + ", ".join(f"k{n} = {lay.base[n]}" for n, _ in lay.regions) + ";",
        "  static constexpr int " + ", ".join(f"kProg{n.title().replace('_', '')} = {i}"
                                              for i, n in enumerate(k.programs)) + ";",
        f"  __device__ static __forceinline__ unsigned long long op(int i) "
        f"{{ return k{tag}Ops[i]; }}",
        f"  __device__ static __forceinline__ int chain(int i) {{ return k{tag}Chains[i]; }}",
        f"  __device__ static __forceinline__ int stage(int i) {{ return k{tag}Stages[i]; }}",
        f"  __device__ static __forceinline__ int program(int i) {{ return k{tag}Programs[i]; }}",
        "};",
    ])


def render(miller_warps=MILLER_WARPS, final_warps=FINAL_WARPS) -> str:
    return "\n".join([
        "// The programs of the pairing kernels (csrc/pairing.cuh): the Miller loop's",
        "// untwist, tangent step, chord step and conjugation, and the final",
        "// exponentiation's product, easy part, subset table, cyclotomic squaring and",
        "// ladder step, as stages of chains of Fp operations on shared-memory slots of",
        "// 16 words.",
        "// Generated by `python -m kzg_tpu_torch.pairing.schedule --write`",
        "// from kzg_tpu_torch/pairing/schedule.py; do not edit.",
        "//",
        "// An operation is kind | dst << 16 | a << 32 | b << 48, slots dst = a (kind) b:",
        f"// kind {MUL} product, {ADD} add, {SUB} sub (mod p), {INV} inverse (dst = a^(p - 2),",
        "// alone in its stage). Chain i is operations [Chains[i], Chains[i + 1]), run by",
        "// half-warp i - Stages[s] of the block; stage s is chains [Stages[s],",
        "// Stages[s + 1]); program g is stages [Programs[g], Programs[g + 1]).",
        "",
        "#pragma once",
        "",
        "#include <cstdint>",
        "",
        "namespace {",
        "",
        f"constexpr unsigned long long kMillerLoop = 0x{-BLS_X:x}ull;  // |x|",
        f"constexpr int kMillerLoopBits = {(-BLS_X).bit_length()};",
        f"constexpr int kFermatBits = {FERMAT_BITS};  // p - 2",
        "",
        _render_kernel(miller_kernel(miller_warps)),
        "",
        _render_kernel(final_kernel(final_warps)),
        "",
        "}  // namespace",
        "",
    ])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Print or write the pairing kernels' header.")
    ap.add_argument("--write", action="store_true", help=f"write {HEADER.name} in csrc/")
    ap.add_argument("--stats", action="store_true", help="print each program's size and cost")
    args = ap.parse_args(argv)
    if args.stats:
        for k in (miller_kernel(), final_kernel()):
            print(f"{k.name}: {k.slots} slots ({k.slots * 64} B)")
            for n, p in k.programs.items():
                nops = sum(len(c) for s in p.stages for c in s)
                print(f"  {n}: {len(p.stages)} stages, {nops} operations, {products(p)} "
                      f"products, critical {critical_products(p)}, cost {cost(p):.1f}")
        return 0
    text = render()
    if args.write:
        HEADER.write_text(text)
    else:
        print(text, end="")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
