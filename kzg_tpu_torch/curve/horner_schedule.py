"""The program that kernel K4 (`csrc/horner.cuh`) runs for one doubling and
one addition, the digit ladder (`csrc/ladder.cuh`) for one doubling and
one mixed addition, and K2's narrow mode (`csrc/pointwise.cuh`) for one
addition or one doubling, as tables of field operations, and their header.

K4 is one block that walks the Horner chain of the window join; the ladder
kernel runs two lanes of the digit ladder a block on the same engine (one a
half-warp), and K2's narrow mode two points a block. The warps share the point in shared memory; each warp runs one
CHAIN of field operations at a time (a Montgomery product or a modular
add / sub, each spread over 16 lanes a word a lane), and a block barrier
separates the STAGES. A stage's chains are independent, so they run side by
side: the products of one level of dbl-2009-l, add-2007-bl or madd-2007-bl,
and over Fp2 the three Karatsuba products of each Fp2 product.

The formulas are written here at the level of a coordinate (Fp for G1,
Fp2 for G2) as stages of chains; `expand` lowers them to Fp operations on
numbered shared-memory slots. Over Fp a coordinate chain is one Fp chain,
linear steps before and after its product included. Over Fp2:

  * a chain that starts with a square a^2 becomes two Fp chains, c0 =
    (a0 + a1)(a0 - a1) and c1 = 2 a0 a1, each followed by its component of
    the chain's linear tail;
  * a chain that starts with a product a b becomes three Fp chains, a0 b0,
    a1 b1 and (a0 + a1)(b0 + b1), then, after a barrier, two chains c0 =
    a0 b0 - a1 b1 and c1 = (a0 + a1)(b0 + b1) - a0 b0 - a1 b1, each with its
    component of the tail;
  * a linear chain becomes one Fp chain a component.

Every value is canonical in [0, p), so any correct formula gives the same
words: the program equals the plain twins (`CurveOps.window_join`, the
rounds of `CurveOps.scalar_mul_digits`, `CurveOps.add` / `dbl`) word for
word, which `simulate_join`, `simulate_ladder`, `simulate_add` and
`simulate_dbl` check on the CPU with Python integers.

Regenerate the header after a change here:

    python -m kzg_tpu_torch.curve.horner_schedule --write
"""

import argparse
from dataclasses import dataclass
from pathlib import Path

from ..constants import P

MUL, ADD, SUB = 0, 1, 2
_KINDS = {"mul": MUL, "sqr": MUL, "add": ADD, "sub": SUB}
HEADER = Path(__file__).resolve().parent.parent / "csrc" / "horner_schedule.cuh"
# Warps of the K4 block: over Fp the most chains of a stage (4, three
# stages of the addition); over Fp2 those of the doubling's widest stage
# (7), so that only the addition's second stage (12) takes two rounds.
WARPS = {1: 4, 2: 8}

# (op, dst, a[, b]) at the coordinate level. The accumulator is (X, Y, Z),
# the window sum (X2, Y2, Z2), the addition's result (X3, Y3, Z3); H and R
# are read by the kernel for the addition's exceptional cases. The two
# groups take different, equal formulas: over Fp a chain may run linear
# steps before its product (one warp runs it all), so G1 folds the linear
# stages into the chains around them; over Fp2 a product is split over
# three warps, so a chain starts with its product, and G2 keeps the
# formulas as point.cuh writes them.
DBL_G2 = [  # dbl-2009-l, a = 0, in place on (X, Y, Z)
    [[("sqr", "A", "X"), ("add", "E", "A", "A"), ("add", "E", "E", "A")],
     [("sqr", "B", "Y"), ("add", "XB", "X", "B")],
     [("mul", "YZ", "Y", "Z"), ("add", "Z", "YZ", "YZ")]],
    [[("sqr", "C", "B"), ("add", "C8", "C", "C"), ("add", "C8", "C8", "C8"),
      ("add", "C8", "C8", "C8")],
     [("sqr", "T", "XB")],
     [("sqr", "F", "E")]],
    [[("sub", "D", "T", "A"), ("sub", "D", "D", "C"), ("add", "D", "D", "D"),
      ("add", "D2", "D", "D"), ("sub", "X", "F", "D2"), ("sub", "DX", "D", "X")]],
    [[("mul", "YP", "E", "DX"), ("sub", "Y", "YP", "C8")]],
]
DBL_G1 = [  # the same with D = 2((X + B)^2 - A - C) = 4 X B and 8 C = 2 (2 B)^2
    [[("sqr", "A", "X"), ("add", "E", "A", "A"), ("add", "E", "E", "A")],
     [("sqr", "B", "Y"), ("add", "B2", "B", "B"), ("add", "B4", "B2", "B2")],
     [("mul", "YZ", "Y", "Z"), ("add", "Z", "YZ", "YZ")]],
    [[("sqr", "C4", "B2"), ("add", "C8", "C4", "C4")],
     [("mul", "D", "X", "B4"), ("add", "D2", "D", "D")],
     [("sqr", "F", "E")]],
    [[("sub", "X", "F", "D2"), ("sub", "DX", "D", "X"), ("mul", "YP", "E", "DX"),
      ("sub", "Y", "YP", "C8")]],
]
# add-2007-bl, (X, Y, Z) + (X2, Y2, Z2) -> (X3, Y3, Z3), with
# (Z1 + Z2)^2 - Z1^2 - Z2^2 = 2 Z1 Z2
ADD_G2 = [
    [[("sqr", "Z1Z1", "Z")],
     [("sqr", "Z2Z2", "Z2")],
     [("mul", "ZZ", "Z", "Z2"), ("add", "ZZ", "ZZ", "ZZ")]],
    [[("mul", "U1", "X", "Z2Z2")],
     [("mul", "U2", "X2", "Z1Z1")],
     [("mul", "T1", "Z2", "Z2Z2")],
     [("mul", "T2", "Z", "Z1Z1")]],
    [[("mul", "S1", "Y", "T1")],
     [("mul", "S2", "Y2", "T2")],
     [("sub", "H", "U2", "U1"), ("add", "HH", "H", "H")]],
    [[("sqr", "I", "HH")],
     [("mul", "Z3", "ZZ", "H")],
     [("sub", "R", "S2", "S1"), ("add", "R", "R", "R")]],
    [[("mul", "J", "H", "I")],
     [("mul", "V", "U1", "I")],
     [("sqr", "RR", "R")]],
    [[("add", "V2", "V", "V"), ("sub", "X3", "RR", "J"), ("sub", "X3", "X3", "V2"),
      ("sub", "VX", "V", "X3")],
     [("mul", "S1J", "S1", "J"), ("add", "S1J", "S1J", "S1J")]],
    [[("mul", "RY", "R", "VX"), ("sub", "Y3", "RY", "S1J")]],
]
ADD_G1 = ADD_G2[:3] + [  # the same with s1 j = (s1 h) i, and the last two stages one chain
    [[("sqr", "I", "HH")],
     [("mul", "Z3", "ZZ", "H")],
     [("sub", "R", "S2", "S1"), ("add", "R", "R", "R")],
     [("mul", "S1H", "S1", "H")]],
    [[("mul", "J", "H", "I")],
     [("mul", "V", "U1", "I")],
     [("sqr", "RR", "R")],
     [("mul", "S1J", "S1H", "I"), ("add", "S1J", "S1J", "S1J")]],
    [[("add", "V2", "V", "V"), ("sub", "X3", "RR", "J"), ("sub", "X3", "X3", "V2"),
      ("sub", "VX", "V", "X3"), ("mul", "RY", "R", "VX"), ("sub", "Y3", "RY", "S1J")]],
]
# madd-2007-bl, (X, Y, Z) + affine (X2, Y2) -> (X3, Y3, Z3), with
# (Z1 + H)^2 - Z1^2 - H^2 = 2 Z1 H and Y1 J = (Y1 H) I; H and R as in the
# addition, for its exceptional cases. Over Fp the last stage is one chain.
MADD_G2 = [
    [[("sqr", "Z1Z1", "Z")]],
    [[("mul", "U2", "X2", "Z1Z1"), ("sub", "H", "U2", "X")],
     [("mul", "ZZZ", "Z", "Z1Z1")]],
    [[("sqr", "HH", "H"), ("add", "I", "HH", "HH"), ("add", "I", "I", "I")],
     [("mul", "S2", "Y2", "ZZZ"), ("sub", "R", "S2", "Y"), ("add", "R", "R", "R")],
     [("mul", "Z3", "Z", "H"), ("add", "Z3", "Z3", "Z3")],
     [("mul", "YH", "Y", "H")]],
    [[("mul", "J", "H", "I")],
     [("mul", "V", "X", "I")],
     [("sqr", "RR", "R")],
     [("mul", "YJ", "YH", "I"), ("add", "YJ", "YJ", "YJ")]],
    [[("add", "V2", "V", "V"), ("sub", "X3", "RR", "J"), ("sub", "X3", "X3", "V2"),
      ("sub", "VX", "V", "X3")]],
    [[("mul", "RY", "R", "VX"), ("sub", "Y3", "RY", "YJ")]],
]
MADD_G1 = MADD_G2[:4] + [[MADD_G2[4][0] + MADD_G2[5][0]]]
PROGRAMS = {1: (DBL_G1, ADD_G1, MADD_G1), 2: (DBL_G2, ADD_G2, MADD_G2)}
NAMED = ("X", "Y", "Z", "X2", "Y2", "Z2", "X3", "Y3", "Z3", "H", "R")
_TEMPS_PER_CHAIN = 5  # Fp2 lowering: a0 + a1, a0 - a1 or b0 + b1, a0 b0, a1 b1, the third product


@dataclass(frozen=True)
class Program:
    """One group's lowered program. `stages` is a list of stages, each a
    list of chains, each a list of (kind, dst, a, b) Fp slot operations;
    the doubling is stages [0, dbl_end), the addition [dbl_end, len). The
    mixed addition of the digit ladder is `madd`, stages on the same slots
    (the header lists them after the addition's)."""

    ncomp: int
    warps: int
    slots: dict  # coordinate name -> first slot (component c at + c)
    nslots: int
    stages: list
    dbl_end: int
    madd: list


def _names(progs):
    names = list(NAMED)
    for prog in progs:
        for stage in prog:
            for chain in stage:
                for step in chain:
                    for n in step[1:]:
                        if n not in names:
                            names.append(n)
    return names


def _lower_stage(stage, ncomp, slot, temps):
    """One coordinate-level stage -> one or two Fp stages."""
    if ncomp == 1:
        return [[[(_KINDS[op], slot[d], slot[a], slot[b[0] if b else a])
                  for op, d, a, *b in chain] for chain in stage]]

    def comp(name, c):
        return slot[name] + c

    def tail(steps, c):
        return [(_KINDS[op], comp(d, c), comp(a, c), comp(b, c)) for op, d, a, b in steps]

    first, second = [], []
    for k, chain in enumerate(stage):
        assert all(op in ("add", "sub") for op, *_ in chain[1:]), "an Fp2 chain's product leads"
        t_s, t_d, t_ac, t_bd, t_st = (temps + _TEMPS_PER_CHAIN * k + i for i in range(5))
        op, d, a, *b = chain[0]
        if op == "sqr":
            first.append([(ADD, t_s, comp(a, 0), comp(a, 1)), (SUB, t_d, comp(a, 0), comp(a, 1)),
                          (MUL, comp(d, 0), t_s, t_d)] + tail(chain[1:], 0))
            first.append([(MUL, t_ac, comp(a, 0), comp(a, 1)), (ADD, comp(d, 1), t_ac, t_ac)]
                         + tail(chain[1:], 1))
        elif op == "mul":
            b = b[0]
            first.append([(MUL, t_ac, comp(a, 0), comp(b, 0))])
            first.append([(MUL, t_bd, comp(a, 1), comp(b, 1))])
            first.append([(ADD, t_s, comp(a, 0), comp(a, 1)), (ADD, t_d, comp(b, 0), comp(b, 1)),
                          (MUL, t_st, t_s, t_d)])
            second.append([(SUB, comp(d, 0), t_ac, t_bd)] + tail(chain[1:], 0))
            second.append([(SUB, comp(d, 1), t_st, t_ac), (SUB, comp(d, 1), comp(d, 1), t_bd)]
                          + tail(chain[1:], 1))
        else:
            first.extend(tail(chain, c) for c in range(2))
    return [first] + ([second] if second else [])


def _check_stage(stage):
    """Chains of one stage run at once: no chain may write a slot that
    another reads or writes; a product never writes one of its operands."""
    sets = []
    for chain in stage:
        reads, writes = set(), set()
        for kind, d, a, b in chain:
            assert kind != MUL or d not in (a, b), "a product writes its own operand"
            reads |= {a, b}
            writes.add(d)
        sets.append((reads, writes))
    for i, (_, wi) in enumerate(sets):
        for j, (rj, wj) in enumerate(sets):
            assert i == j or not (wi & (rj | wj)), f"chains {i} and {j} of a stage collide"


def expand(ncomp: int) -> Program:
    """The doubling, the addition and the mixed addition lowered to Fp slot
    operations for G1 (ncomp = 1) or G2 (ncomp = 2)."""
    dbl, add, madd = PROGRAMS[ncomp]
    names = _names((dbl, add, madd))
    slot = {n: ncomp * i for i, n in enumerate(names)}
    temps = ncomp * len(names)
    widest = max(len(s) for s in dbl + add + madd)
    nslots = temps + (_TEMPS_PER_CHAIN * widest if ncomp == 2 else 0)

    def lower(prog):
        return [fp for stage in prog for fp in _lower_stage(stage, ncomp, slot, temps)]

    stages = lower(dbl)
    dbl_end = len(stages)
    stages += lower(add)
    madd_stages = lower(madd)
    for stage in stages + madd_stages:
        _check_stage(stage)
    assert nslots < 256
    return Program(ncomp, WARPS[ncomp], slot, nslots, stages, dbl_end, madd_stages)


def critical_products(prog: Program, which: str) -> int:
    """Dependent products on the critical path of the doubling ("dbl"), the
    addition ("add") or the mixed addition ("madd") as the block runs it:
    per stage, the most products one warp runs when chain k goes to warp k
    mod warps."""
    stages = {"dbl": prog.stages[:prog.dbl_end], "add": prog.stages[prog.dbl_end:],
              "madd": prog.madd}[which]
    total = 0
    for stage in stages:
        per_warp = [0] * prog.warps
        for k, chain in enumerate(stage):
            per_warp[k % prog.warps] += sum(op[0] == MUL for op in chain)
        total += max(per_warp)
    return total


# ---- the program on Python integers (Montgomery words, as the kernel) -----------------

_R_INV = pow(1 << 384, -1, P)
_ONE = (1 << 384) % P


def _run(stages, mem):
    for stage in stages:
        for chain in stage:
            for kind, d, a, b in chain:
                if kind == MUL:
                    mem[d] = mem[a] * mem[b] * _R_INV % P
                elif kind == ADD:
                    mem[d] = (mem[a] + mem[b]) % P
                else:
                    mem[d] = (mem[a] - mem[b]) % P


class _Slots:
    """The shared-memory slots of one point (one block lane) on Python
    integers: named coordinates, each a tuple of ncomp Montgomery integers."""

    def __init__(self, prog: Program):
        self.prog = prog
        self.mem = [0] * prog.nslots
        self.one = (_ONE,) + (0,) * (prog.ncomp - 1)
        self.nil = (0,) * prog.ncomp

    def coord(self, name):
        base = self.prog.slots[name]
        return tuple(self.mem[base + i] for i in range(self.prog.ncomp))

    def put(self, name, value):
        for i, v in enumerate(value):
            self.mem[self.prog.slots[name] + i] = v

    def zero(self, name):
        return not any(self.coord(name))

    def point(self, names="XYZ"):
        return tuple(self.coord(n) for n in names)

    def set_point(self, value, names="XYZ"):
        for n, v in zip(names, value):
            self.put(n, v)

    def set_infinity(self):
        self.set_point((self.one, self.one, self.nil))

    def run(self, which):
        p = self.prog
        _run({"dbl": p.stages[:p.dbl_end], "add": p.stages[p.dbl_end:], "madd": p.madd}[which],
             self.mem)


def simulate_join(prog: Program, sums, c: int):
    """K4's control flow and program on Python integers. sums: W window
    sums, each (x, y, z) with every coordinate a tuple of ncomp Montgomery
    integers; returns the joined point in the same form."""
    m = _Slots(prog)
    m.set_infinity()
    for w in reversed(range(len(sums))):
        for _ in range(c):
            if not m.zero("Z"):
                m.run("dbl")
        m.set_point(sums[w], ("X2", "Y2", "Z2"))
        if m.zero("Z"):
            m.set_point(m.point(("X2", "Y2", "Z2")))
        elif not m.zero("Z2"):
            m.run("add")
            if not m.zero("H"):
                m.set_point(m.point(("X3", "Y3", "Z3")))
            elif m.zero("R"):
                m.run("dbl")
            else:
                m.set_infinity()
    return m.point()


def simulate_ladder(prog: Program, entries, digits, p_inf: bool, c: int):
    """The ladder kernel's control flow and program on Python integers, one
    lane: W rounds (digits MSB first) of c doublings (infinity included, as
    the twin) and one mixed addition of table entry digit - 1, skipped where
    the digit is 0 or p is infinite. entries: the 2^c - 1 affine multiples
    (x, y), each coordinate a tuple of ncomp Montgomery integers; returns
    the Jacobian (X, Y, Z) in the same form."""
    m = _Slots(prog)
    m.set_infinity()
    for d in digits:
        for _ in range(c):
            m.run("dbl")
        if d == 0 or p_inf:
            continue
        m.put("X2", entries[d - 1][0])
        m.put("Y2", entries[d - 1][1])
        if m.zero("Z"):  # infinity + Q = (x2, y2, 1)
            m.set_point((m.coord("X2"), m.coord("Y2"), m.one))
            continue
        m.run("madd")
        if not m.zero("H"):
            m.set_point(m.point(("X3", "Y3", "Z3")))
        elif m.zero("R"):
            m.run("dbl")  # P == Q: dbl(P)
        else:
            m.set_infinity()  # P == -Q
    return m.point()


def simulate_add(prog: Program, ps, qs):
    """The narrow K2 add's control flow and program (csrc/pointwise.cuh) on
    Python integers, for the points of one block (at most two): ps[h] +
    qs[h], each a Jacobian (X, Y, Z) with every coordinate a tuple of ncomp
    Montgomery integers. The block runs the addition's stages on every point
    when any of them adds, then the doubling on the points with P == Q
    alone; each point takes its result from the slots its own case names.
    Returns the sums in the same form."""
    assert 1 <= len(ps) == len(qs) <= 2
    block = [_Slots(prog) for _ in ps]
    src = []
    for m, p, q in zip(block, ps, qs):
        m.set_point(p)
        m.set_point(q, ("X2", "Y2", "Z2"))
        src.append("q" if m.zero("Z") else "p" if m.zero("Z2") else "sum")
    if "sum" in src:
        for m in block:
            m.run("add")
        same = [s == "sum" and m.zero("H") and m.zero("R") for m, s in zip(block, src)]
        src = [("p" if m.zero("R") else "inf") if s == "sum" and m.zero("H") else s
               for m, s in zip(block, src)]
        for m, d in zip(block, same):
            if d:
                m.run("dbl")  # P == Q: dbl(P) in place, on this point's half alone
    names = {"p": ("X", "Y", "Z"), "q": ("X2", "Y2", "Z2"), "sum": ("X3", "Y3", "Z3")}
    return [(m.one, m.one, m.nil) if s == "inf" else m.point(names[s])
            for m, s in zip(block, src)]


def simulate_dbl(prog: Program, ps):
    """The narrow K2 dbl (csrc/pointwise.cuh) on Python integers: the
    doubling's stages on every point, infinity included, as the twin."""
    out = []
    for p in ps:
        m = _Slots(prog)
        m.set_point(p)
        m.run("dbl")
        out.append(m.point())
    return out


# ---- the header ------------------------------------------------------------------------

def _render_group(tag: str, prog: Program) -> str:
    ops, chains, stages = [], [0], [0]
    for stage in prog.stages + prog.madd:
        for chain in stage:
            ops.extend(chain)
            chains.append(len(ops))
        stages.append(len(chains) - 1)
    s = prog.slots

    def rows(items, per):
        return "\n".join("    " + " ".join(items[i:i + per]) for i in range(0, len(items), per))

    return "\n".join([
        f"// {tag}: {len(prog.stages) + len(prog.madd)} stages ({prog.dbl_end} of the doubling, "
        f"{len(prog.stages) - prog.dbl_end} of the addition,",
        f"// {len(prog.madd)} of the mixed addition), {len(chains) - 1} chains, "
        f"{len(ops)} operations.",
        f"static __constant__ uint32_t kHorner{tag}Ops[{len(ops)}] = {{",
        rows([f"0x{k | d << 8 | a << 16 | b << 24:08x}u," for k, d, a, b in ops], 6),
        "};",
        f"static __constant__ uint16_t kHorner{tag}Chains[{len(chains)}] = {{",
        rows([f"{v}," for v in chains], 16),
        "};",
        f"static __constant__ uint16_t kHorner{tag}Stages[{len(stages)}] = {{",
        rows([f"{v}," for v in stages], 16),
        "};",
        f"struct HornerProg{tag} {{",
        f"  static constexpr int kComp = {prog.ncomp}, kWarps = {prog.warps}, "
        f"kSlots = {prog.nslots};",
        f"  static constexpr int kDblEnd = {prog.dbl_end}, kAddEnd = {len(prog.stages)}, "
        f"kMaddEnd = {len(prog.stages) + len(prog.madd)};",
        "  static constexpr int " + ", ".join(f"k{n} = {s[n]}" for n in NAMED) + ";",
        f"  __device__ static __forceinline__ uint32_t op(int i) {{ return kHorner{tag}Ops[i]; }}",
        f"  __device__ static __forceinline__ int chain(int i) {{ return kHorner{tag}Chains[i]; }}",
        f"  __device__ static __forceinline__ int stage(int i) {{ return kHorner{tag}Stages[i]; }}",
        "};",
    ])


def render() -> str:
    return "\n".join([
        "// The programs of K4, of the digit ladder and of K2's narrow mode: dbl-2009-l,",
        "// add-2007-bl and madd-2007-bl as stages of chains of Fp operations on",
        "// shared-memory slots of 16 words (see horner.cuh, ladder.cuh, pointwise.cuh).",
        "// Generated by `python -m kzg_tpu_torch.curve.horner_schedule --write`",
        "// from kzg_tpu_torch/curve/horner_schedule.py; do not edit.",
        "//",
        f"// An operation is kind | dst << 8 | a << 16 | b << 24, slots dst = a (kind) b:",
        f"// kind {MUL} product, {ADD} add, {SUB} sub (mod p).",
        "// Chain i is operations [Chains[i], Chains[i + 1]); stage s is chains",
        "// [Stages[s], Stages[s + 1]).",
        "",
        "#pragma once",
        "",
        "#include <cstdint>",
        "",
        "namespace {",
        "",
        _render_group("G1", expand(1)),
        "",
        _render_group("G2", expand(2)),
        "",
        "}  // namespace",
        "",
    ])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Print or write the K4 / ladder / K2 program header.")
    ap.add_argument("--write", action="store_true", help=f"write {HEADER.name} in csrc/")
    args = ap.parse_args(argv)
    text = render()
    if args.write:
        HEADER.write_text(text)
    else:
        print(text, end="")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
