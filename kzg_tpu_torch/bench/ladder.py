"""Inputs for the digit ladder kernel, and the ladder kernel and K1's Fermat
chain kernel against the launch chains they replaced, on one NVIDIA GPU.

    python3 -m kzg_tpu_torch.bench.ladder [--out JSON]

`host_table`, `jacobian_points` and `edge_case` build ladder inputs from the
host's oracle points (the CPU tests, `tests/test_torch_cuda.py` and
`chip_smoke.py` hold the kernel and its twin to them); `random_ladder`
gives full-size random inputs for timing.

The bench times, in turns and with the same inputs (CUDA events, and the
host's clock closed by a synchronize):
  * the ladder kernel (`cuda_ops.ladder`, one launch) against the per-op
    route it replaced (the rounds of `CurveOps.scalar_mul_digits` on K2
    `dbl` and K6 `madd`, W (c + 1) launches), over G1 and G2 at 2,048,
    4,096 and 16,384 lanes, c = 4, W = 64 (the group iNTT's shapes at
    d = 2^12 and 2^15);
  * `field_pow` (one launch) against the chain of K1 products it replaced,
    for Fr and Fp at 1 and 16 elements, e = m - 2 (an inverse).
It checks that each pair gives the same words, prints the card's name and
power limit and writes the rows to JSON (default build/ladder_bench.json).
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from ..constants import P, R
from ..curve import G1, G2, cuda_ops
from ..curve.ops import CurveOps
from ..fields import FP, FR, cuda_field
from ..oracle import ec_add, ec_mul, ec_neg, g1_generator, g2_generator
from ..oracle.field import Fp2
from . import peaks
from .horner import _jacobian, _to_tensor

SEED = 20260407
LANES = (2048, 4096, 16384)
C, WINDOWS = 4, 64  # config.group_ladder_window's default, ceil(255 / 4)


def _gen(group):
    return g1_generator() if group == "g1" else g2_generator()


def _mul(pt, k):
    """k pt for any integer k (negative: the negation)."""
    k %= R
    return None if k == 0 else ec_mul(pt, k)


def host_table(group: str, pts, c: int, device=None):
    """(tx, ty): the affine multiples 1 .. 2^c - 1 of each oracle point
    (None: infinity, whose entries are never read and are set to one), as
    (12, T, lanes) Montgomery words for G1, (12, 2, T, lanes) for G2."""
    t_count = (1 << c) - 1
    one = 1 if group == "g1" else (1, 0)
    cols = ([], [])
    for t in range(t_count):
        for pt in pts:
            q = None if pt is None else _mul(pt, t + 1)
            for k in range(2):
                if q is None:
                    cols[k].append(one)
                elif group == "g1":
                    cols[k].append(q[k].n)
                else:
                    cols[k].append((q[k].a.n, q[k].b.n))
    lead = (FP.W,) if group == "g1" else (FP.W, 2)
    return tuple(_to_tensor(group, col, device).reshape(lead + (t_count, len(pts)))
                 for col in cols)


def jacobian_points(group: str, pts, rs: np.random.Generator, device=None):
    """Oracle points (None: infinity) as a Jacobian batch at random Z."""

    def rand():
        return int.from_bytes(rs.bytes(48), "little") % (P - 1) + 1

    if group == "g1":
        coords = [_jacobian(group, pt, rand(), (1, 1)) for pt in pts]
    else:
        coords = [_jacobian(group, pt, Fp2.from_ints(rand(), rand()), ((1, 0), (1, 0)))
                  for pt in pts]
    return tuple(_to_tensor(group, col, device) for col in zip(*coords))


def random_points(group: str, lanes: int, rs: np.random.Generator):
    return [ec_mul(_gen(group), int.from_bytes(rs.bytes(40), "little") % (R - 1) + 1)
            for _ in range(lanes)]


def ladder_value(digits, c: int, multiples=None) -> list:
    """Per lane, the scalar the ladder forms: sum_w m(d_w) 2^(c (W - 1 - w)),
    with m(d) = d, or `multiples[d - 1]` where the table holds other
    multiples of the lane's point (m(0) = 0)."""
    d = np.asarray(digits)
    out = []
    for lane in range(d.shape[1]):
        k = 0
        for w in range(d.shape[0]):
            v = int(d[w, lane])
            k = (k << c) + (0 if v == 0 else (v if multiples is None else multiples[v - 1]))
        out.append(k)
    return out


# The edge cases, c = 2, W = 2, entries (A, 4 A, -4 A) of a random point A a
# lane: digits (MSB window first) -> what the ladder meets.
EDGE_DIGITS = {
    "same": (1, 2),        # acc = 4 A after the doublings, entry 4 A: P == Q, dbl -> 8 A
    "opposite": (1, 3),    # acc = 4 A, entry -4 A: P == -Q -> infinity
    "zero": (0, 0),        # every round skipped: infinity
    "p_inf": (1, 2),       # the lane's point is infinite: every round skipped
    "generic": (2, 1),     # 4 (4 A) + A = 17 A
    "inf_plus_q": (0, 1),  # the accumulator is infinity when the entry comes: (x2, y2, 1)
    "minus": (3, 0),       # 4 (-4 A) = -16 A
}
EDGE_MULTIPLES = (1, 4, -4)


def edge_case(group: str, device=None, seed: int = SEED):
    """(tx, ty, p_inf, digits, c, want): the edge cases of EDGE_DIGITS, one
    lane each, with the oracle's expected points (None: infinity)."""
    rs = np.random.default_rng([seed, int(group == "g2")])
    base = random_points(group, len(EDGE_DIGITS), rs)
    cols = ([], [])
    for m in EDGE_MULTIPLES:
        for a in base:
            q = _mul(a, m)
            for k in range(2):
                cols[k].append(q[k].n if group == "g1" else (q[k].a.n, q[k].b.n))
    lead = (FP.W,) if group == "g1" else (FP.W, 2)
    lanes = len(EDGE_DIGITS)
    tx, ty = (_to_tensor(group, col, device).reshape(lead + (3, lanes)) for col in cols)
    digits = torch.tensor(list(zip(*EDGE_DIGITS.values())), dtype=torch.int32, device=device)
    p_inf = torch.tensor([k == "p_inf" for k in EDGE_DIGITS], device=device)
    ks = ladder_value(digits.cpu(), 2, EDGE_MULTIPLES)
    want = [None if inf else _mul(a, k) for a, k, inf in zip(base, ks, p_inf.tolist())]
    return tx, ty, p_inf, digits, 2, want


def random_ladder(group: str, lanes: int, c: int, windows: int, generator: torch.Generator):
    """(tx, ty, p_inf, digits) of random field values (not points: the
    ladder's arithmetic and branches are the same for them) and random
    digits, on the generator's device."""
    t_count = (1 << c) - 1
    comps = 1 if group == "g1" else 2
    lead = (FP.W,) if group == "g1" else (FP.W, 2)

    def coord():
        t = peaks.random_elements(FP, comps * t_count * lanes, generator)
        return t.reshape((FP.W, t_count, lanes, comps)).permute(0, 3, 1, 2).reshape(
            lead + (t_count, lanes)).contiguous()

    dev = generator.device
    digits = torch.randint(0, 1 << c, (windows, lanes), generator=generator, device=dev,
                           dtype=torch.int32)
    return coord(), coord(), torch.zeros(lanes, dtype=torch.bool, device=dev), digits


# ---- the bench -----------------------------------------------------------------------------

def _timed(fn, iters):
    """(CUDA-event ms, host ms) a call, means over iters after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, (time.perf_counter() - t0) * 1e3 / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join("build", "ladder_bench.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ladder bench: a CUDA card is required", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = []
    for group, curve in (("g1", G1), ("g2", G2)):
        for lanes in LANES:
            tx, ty, p_inf, digits = random_ladder(group, lanes, C, WINDOWS, gen)
            fns = {"kernel": lambda: cuda_ops.ladder(tx, ty, p_inf, digits, C),
                   "per_op": lambda: CurveOps.ladder_rounds(curve, tx, ty, p_inf, digits, C)}
            if not all(torch.equal(a, b) for a, b in zip(fns["kernel"](), fns["per_op"]())):
                print(f"FAILED: ladder {group} at {lanes} lanes differs from the per-op route",
                      file=sys.stderr)
                return 1
            times = {k: [] for k in fns}
            for k in ("kernel", "per_op", "per_op", "kernel"):
                times[k].append(_timed(fns[k], 2))
            row = {"what": f"{group}_ladder", "lanes": lanes, "c": C, "windows": WINDOWS,
                   **{f"{k}_ms": sum(t[0] for t in v) / len(v) for k, v in times.items()},
                   **{f"{k}_host_ms": sum(t[1] for t in v) / len(v) for k, v in times.items()}}
            rows.append(row)
            print(f"{group} ladder, {lanes} lanes, c = {C}, W = {WINDOWS}: kernel "
                  f"{row['kernel_ms']:.4f} ms, per-op route (K2 dbl + K6 madd) "
                  f"{row['per_op_ms']:.4f} ms (host {row['per_op_host_ms']:.4f} ms); equal "
                  f"[{card}]", flush=True)
    for field in (FR, FP):
        for n in (1, 16):
            a = peaks.random_elements(field, n, gen)
            e = field.modulus - 2
            fns = {"kernel": lambda: cuda_field.field_pow(field, a, e),
                   "k1_chain": lambda: cuda_field.field_pow_chain(field, a, e)}
            if not torch.equal(fns["kernel"](), fns["k1_chain"]()):
                print(f"FAILED: field_pow {field.name} at {n} differs from the K1 chain",
                      file=sys.stderr)
                return 1
            times = {k: [] for k in fns}
            for k in ("kernel", "k1_chain", "k1_chain", "kernel"):
                times[k].append(_timed(fns[k], 5))
            row = {"what": f"field_pow_{field.name}", "elements": n, "bits": e.bit_length(),
                   **{f"{k}_ms": sum(t[0] for t in v) / len(v) for k, v in times.items()},
                   **{f"{k}_host_ms": sum(t[1] for t in v) / len(v) for k, v in times.items()}}
            rows.append(row)
            print(f"field_pow {field.name}, {n} elements, e = m - 2: kernel {row['kernel_ms']:.4f} "
                  f"ms, K1 chain ({e.bit_length() + bin(e).count('1') - 1} launches) "
                  f"{row['k1_chain_ms']:.4f} ms (host {row['k1_chain_host_ms']:.4f} ms); equal "
                  f"[{card}]", flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "rows": rows}, f, indent=1)
    print(json.dumps({"card": card, "rows": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
