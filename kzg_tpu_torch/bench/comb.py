"""Inputs for the fixed-base comb kernel (`cuda_ops.fk20_comb`), and the comb
against the digit ladder it replaced on FK20's path, on one NVIDIA GPU.

    python3 -m kzg_tpu_torch.bench.comb [--out JSON]

`EDGE_SCALARS` and `edge_case` build the comb's edge cases from the host's
oracle points (the CPU tests, `tests/test_torch_cuda.py` and
`chip_smoke.py` hold the kernel and its twin to them); `random_comb` gives
full-size random inputs for timing.

The bench, at FK20's shape (9 blobs x 128 frequencies x 64 columns =
73,728 lanes over 8,192 points):
  * builds the cell prover over an SRS of 4,096 G1 and 65 G2 powers and
    times its comb table (`DAS.fk20_table`), with the card's peak memory
    around the build and around one call on 9 blobs;
  * checks the kernel against its twin word for word on the prover's table
    and random scalars;
  * times, in turns, the comb kernel, the whole FK20 MSM (the comb and
    its K2 tree) and the ladder kernel's rounds over as many lanes (random
    tables: the ladder's time does not depend on the values; CUDA events).
It prints the card's name and power limit and writes the rows to JSON
(default build/comb_bench.json).
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from ..constants import R
from ..curve import G1, cuda_ops
from ..fields import FP, FR
from ..fields.limb import ints_to_words
from ..msm.pippenger import SMALL_MSM_WINDOW, point_sum
from . import peaks
from .ladder import _timed, jacobian_points, random_ladder, random_points

SEED = 20261018
BLOBS, FREQS, COLS = 9, 128, 64

# Scalars a lane, each against a base point, and what the comb meets: the
# top windows first, so window 0's entry comes last.
EDGE_SCALARS = {
    "zero": 0,                 # every digit 0: every window skipped, infinity
    "one": 1,                  # the accumulator is infinity when the entry comes
    "r_minus_1": R - 1,        # -P
    "all_15": (1 << 256) - 1,  # every digit 15, the top window's entry 15 too
    "r": R,                    # acc = (r - 1) P = -P, entry P: P == -Q -> infinity
    "r_plus_30": R + 30,       # acc = 15 P, entry 15 P: P == Q -> dbl
}


def scalar_words(values, device=None) -> torch.Tensor:
    """Integers below 2^256 -> (8, n) standard-form words (not reduced mod r)."""
    return torch.from_numpy(ints_to_words(values, FR.W)).to(device)


def edge_case(device=None, seed: int = SEED, points: int = 4):
    """(base, oracle points, scalars): `points` base points, the last one
    infinite, as a Jacobian batch at random Z; and a scalar batch (8, E,
    points) whose row e holds EDGE_SCALARS' e-th value in every lane, then
    one row of random scalars below r."""
    rs = np.random.default_rng(seed)
    pts = random_points("g1", points - 1, rs) + [None]
    base = jacobian_points("g1", pts, rs, device)
    rand = [int.from_bytes(rs.bytes(32), "little") % R for _ in range(points)]
    values = [v for v in EDGE_SCALARS.values() for _ in range(points)] + rand
    return base, pts, scalar_words(values, device).reshape(FR.W, len(EDGE_SCALARS) + 1, points)


def random_comb(points: int, generator: torch.Generator):
    """(rows, p_inf): a comb table of random field values (not points: the
    comb's arithmetic and branches are the same for them), on the
    generator's device."""
    n = cuda_ops.COMB_WINDOWS * points * cuda_ops.COMB_ENTRIES
    x, y = (peaks.random_elements(FP, n, generator) for _ in range(2))
    rows = torch.cat([x, y]).T.reshape(cuda_ops.COMB_WINDOWS, points, cuda_ops.COMB_ENTRIES, -1)
    return rows.contiguous(), torch.zeros(points, dtype=torch.bool, device=generator.device)


def random_scalars(shape, generator: torch.Generator) -> torch.Tensor:
    """(8, *shape) standard-form words of scalars below r."""
    n = int(np.prod(shape))
    return FR.from_mont(peaks.random_elements(FR, n, generator)).reshape((FR.W,) + tuple(shape))


def main(argv=None) -> int:
    from ..kzg.das import DAS
    from ..kzg.srs import setup_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join("build", "comb_bench.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("comb bench: a CUDA card is required", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    row = {"what": "g1_fk20_comb", "lanes": BLOBS * FREQS * COLS, "points": FREQS * COLS}

    das = DAS(setup_device(SEED, 4096, g2_count=65, device=dev))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    rows, p_inf = das.fk20_table
    torch.cuda.synchronize()
    row["table_s"] = time.perf_counter() - t0
    row["table_bytes"] = rows.numel() * 4
    row["table_peak_bytes"] = torch.cuda.max_memory_allocated(dev) - held
    blobs = peaks.random_elements(FR, BLOBS * 4096, gen).reshape(FR.W, BLOBS, 4096)
    das.compute_cells_and_kzg_proofs(blobs)  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    das.compute_cells_and_kzg_proofs(blobs)
    torch.cuda.synchronize()
    row["call_s"] = time.perf_counter() - t0
    row["held_bytes"] = held
    row["call_peak_bytes"] = torch.cuda.max_memory_allocated(dev) - held
    print(f"FK20 comb table: {row['table_s']:.4f} s, {row['table_bytes'] / 1e6:.1f} MB, build "
          f"peak {row['table_peak_bytes'] / 1e6:.1f} MB above what was held; a 9-blob call "
          f"{row['call_s'] * 1e3:.2f} ms, peak {row['call_peak_bytes'] / 1e6:.1f} MB above the "
          f"{held / 1e6:.1f} MB held [{card}]", flush=True)

    scalars = random_scalars((BLOBS, FREQS, COLS), gen)
    got = cuda_ops.fk20_comb(rows, p_inf, scalars)
    want = cuda_ops.fk20_comb_plain(rows, p_inf, scalars)
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        print("FAILED: the comb kernel differs from its twin at FK20's shape", file=sys.stderr)
        return 1
    lanes = row["lanes"]
    tx, ty, linf, digits = random_ladder("g1", lanes, SMALL_MSM_WINDOW,
                                         cuda_ops.COMB_WINDOWS, gen)
    fns = {"comb": lambda: cuda_ops.fk20_comb(rows, p_inf, scalars),
           "ladder": lambda: cuda_ops.ladder(tx, ty, linf, digits, SMALL_MSM_WINDOW),
           "comb_msm": lambda: point_sum(G1, cuda_ops.fk20_comb(rows, p_inf, scalars))}
    times = {k: [] for k in fns}
    for k in ("comb", "ladder", "comb_msm", "comb_msm", "ladder", "comb"):
        times[k].append(_timed(fns[k], 3))
    for k, v in times.items():
        row[f"{k}_ms"] = sum(t[0] for t in v) / len(v)
        row[f"{k}_host_ms"] = sum(t[1] for t in v) / len(v)
    nonzero = int(sum(((scalars.to(torch.int64) & 0xFFFFFFFF) >> (4 * s) & 15).ne(0).sum()
                      for s in range(8)))
    row["madds"] = nonzero
    print(f"comb kernel at {lanes} lanes over {row['points']} points: {row['comb_ms']:.4f} ms "
          f"({nonzero} madds); the ladder's rounds over the same lanes {row['ladder_ms']:.4f} ms; "
          f"comb + K2 tree {row['comb_msm_ms']:.4f} ms; the kernel equals its twin [{card}]",
          flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "rows": [row]}, f, indent=1)
    print(json.dumps({"card": card, "rows": [row]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
