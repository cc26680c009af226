"""Traffic kind "cells": a closed loop of PeerDAS cell-proof requests, one in
flight, as a rollup batcher attaches the cell proofs to the blobs it posts
or a supernode recomputes them for a block's blobs.

Set-up builds the SRS (`g1_powers` G1 and `g2_powers` G2 powers of a
secret drawn from the seed) and the system's cell prover over it, FK20's
table included, as a client's trusted-setup load builds it (span
`setup.srs`); then a pool of `pool` blocks of `blobs` blobs, each blob
`coefficients` uniform field elements read as bit-reversed evaluations,
made on the device (span `setup.inputs`). The reference computes every
block's cells by the spec's FFTs (span `reference.cells`) and their proofs
from the secret in closed form (span `reference.proofs`), both left out of
setup_s. The calls go through `kzgbench/das.py`.

Request k is one call of compute_cells_and_kzg_proofs on block k mod pool,
inside the benchmark's span `cells.prove`, closed by a synchronize: every
blob's `cells` cells of `cell` values and their proofs. Every request does
the same work, whatever the seed. Its record counts as one opening job
("kind" "open", read by open_s) and carries its blob count.

The check compares every cell value and every proof of every request of
the window with the reference's, byte for byte, and a sample of the SRS
powers with s^i G and s^i H. A request's proofs are read as bytes once for
each distinct set of words the system returned.
"""

from .. import das
from ..inputs import fr_point, fr_words
from ..reference import das as ref
from ..reference import judge
from ..reference.bls import g1_compress
from . import read_srs_sample

SPAN = "cells.prove"


def setup(ctx) -> dict:
    cfg, mix, sysm = ctx.config, ctx.mix, ctx.system
    calls = das.calls_for(sysm)
    secret = fr_point(ctx.seed, "secret")
    with ctx.span("setup.srs"):
        srs = sysm.setup_srs(secret, cfg["g1_powers"], cfg["g2_powers"])
        prover = calls.prover(srs, cfg)
        sysm.sync()
    n, lanes = cfg["coefficients"], mix["blobs"]
    with ctx.span("setup.inputs"):
        blocks = [fr_words(ctx.seed, f"block{p}", n * lanes, ctx.device).reshape(8, lanes, n)
                  for p in range(mix["pool"])]
    with ctx.span("reference.cells"):
        reference = ref.Cells(secret, n, cfg["cell"])
    want = []
    for block in blocks:
        with ctx.span("reference.cells"):
            values = ref.values(block)
            made = [reference.blob(values[b * n:(b + 1) * n]) for b in range(lanes)]
            cells = ref.mont_words(sum((e for e, _ in made), []), ctx.device)
        want.append({"cells": cells.reshape(8, lanes, cfg["cells"], cfg["cell"]),
                     "scalars": sum((q for _, q in made), [])})
    with ctx.span("reference.proofs"):
        g = ref.FixedBase()
        for w in want:
            w["proofs"] = [g1_compress(g.mul(q)) for q in w.pop("scalars")]
    state = {"secret": secret, "srs": srs, "calls": calls, "prover": prover, "blocks": blocks,
             "want": want, "outs": []}
    with ctx.span("setup.warmup"):
        for k in range(mix["warmup"]):
            _prove(ctx, state, k % len(blocks))
    state["outs"].clear()
    return state


def _prove(ctx, state, p: int):
    with ctx.span(SPAN):
        out = state["calls"].prove(state["prover"], state["blocks"][p])
        ctx.system.sync()
    state["outs"].append((p, out))


def request(ctx, state, k: int) -> dict:
    _prove(ctx, state, k % len(state["blocks"]))
    return {"kind": "open", "blobs": ctx.mix["blobs"]}


def collect(ctx, state):
    """Compare every output with the reference's now, cells on the device
    and proofs as bytes, then drop the outputs, the SRS and the prover."""
    state["srs_read"] = read_srs_sample(ctx, state["srs"])
    calls, read = state["calls"], {}
    state["bad"] = {"cell": 0, "proof": 0}
    for p, out in state["outs"]:
        want = state["want"][p]
        got = out["cells"].to(want["cells"].device)
        if got.shape != want["cells"].shape:
            state["bad"]["cell"] += want["cells"][0].numel()
        else:
            state["bad"]["cell"] += int((got != want["cells"]).any(dim=0).sum())
        key = calls.proof_key(out)
        if key not in read:
            read[key] = calls.proof_bytes(out)
        got = read[key]
        state["bad"]["proof"] += (sum(a != b for a, b in zip(got, want["proofs"]))
                                  + abs(len(got) - len(want["proofs"])))
    state["outs"] = []
    state["srs"] = state["prover"] = None


def check(ctx, state) -> dict:
    """{name: (value, limit)}: mismatches against the reference."""
    return {"srs_mismatches": (judge.srs_mismatches(state["secret"], state["srs_read"]), 0),
            "cell_mismatches": (state["bad"]["cell"], 0),
            "proof_mismatches": (state["bad"]["proof"], 0)}
