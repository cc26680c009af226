"""Traffic kind "verify": a closed loop of KZG proof verifications, one in
flight, as a node validates the blobs it receives.

Set-up builds the SRS (span `setup.srs`) and a pool of `pool` blobs made
on the device from the seed. A blob of `coefficients` uniform field
elements is a random polynomial of that degree bound; read as evaluations,
it is a random blob just as well. For each, the benchmark draws a
challenge z outside the domain of `coefficients`-th roots of unity, and
makes y = p(z), the commitment p(s) G and the proof itself from the
secret (`reference/judge.py`, span `reference.proofs`, left out of
`setup_s`), as the blob's sender would have sent them.

Request k verifies blob b_k drawn from (seed, k). In each run of
`tamper_every` requests one, at a place drawn from the seed, is tampered:
y + 1, or the proof of another blob. Every request costs the verifier the
same work. Its latency is the host clock around the call, which returns
the verdict as a host boolean.

The check compares every verdict of the window with the reference's, and
a sample of the SRS powers with s^i G and s^i H.
"""

import time

from ..inputs import fr_point, fr_words, rng
from . import read_srs_sample
from ..reference import fr, judge
from ..reference.bls import G1, R


def _challenge(seed: int, b: int, d: int) -> int:
    k = 0
    while True:
        z = fr_point(seed, "z", b, k)
        if pow(z, d, R) != 1:
            return z
        k += 1


def setup(ctx) -> dict:
    cfg, mix, sysm = ctx.config, ctx.mix, ctx.system
    secret = fr_point(ctx.seed, "secret")
    with ctx.span("setup.srs"):
        srs = sysm.setup_srs(secret, cfg["g1_powers"], cfg["g2_powers"])
        sysm.sync()
    n, pool = cfg["coefficients"], mix["pool"]
    with ctx.span("setup.inputs"):
        words = fr_words(ctx.seed, "blobs", n * pool, ctx.device)
    with ctx.span("reference.proofs"):
        blobs = []
        for b in range(pool):
            z = _challenge(ctx.seed, b, n)
            at_s, y = fr.evaluate(words[:, b * n:(b + 1) * n], [secret, z])
            c, pi = judge.proof(secret, at_s, z, y)
            blobs.append({"z": z, "y": y, "commit": G1.affine(c), "proof": G1.affine(pi)})
    with ctx.span("setup.inputs"):
        points = sysm.g1_inputs([bl["commit"] for bl in blobs] + [bl["proof"] for bl in blobs])
        for b, bl in enumerate(blobs):
            bl["c_in"], bl["pi_in"] = points[b], points[pool + b]
        state = {"secret": secret, "srs": srs, "blobs": blobs,
                 "verifier": sysm.verifier(srs), "verdicts": []}
    with ctx.span("setup.warmup"):
        for k in range(mix["warmup"]):
            _verify(ctx, state, *schedule(ctx, k))
    state["verdicts"].clear()
    return state


def schedule(ctx, k: int):
    """(blob, tamper, other) of request k: tamper is None, "y" or "proof",
    other the blob whose proof a "proof" tamper sends."""
    pool, every = ctx.mix["pool"], ctx.mix["tamper_every"]
    b = rng(ctx.seed, "blob", k).randrange(pool)
    group = rng(ctx.seed, "tamper", k // every)
    if k % every != group.randrange(every):
        return b, None, b
    kind = group.choice(["y", "proof"])
    return b, kind, (b + 1 + group.randrange(pool - 1)) % pool if kind == "proof" else b


def _verify(ctx, state, b: int, tamper, other: int) -> float:
    bl, sysm = state["blobs"], ctx.system
    y = (bl[b]["y"] + (tamper == "y")) % R
    t0 = time.perf_counter()
    with ctx.span("verify"):
        ok = sysm.verify(state["verifier"], bl[b]["z"], y, bl[b]["c_in"], bl[other]["pi_in"])
    latency = time.perf_counter() - t0
    state["verdicts"].append((b, tamper, other, ok))
    return latency


def request(ctx, state, k: int) -> dict:
    return {"kind": "verify", "latency_s": _verify(ctx, state, *schedule(ctx, k))}


def collect(ctx, state):
    state["srs_read"] = read_srs_sample(ctx, state["srs"])
    for bl in state["blobs"]:
        bl["c_in"] = bl["pi_in"] = None
    state["srs"] = state["verifier"] = None


def check(ctx, state) -> dict:
    s, bl = state["secret"], state["blobs"]
    srs_bad = judge.srs_mismatches(s, state["srs_read"])
    truth, bad = {}, 0
    for b, tamper, other, ok in state["verdicts"]:
        key = (b, tamper, other)
        if key not in truth:
            y = (bl[b]["y"] + (tamper == "y")) % R
            truth[key] = judge.valid(s, bl[b]["z"], y, G1.from_affine(bl[b]["commit"]),
                                     G1.from_affine(bl[other]["proof"]))
        bad += ok != truth[key]
    return {"srs_mismatches": (srs_bad, 0), "verdict_mismatches": (bad, 0)}
