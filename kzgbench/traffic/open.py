"""Traffic kind "open": a closed loop of single openings, one in flight,
as a proving service runs them.

Set-up builds the SRS (`g1_powers` G1 and `g2_powers` G2 powers of a
secret drawn from the seed, span `setup.srs`) and a pool of `pool` dense
polynomials of `coefficients` uniform field elements (the mix's, else the
configuration's), made on the device.
Job k takes polynomial k mod pool and a point x_k drawn from (seed, k),
commits (span `open.commit`), evaluates y = f(x_k) and builds the witness
for (x_k, y) (span `open.witness`), each span closed by a synchronize.
Every job does the same work, whatever the seed.

The check compares every job of the window with the reference: y with the
exact evaluation, the commitment with f(s) G, the witness with
((f(s) - y) / (s - x)) G, byte for byte, and a sample of the SRS powers
drawn from the seed with s^i G and s^i H.
"""

from ..inputs import fr_point, fr_words
from . import read_srs_sample
from ..reference import judge


def setup(ctx) -> dict:
    cfg, mix, sysm = ctx.config, ctx.mix, ctx.system
    secret = fr_point(ctx.seed, "secret")
    with ctx.span("setup.srs"):
        srs = sysm.setup_srs(secret, cfg["g1_powers"], cfg["g2_powers"])
        sysm.sync()
    with ctx.span("setup.inputs"):
        n = mix.get("coefficients", cfg["coefficients"])
        words = [fr_words(ctx.seed, f"pool{p}", n, ctx.device) for p in range(mix["pool"])]
        state = {"secret": secret, "srs": srs, "words": words,
                 "polys": [sysm.polynomial(w) for w in words], "jobs": []}
    with ctx.span("setup.warmup"):
        for _ in range(mix["warmup"]):
            _job(ctx, state, 0, fr_point(ctx.seed, "warmup"))
    state["jobs"].clear()
    return state


def _job(ctx, state, p: int, x: int):
    sysm, srs, poly = ctx.system, state["srs"], state["polys"][p]
    with ctx.span("open.commit"):
        c = sysm.commit(srs, poly)
        sysm.sync()
    with ctx.span("open.witness"):
        y = sysm.evaluate(poly, x)
        w = sysm.witness(srs, poly, x, y)
        sysm.sync()
    state["jobs"].append({"poly": p, "x": x, "y": y, "commit": c, "witness": w})


def request(ctx, state, k: int) -> dict:
    _job(ctx, state, k % len(state["polys"]), fr_point(ctx.seed, "x", k))
    return {"kind": "open"}


def collect(ctx, state):
    """Read the window's outputs and the SRS sample as bytes, then drop the
    program's SRS, polynomials and points. The words stay, for the
    reference."""
    state["srs_read"] = read_srs_sample(ctx, state["srs"])
    for j in state["jobs"]:
        j["commit"] = ctx.system.g1_bytes(j["commit"])
        j["witness"] = ctx.system.g1_bytes(j["witness"])
    state["srs"] = state["polys"] = None


def check(ctx, state) -> dict:
    """{name: (value, limit)}: mismatches against the reference."""
    s, jobs = state["secret"], state["jobs"]
    srs_bad = judge.srs_mismatches(s, state["srs_read"])
    bad = {"commit": 0, "y": 0, "witness": 0}
    for p, words in enumerate(state["words"]):
        mine = [j for j in jobs if j["poly"] == p]
        if not mine:
            continue
        for j, (c, y, w) in zip(mine, judge.openings(words, s, [j["x"] for j in mine])):
            bad["commit"] += j["commit"] != c
            bad["y"] += j["y"] != y
            bad["witness"] += j["witness"] != w
    return {"srs_mismatches": (srs_bad, 0), "commit_mismatches": (bad["commit"], 0),
            "y_mismatches": (bad["y"], 0), "witness_mismatches": (bad["witness"], 0)}
