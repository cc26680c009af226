"""Traffic: each mix is a data file `<traffic>.json` whose "kind" names the
module `<kind>.py` that generates and drives that kind of request from the
seed and the mix's parameters."""

from ..inputs import rng
from ..reference import judge


def read_srs_sample(ctx, srs):
    """The SRS powers the check reads (drawn from the seed), as the
    program's bytes: (G1 indices, G2 indices, G1 bytes, G2 bytes)."""
    cfg = ctx.config
    g1_idx, g2_idx = judge.srs_indices(rng(ctx.seed, "srs sample"), cfg["g1_powers"],
                                       cfg["g2_powers"], ctx.mix["srs_sample"])
    return (g1_idx, g2_idx, ctx.system.srs_g1_bytes(srs, g1_idx),
            ctx.system.srs_g2_bytes(srs, g2_idx))
