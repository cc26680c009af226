"""One rank of a sharded run of kzg_tpu_torch.parallel on the CPU (gloo),
for tests/test_torch_parallel.py. It imports no JAX, so a rank starts in a
second or two.

    RANK=r WORLD_SIZE=N python tests/torch_parallel_worker.py \
        --init file:///tmp/store --eval-index 5 --out DIR

Every rank builds the same inputs at 2^EXP (`inputs`, which the test
imports too: numpy seeds, and the eval_2e7 vector's evaluations and secret
from tests/vectors.json), runs every sharded transform, the sharded G1 and
G2 MSMs over padded batches and the three steps, and writes its blocks and
its replicated outputs to DIR/rank<r>.npz.
"""

import argparse
import json
import os
import random
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from kzg_tpu_torch.constants import R  # noqa: E402

VEC = json.load(open(os.path.join(ROOT, "tests", "vectors.json")))
SECRET = int(VEC["secret"], 16)
EXP = 7  # the JAX package's EXP (tests/test_parallel.py) and eval_2e7's domain
SEED = 77
K_BATCH = 4  # batched opening points
N_G1 = 125  # sharded G1 MSM points, padded to a multiple of the world
N_G2 = 6  # sharded G2 MSM points


def _ints(rs, n):
    return [int.from_bytes(rs.bytes(32), "little") % R for _ in range(n)]


def _eval_2e7():
    """eval_2e7's evaluations: the generator drew the coeff_2e10 and
    batched_2e8_k16 streams first, so replay them."""
    rng = random.Random(VEC["seed"])
    c1, c3 = VEC["configs"]["coeff_2e10"], VEC["configs"]["batched_2e8_k16"]
    for _ in range(c1["n"] + 1 + c3["n"] + c3["k"]):
        rng.randrange(R)
    return [rng.randrange(R) for _ in range(1 << EXP)]


def inputs() -> dict:
    """The host inputs of a run at 2^EXP, the same in every process."""
    rs = np.random.default_rng(SEED)
    n = 1 << EXP
    return {
        "x": _ints(rs, n),  # the transforms' input
        "f": _ints(rs, n),  # the polynomial
        "point": _ints(rs, 1)[0],
        "xs": _ints(rs, K_BATCH),
        "evals": _eval_2e7(),
        "s1": _ints(rs, N_G1),
        "s2": _ints(rs, N_G2),
    }


def _jac(p) -> np.ndarray:
    return torch.stack(p).numpy()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--init", required=True)
    ap.add_argument("--eval-index", type=int, required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    torch.set_num_threads(1)

    from kzg_tpu_torch.config import configure

    configure(device="cpu")
    from kzg_tpu_torch.curve import G1, G2
    from kzg_tpu_torch.fields import FR
    from kzg_tpu_torch.kzg.eval_form import compute_lagrange_basis_from_secret
    from kzg_tpu_torch.kzg.srs import setup
    from kzg_tpu_torch.parallel import (
        ShardedDomain, initialize_distributed, make_batched_witness_step,
        make_commit_witness_step, make_eval_form_step, make_mesh, make_sharded_msm,
        pad_msm_inputs,
    )
    import torch.distributed as dist

    initialize_distributed(init_method=args.init)
    mesh = make_mesh()
    world = dist.get_world_size()
    exp, inp = EXP, inputs()
    n = 1 << exp

    def fr(ints):
        return torch.from_numpy(FR.encode(ints))

    out = {}
    sd = ShardedDomain(mesh, "shard", exp)
    x = sd.shard(fr(inp["x"]))
    for name in ("ntt", "intt", "coset_ntt", "coset_intt", "ntt_t"):
        out[name] = getattr(sd, name)(x).numpy()
    out["intt_t"] = sd.intt_t(torch.from_numpy(out["ntt_t"])).numpy()

    params = setup(SECRET, n)
    for curve, pts, key in ((G1, params.gs, "s1"), (G2, params.hs, "s2")):
        k = len(inp[key])
        padded, scalars = pad_msm_inputs(curve, tuple(t[..., :k] for t in pts), fr(inp[key]),
                                         world)
        run = make_sharded_msm(mesh, "shard", curve)
        out[f"msm_{key}"] = _jac(run(tuple(run.shard(t) for t in padded), run.shard(scalars)))

    step = make_commit_witness_step(mesh, "shard", exp)
    g = tuple(step.shard(t) for t in params.gs)
    f = step.shard(fr(inp["f"]))
    commit, y, wit = step(*g, f, fr([inp["point"]]))
    out.update(cw_commit=_jac(commit), cw_y=y.numpy(), cw_wit=_jac(wit))

    step = make_batched_witness_step(mesh, "shard", exp, K_BATCH)
    commit, ys, r, wit = step(*g, f, fr(inp["xs"]))
    out.update(b_commit=_jac(commit), b_ys=ys.numpy(), b_r=r.numpy(), b_wit=_jac(wit))

    lag = compute_lagrange_basis_from_secret(SECRET, exp)
    step = make_eval_form_step(mesh, "shard", exp, args.eval_index)
    commit, y, wit = step(*(step.shard(t) for t in lag.lg), step.shard(fr(inp["evals"])))
    out.update(e_commit=_jac(commit), e_y=y.numpy(), e_wit=_jac(wit))

    np.savez(os.path.join(args.out, f"rank{dist.get_rank()}.npz"), **out)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
