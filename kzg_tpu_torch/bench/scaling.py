"""Multi-device MSM scaling sweep (port of `kzg_tpu/bench/scaling.py`;
BASELINE.md: >= 80 % at N >= 2).

    python -m kzg_tpu_torch.bench.scaling                   # 1, 2, 4 cards
    python -m kzg_tpu_torch.bench.scaling --log-n 20        # a bigger problem
    python -m kzg_tpu_torch.bench.scaling --device cpu --devices 1,2 --log-n 8

Times `parallel.make_sharded_msm` (each rank's bucket MSM, then the
all_gather join) at a FIXED total problem size across device counts:
strong scaling, the BASELINE.md methodology. Each count runs as its own
world, one process a rank (NCCL on cards, gloo on the CPU), all ranks
building the same points (k G for random 20-bit k) and scalars from seed
42 and taking their block. A count needs that many cards: with fewer the
sweep says it skips the count and why, and never runs it on the CPU
instead. With `--device cpu` the ranks share the host's cores, so the
numbers only rehearse the method. Every count must give the same sum.

Emits ONE JSON line on stdout:
  {"metric": "msm_scaling_sweep", "sweep": [{"devices": N,
    "seconds": t, "points_per_sec": r, "efficiency_vs_1dev": e}, ...], ...}
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _inputs(n: int, device):
    """The affine points and Montgomery scalars every rank builds, on
    `device`."""
    from ..curve import G1, g1_generator_device
    from ..fields import FR

    rng = np.random.default_rng(42)
    ks = rng.integers(1, 1 << 20, size=n, dtype=np.int64)
    bits = torch.from_numpy(((ks[None, :] >> np.arange(20)[:, None]) & 1).astype(np.int32))
    pts = G1.to_affine(G1.scalar_mul_bits(g1_generator_device(n, device), bits.to(device)))
    words = rng.integers(0, 1 << 32, size=(FR.W, n), dtype=np.uint64)
    words[-1] &= 0x3FFFFFFF  # < 2^254 < r
    scalars = FR.to_mont(torch.from_numpy(words.astype(np.uint32).view(np.int32)).to(device))
    return pts, scalars


def _rank(args) -> int:
    """One rank of one world: time the sharded MSM; rank 0 writes the
    seconds and the sum (its affine words) to args.out."""
    import torch.distributed as dist

    from ..config import configure
    from ..curve import G1
    from ..parallel import initialize_distributed, make_mesh, make_sharded_msm
    from ..parallel.runtime import rank_device

    configure(device=args.device)
    initialize_distributed(init_method=args.init)
    run = make_sharded_msm(make_mesh(), "shard")
    pts, scalars = _inputs(1 << args.log_n, rank_device())
    p = tuple(run.shard(t) for t in pts)
    variants = [run.shard(torch.roll(scalars, i, dims=-1)) for i in range(3)]

    def sync():
        if torch.device(args.device).type == "cuda":
            torch.cuda.synchronize()

    out = run(p, variants[0])  # warm-up (and the kernels' first use)
    sync()
    dist.barrier()
    t0 = time.perf_counter()
    for i in range(args.iters):
        out = run(p, variants[1 + i % 2])
    sync()
    dist.barrier()
    dt = (time.perf_counter() - t0) / args.iters
    if dist.get_rank() == 0:
        with open(args.out, "w") as f:
            json.dump({"seconds": dt, "sum": [
                t.tolist() for t in G1.to_affine(tuple(t[..., None] for t in out))]}, f)
    dist.destroy_process_group()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", default="1,2,4")
    ap.add_argument("--log-n", type=int, default=14)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--device", default="cuda", help="cuda (one card a rank) or cpu")
    ap.add_argument("--timeout", type=float, default=900,
                    help="seconds one world may take before its processes are killed")
    ap.add_argument("--init", help=argparse.SUPPRESS)  # set on the ranks' command line
    ap.add_argument("--out", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.init:
        return _rank(args)

    from ..parallel.runtime import launch

    dev_counts = [int(d) for d in args.devices.split(",")]
    on_card = torch.device(args.device).type == "cuda"
    cards = torch.cuda.device_count() if on_card and torch.cuda.is_available() else 0
    kind = torch.cuda.get_device_name(0) if cards else "cpu"
    n = 1 << args.log_n
    print(f"[scaling] device {args.device} ({kind}), {cards} cards, n = 2^{args.log_n}",
          file=sys.stderr, flush=True)

    sweep, skipped, sums = [], [], []
    base_rate = base_nd = None
    for nd in dev_counts:
        if on_card and nd > cards:
            reason = f"only {cards} card{'s' * (cards != 1)}"
            print(f"[scaling] skip {nd} devices ({reason})", file=sys.stderr, flush=True)
            skipped.append({"devices": nd, "reason": reason})
            continue
        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, "rank0.json")
            launch([sys.executable, "-m", "kzg_tpu_torch.bench.scaling",
                    "--log-n", str(args.log_n), "--iters", str(args.iters),
                    "--device", args.device, "--init", f"file://{tmp}/store", "--out", out],
                   nd, args.timeout, env={"PYTHONPATH": os.pathsep.join(
                       [ROOT] + os.environ.get("PYTHONPATH", "").split(os.pathsep))})
            with open(out) as f:
                res = json.load(f)
        dt = res["seconds"]
        sums.append(res["sum"])
        rate = n / dt
        if base_rate is None:
            base_rate, base_nd = rate, nd
        eff = rate / (base_rate * nd / base_nd)
        sweep.append({"devices": nd, "seconds": dt, "points_per_sec": rate,
                      "points_per_sec_per_device": rate / nd, "efficiency_vs_1dev": eff})
        print(f"[scaling] {nd} dev: {dt:.4f} s  {rate:,.0f} pts/s  eff={eff:.2%}",
              file=sys.stderr, flush=True)
    if any(s != sums[0] for s in sums):
        print("[scaling] the device counts disagree on the MSM's sum", file=sys.stderr)
        return 1
    print(json.dumps({
        "metric": "msm_scaling_sweep",
        "value": sweep[-1]["efficiency_vs_1dev"] if sweep else None,
        "unit": "efficiency_vs_1dev",
        "device": args.device,
        "device_kind": kind,
        "backend": "nccl" if on_card else "gloo",
        "log_n": args.log_n,
        "sweep": sweep,
        "skipped": skipped,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
