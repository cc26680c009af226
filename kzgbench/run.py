"""Run one cell of the benchmark once:

    python3 -m kzgbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Set-up (imports, the kernels' build or load,
the SRS, the inputs, a warm-up of every shape the traffic uses) is timed
as `setup_s`, less the reference's own work in it (spans `reference.*`),
and each stage is printed apart; then the cell's requests run for `--seconds`; then the
metrics are read (`--trace 0`: the cell's end-to-end metrics; `--trace 1`:
its per-layer metrics, with the profiler on over the window) and every
output of the window is checked against the plain reference. The last
lines on standard error are the numbers compared, each beside its limit;
the last line on standard output is the result as one JSON object.

Exits 2 without a result where no card (or fewer than the cell asks for)
is present, and 3 where the process has loaded JAX or the JAX package.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "kzg_tpu"}


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def _card(index: int) -> str:
    res = subprocess.run(["nvidia-smi", f"--id={index}",
                          "--query-gpu=name,power.limit,clocks.sm,temperature.gpu",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    return res.stdout.strip() or res.stderr.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every cache the run writes stays at a fixed place in the checkout
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(ROOT, "build", "kzgbench", sub)

    from . import harness

    bench = harness.load_json(ROOT, "BENCHMARK.json")
    cell = harness.find_cell(bench, args.workload)
    import torch

    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"kzgbench: {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    from .system import Port

    t_system = time.perf_counter()
    system = Port(device, ROOT)
    stages = {"setup.imports": t_system - T_START, "setup.system": time.perf_counter() - t_system}
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), system, device,
                           T_START)
    found = forbidden_modules()
    if found:
        print(f"kzgbench: the process loaded {', '.join(found)}", file=sys.stderr)
        return 3
    checks = out.pop("checks")
    stages.update(out.pop("setup_stages_s"))
    print("setup stages (s): " + ", ".join(f"{k.removeprefix('setup.')} {v:.3f}"
                                           for k, v in stages.items()), file=sys.stderr)
    latency = out.pop("latency_ms")
    if latency:
        print(f"latency (ms): {json.dumps(latency)}", file=sys.stderr)
    out["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                     "count": chips, **out["device"]}
    out["setup_stages_s"] = stages  # "setup.system" holds the kernels' build in a first run
    out["card"] = _card(device.index)
    out["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
