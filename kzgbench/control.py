"""The check's control and its planted faults, run through the harness:

    python3 -m kzgbench.control --workload <cell> --seed <n> --seconds <s>
                                (--control | --fault <fault>)

`--control` puts the reference in the program's place with one guarantee
of the configuration broken, as the cell's file states under "control"
(`scalar_bits`: full-width scalars broken, only the low bits of every
scalar kept; `reference/system.py`). `--fault` plants one of
`faults.FAULTS` under the program itself (`--fault stale|half|altered|lost`). Either
way the check must come out not correct; the numbers it compared are the
upper readings of its limits. Prints the result line as `run.py` does.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def system_for(cell, mode: str, device, root: str):
    """The system a control or fault run drives."""
    from .faults import Faulty
    from .reference.system import ReferenceSystem

    if mode == "control":
        return ReferenceSystem(device, **cell.control)
    if device.type == "cuda":
        from .system import Port

        return Faulty(Port(device, root), mode)
    return Faulty(ReferenceSystem(device), mode)


def main(argv=None) -> int:
    from . import harness
    from .run import ROOT

    ap = argparse.ArgumentParser(description="Run a cell with the control or a fault.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    group = ap.add_mutually_exclusive_group(required=True)
    group.add_argument("--control", action="store_true")
    group.add_argument("--fault")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("kzgbench.control: a CUDA card is required", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = harness.find_cell(harness.load_json(ROOT, "BENCHMARK.json"), args.workload)
    system = system_for(cell, "control" if args.control else args.fault, device, ROOT)
    out = harness.run_cell(cell, args.seed, args.seconds, False, system, device, T_START)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps({"system": system.name, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
