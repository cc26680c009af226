"""Time the pairing kernels (`miller_loop`, `final_exp`, csrc/pairing.cuh) on
the card at several numbers of warps a block.

    python3 -m kzg_tpu_torch.bench.pairing [--warps 8,16,32] [--lanes 2] [--iters 5]
                                           [--rounds 2] [--json PATH]

Each variant schedules both kernels' programs for blocks of that many warps
(`schedule.render(w, w)`), renders them into a header of its own and
compiles it with the same sources into `build/pairing_variants/warps<w>/`
(one nvcc process a variant, all started together). On `--lanes` random
pairs, every variant's Miller values and final exponentiations (lane and
product mode) are held to the library's word for word, then each is timed
with CUDA events, the variants in turns, `--rounds` times. Each row carries
the Miller loop's `chain_ms`: the dependent 16-lane products of a lane's
programs (init, 63 tangent and 5 chord steps, conjugation; an inverse
stage, of which the programs hold none, would count its Fermat chain) at
the latency K8 measures for one 16-lane product. Prints one JSON object a
variant and writes them all to `--json` (default
build/pairing_variants/times.json).
"""

import argparse
import ctypes
import json
import random
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

SOURCES = ("pairing.cuh", "pairing_kernels.cu", "coop.cuh", "field.cuh")


def build_variants(root: Path, warps):
    """Compile a library for each number of warps; returns {name: path}."""
    from .. import kernels
    from ..pairing import schedule

    root.mkdir(parents=True, exist_ok=True)
    nvcc = kernels._nvcc()
    jobs = {}
    for w in warps:
        name = f"warps{w}"
        d = root / name
        d.mkdir(exist_ok=True)
        for src in SOURCES:
            shutil.copy(kernels.CSRC / src, d / src)
        (d / "pairing_schedule.cuh").write_text(schedule.render(w, w))
        jobs[name] = [nvcc, *kernels.NVCC_FLAGS, "-shared", str(d / "pairing_kernels.cu"),
                      "-o", str(d / "libpairing.so")]

    def one(item):
        name, cmd = item
        t0 = time.perf_counter()
        res = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        return name, res, time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        done = list(pool.map(one, jobs.items()))
    libs = {}
    for name, res, dt in done:
        if res.returncode != 0:
            raise kernels.KernelError(f"variant {name}: nvcc failed\n{res.stdout}")
        regs = [line.strip() for line in res.stdout.splitlines() if "registers" in line]
        print(json.dumps({"variant": name, "nvcc_s": round(dt, 1), "ptxas": regs}), flush=True)
        libs[name] = root / name / "libpairing.so"
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lanes", type=int, default=2)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--warps", default="8,16,32", help="warps a block, comma-separated")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)

    import torch

    from .. import kernels, native
    from ..constants import R
    from ..fields import FP
    from .peaks import mul_peak
    from ..curve import g1_to_device, g2_to_device
    from ..oracle import g1_generator, g2_generator
    from ..pairing import pairing as pm
    from ..pairing import schedule

    if not torch.cuda.is_available():
        raise SystemExit("bench.pairing needs a CUDA card")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    root = kernels.BUILD_ROOT.parent / "pairing_variants"
    warps = [int(w) for w in args.warps.split(",")]
    libs = build_variants(root, warps)
    names = list(libs)
    rng = random.Random(5)
    n = args.lanes
    ps = [native.g1_mul(g1_generator(), rng.randrange(1, R)) for _ in range(n)]
    qs = [native.g2_mul(g2_generator(), rng.randrange(1, R)) for _ in range(n)]
    xp, yp, _ = g1_to_device(ps, dev)
    xq, yq, _ = g2_to_device(qs, dev)
    mconsts, fconsts, cols = pm.kernel_inputs(dev)
    want_f = pm.miller_loop_device((xp, yp), (xq, yq))
    want_lane = pm.final_exp_device(want_f)
    want_prod = pm.final_exp_product(want_f)
    stream = kernels.stream_handle(dev)
    lat_ms = 1e3 / mul_peak(FP, 1, device=dev, cooperative=True,
                            generator=torch.Generator(device=dev).manual_seed(9)).marginal_rate
    bits = schedule.LOOP_BITS
    entries = {}
    for w, (name, path) in zip(warps, libs.items()):
        lib = ctypes.CDLL(str(path))
        for fn in ("kzg_miller_loop", "kzg_final_exp"):
            getattr(lib, fn).argtypes = kernels._SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        out_f = torch.empty_like(want_f)
        out_lane = torch.empty_like(want_f)
        out_prod = torch.empty((12, 12, 1), dtype=torch.int32, device=dev)
        runs = {
            "miller_loop": lambda lib=lib, o=out_f: lib.kzg_miller_loop(
                o.data_ptr(), xp.data_ptr(), yp.data_ptr(), xq.data_ptr(), yq.data_ptr(), None,
                mconsts.data_ptr(), n, stream),
            "final_exp_lane": lambda lib=lib, o=out_lane: lib.kzg_final_exp(
                o.data_ptr(), want_f.data_ptr(), None, cols.data_ptr(), cols.numel(),
                fconsts.data_ptr(), n, 0, stream),
            "final_exp_product": lambda lib=lib, o=out_prod: lib.kzg_final_exp(
                o.data_ptr(), want_f.data_ptr(), None, cols.data_ptr(), cols.numel(),
                fconsts.data_ptr(), n, 1, stream),
        }
        for what, fn in runs.items():
            kernels.check_status(fn(), f"variant {name} {what}")
        torch.cuda.synchronize()
        same = (torch.equal(out_f, want_f) and torch.equal(out_lane, want_lane)
                and torch.equal(out_prod[..., 0], want_prod))
        if not same:
            raise kernels.KernelError(f"variant {name} differs from the library")
        mk, fk = schedule.miller_kernel(w), schedule.final_kernel(w)
        crit = {g: schedule.critical_products(p) for g, p in mk.programs.items()}
        chain = (crit["init"] + len(bits) * crit["tangent"] + sum(bits) * crit["chord"]
                 + crit["conj"])
        entries[name] = {"runs": runs, "row": {
            "variant": name, "warps": w, "equal": same, "card": card,
            "miller_inverse_stages": sum(st[0][0][0] == schedule.INV
                                         for p in mk.programs.values() for st in p.stages),
            "miller_chain_products": chain, "miller_chain_ms": chain * lat_ms,
            "mul_latency_coop_us": lat_ms * 1e3,
            "model_tangent": schedule.cost(mk.programs["tangent"]),
            "model_cyc_mul": schedule.cost(fk.programs["cyc_mul"]),
            "stages_tangent": len(mk.programs["tangent"].stages),
            "stages_cyc_mul": len(fk.programs["cyc_mul"].stages),
            "ms": {what: [] for what in runs}}}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(args.rounds):
        for name in names:
            e = entries[name]
            for what, fn in e["runs"].items():
                fn()
                torch.cuda.synchronize()
                start.record()
                for _ in range(args.iters):
                    fn()
                end.record()
                torch.cuda.synchronize()
                e["row"]["ms"][what].append(start.elapsed_time(end) / args.iters)
    rows = [entries[name]["row"] for name in names]
    for row in rows:
        print(json.dumps(row), flush=True)
    out = Path(args.json) if args.json else root / "times.json"
    out.write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
