"""The sub-run length L and K3's launch bounds, swept on one NVIDIA GPU.

    python3 -m kzg_tpu_torch.bench.runs_sweep [--out JSON]

1. L at 1x, 2x and 4x the mean bucket (`pippenger.default_run_length`'s
   factor) on the MSM shapes of the main paths, random scalars over SRS
   points from `setup_device`: the K3 route at 2^15 points, c = 10 (the 2^15
   commit), at 2^20 - 1 points, c = 14 (the 2^20 witness), at 2^20, c = 15
   (the 2^20 commit), at 2^24, c = 16 (the 2^24 commit), and over Fp2 at
   2^15, c = 10; the bucket loop on K7
   at 2^15 - 1 points, c = 9 (the 2^15 witness), and at 2^12, c = 7 (the
   evaluation-form commit). For each: the split, K3 alone, the combine and
   the whole route, or the loop and its K7 launches (CUDA events, mean of 5
   after a warm-up).
2. K3 compiled with __launch_bounds__(128, k) for both groups, k = 1, 2, 3
   (-DKZG_K3_MIN_BLOCKS; one nvcc per source and k, side by side, into
   build/k3_variants/), beside the library's (k = 3 over Fp, 1 over Fp2,
   `K3MinBlocks` in csrc/point.cuh): registers and spills from ptxas, time
   at the K3 shapes in turns (library, 1, 2, 3, 3, 2, 1, library), output
   equal to the library's K3 word for word.

Needs a CUDA card and nvcc; prints the card's name and power limit and
writes the table to JSON (default build/runs_sweep.json).
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from .. import kernels
from ..config import get_config
from ..constants import R
from ..curve import G1, G2, cuda_ops
from ..fields import FR
from ..kzg.srs import setup_device
from ..msm import pippenger

SEED = 20260405
FACTORS = (1, 2, 4)
MIN_BLOCKS = (1, 2, 3)
K3_SOURCES = {"g1": "point_kernels.cu", "g2": "msm_g2_kernels.cu"}


def cuda_ms(fn, iters=5):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def k3_ptxas(text):
    """The ptxas -v lines (spills, registers) of the bucket_accumulate
    kernels in `text`."""
    out, live = [], False
    for line in text.splitlines():
        if "Compiling entry function" in line:
            live = "bucket_accumulate" in line
        elif live and ("spill" in line or "Used" in line):
            out.append(line.strip())
    return out


def build_variant(k, group):
    """One K3 source compiled with __launch_bounds__(128, k) into a shared
    library of its own; returns (path, ptxas lines)."""
    out_dir = kernels.BUILD_ROOT.parent / "k3_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"mb{k}_{group}_{kernels.source_digest()}.so"
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, f"-DKZG_K3_MIN_BLOCKS={k}", "-shared",
           "-o", str(lib), str(kernels.CSRC / K3_SOURCES[group])]
    res = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if res.returncode != 0:
        raise kernels.KernelError(f"nvcc failed: {' '.join(cmd)}\n{res.stdout}")
    return lib, k3_ptxas(res.stdout)


def variant_k3(entry, lead, rows, order, runs):
    """K3 through a variant library's entry, as `cuda_ops.bucket_runs`
    launches it."""
    m = runs.pos.numel()
    out = [torch.empty(lead + (m,), dtype=torch.int32, device=rows.device) for _ in range(3)]
    ins = (rows, order, runs.pos, runs.length)
    rc = entry(*(t.data_ptr() for t in out), *(t.data_ptr() for t in ins), m,
               kernels.stream_handle(rows.device))
    kernels.check_status(rc, "variant K3")
    return tuple(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join("build", "runs_sweep.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("runs_sweep: a CUDA card is required", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    with ThreadPoolExecutor(max_workers=len(MIN_BLOCKS) * 2) as pool:  # nvcc beside the setup
        builds = {(k, g): pool.submit(build_variant, k, g) for k in MIN_BLOCKS for g in K3_SOURCES}
        kernels.library()
        srs = setup_device(SEED, 1 << 24, g2_count=1 << 15, device=dev)
        builds = {key: f.result() for key, f in builds.items()}
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def std(n):
        low = torch.randint(-(1 << 31), 1 << 31, (7, n), generator=gen, device=dev,
                            dtype=torch.int64)
        top = torch.randint(0, R >> 224, (1, n), generator=gen, device=dev, dtype=torch.int64)
        return torch.cat([low, top]).to(torch.int32)  # < R, standard form

    def inputs(pts, n, c):
        return pippenger.bucket_inputs(*(t[..., :n] for t in pts), std(n), c)

    shapes = {
        "K3 2^15, c = 10": (G1, inputs(srs.gs, 1 << 15, 10)),
        "K3 2^20 - 1, c = 14": (G1, inputs(srs.gs, (1 << 20) - 1, 14)),
        "K3 2^20, c = 15": (G1, inputs(srs.gs, 1 << 20, 15)),
        "K3 2^24, c = 16": (G1, inputs(srs.gs, 1 << 24, 16)),
        "K3-G2 2^15, c = 10": (G2, inputs(srs.hs, 1 << 15, 10)),
        "K7 loop 2^15 - 1, c = 9": (G1, inputs(srs.gs, (1 << 15) - 1, 9)),
        "K7 loop 2^12, c = 7": (G1, inputs(srs.gs, 1 << 12, 7)),
    }
    results = {"card": card, "fuse": get_config().msm_fuse_steps, "sweep": [], "bounds": []}
    for label, (curve, inp) in shapes.items():
        rows, order, start, count = inp
        n, buckets = order.shape[-1], start.shape[-1]
        for f in FACTORS:
            L = pippenger.default_run_length(n, buckets, f)
            runs = pippenger.split_runs(start, count, n, L)
            row = {"shape": label, "factor": f, "L": L, "sub_runs": runs.pos.numel(),
                   "longest": runs.longest, "max_split": runs.max_split,
                   "split_ms": cuda_ms(lambda: pippenger.split_runs(start, count, n, L))}
            if label.startswith("K7"):
                kname = "g1_madd_multi"
                before = kernels.launch_counts()[kname]
                pippenger._bucket_loop(curve, *inp, run_length=L)
                row["k7_launches"] = kernels.launch_counts()[kname] - before
                row["loop_ms"] = cuda_ms(lambda: pippenger._bucket_loop(curve, *inp, run_length=L))
            else:
                part = cuda_ops.bucket_runs(rows, order, runs.pos, runs.length)
                row["k3_ms"] = cuda_ms(lambda: cuda_ops.bucket_runs(rows, order, runs.pos,
                                                                    runs.length))
                row["combine_ms"] = cuda_ms(lambda: pippenger.combine_runs(curve, part, runs))
                row["route_ms"] = cuda_ms(lambda: cuda_ops.bucket_accumulate(*inp, run_length=L))
            print(json.dumps(row), flush=True)
            results["sweep"].append(row)

    libs = {}
    for (k, g), (path, ptx) in builds.items():
        lib = ctypes.CDLL(str(path))
        entry = getattr(lib, f"kzg_{g}_bucket_accumulate")
        entry.argtypes = kernels._SIGNATURES[f"kzg_{g}_bucket_accumulate"]
        entry.restype = ctypes.c_int
        libs[(k, g)] = entry
        results["bounds"].append({"min_blocks": k, "group": g, "ptxas": ptx})
        print(f"ptxas, KZG_K3_MIN_BLOCKS={k}, {g}: {ptx}", flush=True)
    for label, (curve, inp) in shapes.items():
        if not label.startswith("K3"):
            continue
        rows, order, start, count = inp
        runs = pippenger.split_runs(start, count, order.shape[-1])
        g = "g2" if curve is G2 else "g1"
        lead = (12, 2) if g == "g2" else (12,)
        want = cuda_ops.bucket_runs(rows, order, runs.pos, runs.length)
        fns = {"library": lambda: cuda_ops.bucket_runs(rows, order, runs.pos, runs.length)}
        for k in MIN_BLOCKS:
            entry = libs[(k, g)]
            got = variant_k3(entry, lead, rows, order, runs)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                print(f"runs_sweep: K3 with min blocks {k} differs on {label}", file=sys.stderr)
                return 1
            fns[k] = (lambda e: lambda: variant_k3(e, lead, rows, order, runs))(entry)
        times = {k: [] for k in fns}
        for k in ("library", *MIN_BLOCKS, *reversed(MIN_BLOCKS), "library"):
            times[k].append(cuda_ms(fns[k]))
        row = {"shape": label, "ms": {k: sum(v) / len(v) for k, v in times.items()},
               "runs_ms": times}
        print(json.dumps(row), flush=True)
        results["bounds"].append(row)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(results, fh, indent=1)
    print(f"wrote {args.out} [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
