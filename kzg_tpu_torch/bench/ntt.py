"""Kernel K5 on one NVIDIA GPU: `ntt_block` (whole sub-transforms a launch)
against the stage loop it replaced, with its tile and the four-step split
swept.

    python3 -m kzg_tpu_torch.bench.ntt [--out JSON]

In one call:
  1. whole transforms at 2^12, 2^15 and 2^20 (forward, inverse, coset
     forward, coset inverse, on random words): the block route
     (`Domain(e)`) and the stage loop as the card ran it before
     (`Domain(e).as_stages()`: one K5 stage launch a stage, a gather, K1
     scales) in turns, equal word for word; each one's device time (calls
     back to back behind a held stream, `peaks.held_ms`), a call's time
     (CUDA events around calls as the host makes them) and launches;
  2. each pass of the four-step at 2^15 and 2^20 alone, at every split
     d = R C (both factors 2^3 to 2^12) and every tile width (`cols`, 1 to
     2^12 / m columns a block) and 128 to 1024 threads a block: the
     first pass (C-point columns over R-element rows, coset powers before,
     the twiddle after) and the second (R-point contiguous rows, stored
     transposed, 1/d after). Prints the fastest tile of each pass and the
     split whose two passes sum to the least, which `ntt_block_cols`,
     `ntt_block_threads` and `Domain._block_split` follow;
  3. the 2^12 transform alone at 128 to 1024 threads (one block: its
     time against the block count says whether it is latency-bound);
  4. where the butterflies read their twiddles (`kTw` in
     csrc/ntt_block.cuh): the three sources built side by side into a
     library of their own (`VARIANT_SOURCE`) and timed in turns, equal
     word for word, at the passes of the library's split at 2^15 and 2^20
     (every tile and thread count) and at the 2^12 transform: the stage
     table from device memory (the library's), the stage table staged in
     shared memory, the half table staged and read at stride m / 2h.
Prints the card's name and power limit and writes the rows to JSON
(default build/ntt_bench.json).
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

from pathlib import Path

import torch

from .. import kernels
from ..constants import R
from ..fields import cuda_field
from ..ntt import Domain
from . import peaks
from .pointwise import _timed

SEED = 20260411
EXPS = (12, 15, 20)
SWEEP_EXPS = (15, 20)
THREADS = (128, 256, 512, 1024)
TRANSFORMS = ("ntt", "intt", "coset_ntt", "coset_intt")


TW_SOURCES = ("global", "stage", "half")  # kNttTwGlobal, kNttTwStage, kNttTwHalf
VARIANT_SOURCE = r"""
#include "ntt_block.cuh"

using namespace kzg;

#define KZG_ENTRY(name, tw_mode)                                                              \
  extern "C" int name(void* out, const void* x, const void* tw, long long ncol, int log_m,     \
                      long long bt, long long out_bt, int log_cols, int threads,              \
                      const void* pre_hi, const void* pre_lo, int pre_mode, int pre_s,         \
                      long long pre_div, const void* post_hi, const void* post_lo,             \
                      int post_mode, int post_s, long long post_div, void* stream) {           \
    const NttScale pre{static_cast<const uint32_t*>(pre_hi),                                  \
                       static_cast<const uint32_t*>(pre_lo), pre_mode, pre_s, pre_div};       \
    const NttScale post{static_cast<const uint32_t*>(post_hi),                                \
                        static_cast<const uint32_t*>(post_lo), post_mode, post_s, post_div};  \
    return launch_ntt_block<tw_mode>(out, x, tw, ncol, log_m, bt, out_bt, log_cols, threads,  \
                                     pre, post, stream);                                      \
  }

KZG_ENTRY(kzg_ntt_block_global, kNttTwGlobal)
KZG_ENTRY(kzg_ntt_block_stage, kNttTwStage)
KZG_ENTRY(kzg_ntt_block_half, kNttTwHalf)
"""


def build_variants(out_dir: Path):
    """{twiddle source: C entry} from VARIANT_SOURCE, built into a library
    of its own; and nvcc's ptxas lines."""
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib = out_dir / "ntt_variants.cu", out_dir / "ntt_variants.so"
    src.write_text(VARIANT_SOURCE)
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, f"-I{kernels.CSRC}", "-shared", "-o", str(lib),
           str(src)]
    res = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if res.returncode != 0:
        raise kernels.KernelError(f"nvcc failed: {' '.join(cmd)}\n{res.stdout}")
    dll = ctypes.CDLL(str(lib))
    entries = {}
    for name in TW_SOURCES:
        fn = getattr(dll, f"kzg_ntt_block_{name}")
        fn.argtypes = kernels._SIGNATURES["kzg_ntt_block"]
        fn.restype = ctypes.c_int
        entries[name] = fn
    ptxas = [ln for ln in res.stdout.splitlines() if "registers" in ln or "spill" in ln]
    return entries, ptxas


def random_words(n: int, generator: torch.Generator) -> torch.Tensor:
    """(8, n) Fr words below the modulus on the generator's device."""
    dev = generator.device
    low = torch.randint(-(1 << 31), 1 << 31, (7, n), generator=generator, device=dev,
                        dtype=torch.int64)
    top = torch.randint(0, R >> 224, (1, n), generator=generator, device=dev, dtype=torch.int64)
    return torch.cat([low, top]).to(torch.int32)


def _launches(fn):
    kernels.reset_launches()
    fn()
    torch.cuda.synchronize()
    return {k: v for k, v in kernels.launch_counts().items() if v}


def pass_calls(dom: Domain, exp_r: int, x: torch.Tensor):
    """{pass: (fn(cols, threads, entry=None), m)} of the two passes of
    dom's forward coset four-step at split exp_r, on x (8, d)."""
    dev = x.device
    exp_c = dom.exp - exp_r
    rn, cn = 1 << exp_r, 1 << exp_c
    sub_c, sub_r = Domain(exp_c), Domain(exp_r)
    pre = dom._scale("coset_fwd_scale", dev, "linear", dom.gen)
    tw = dom._scale("twiddle_fwd", dev, "product", dom.omega, div=1)
    post = dom._scale("dinv_scale", dev, "const", 0, dom.d_inv)
    x1 = x.reshape(8, 1, cn, rn)
    x2 = x.reshape(8, cn, rn, 1)
    t1, t2 = sub_c._stage_table(False, dev), sub_r._stage_table(False, dev)
    return {
        "first": (lambda c, t, entry=None: cuda_field.ntt_block(
            x1, t1, pre, tw, cols=c, threads=t, entry=entry), cn),
        "second": (lambda c, t, entry=None: cuda_field.ntt_block(
            x2, t2, None, post, out_bt=cn, cols=c, threads=t, entry=entry), rn),
    }


def _tiles(m: int):
    """The tile widths (columns) a pass of m-point transforms can take."""
    return [1 << k for k in range(cuda_field.NTT_TILE_EXP - m.bit_length() + 2)]


def twiddle_sources(out_dir: Path, gen: torch.Generator, card: str):
    """Part 4: each pass of the library's split at 2^15 and 2^20 and the
    2^12 transform, at every tile and thread count, with the twiddles from
    each source in turns (global, stage, half, half, stage, global); the
    fastest tile of each source. None if two sources differ."""
    entries, ptxas = build_variants(out_dir / "ntt_variants")
    print("variants' ptxas: " + " | ".join(ptxas), flush=True)
    rows, best = [], {}
    dev = gen.device
    cases = []
    for exp in SWEEP_EXPS:
        dom = Domain(exp)
        x = random_words(dom.d, gen)
        for pname, (fn, m) in pass_calls(dom, dom._block_split()[0], x).items():
            cases.append((f"2^{exp} {pname} pass (m = {m})", fn, m))
    dom = Domain(12)
    x12 = random_words(dom.d, gen).reshape(8, 1, dom.d, 1)
    tw12 = dom._stage_table(False, dev)
    cases.append(("2^12 transform", lambda c, t, entry=None: cuda_field.ntt_block(
        x12, tw12, cols=c, threads=t, entry=entry), dom.d))
    order = list(TW_SOURCES) + list(reversed(TW_SOURCES))
    for label, fn, m in cases:
        for c in _tiles(m):
            for t in THREADS:
                want = fn(c, t)
                ms = {k: [] for k in TW_SOURCES}
                for k in order:
                    try:
                        got = fn(c, t, entries[k])
                    except kernels.KernelError:  # the table does not fit beside the tile
                        ms[k] = None
                        continue
                    if not torch.equal(got, want):
                        print(f"FAILED: {label} cols {c} threads {t}: twiddles from {k} differ",
                              file=sys.stderr)
                        return None
                    if ms[k] is not None:
                        ms[k].append(peaks.held_ms(lambda: fn(c, t, entries[k]), 10))
                row = {"case": label, "cols": c, "threads": t,
                       **{f"{k}_ms": None if v is None else sum(v) / len(v)
                          for k, v in ms.items()}}
                rows.append(row)
                print(json.dumps(row), flush=True)
        for k in TW_SOURCES:
            timed = [r for r in rows if r["case"] == label and r[f"{k}_ms"] is not None]
            if timed:
                r = min(timed, key=lambda r: r[f"{k}_ms"])
                best[f"{label} {k}"] = {"cols": r["cols"], "threads": r["threads"],
                                        "ms": r[f"{k}_ms"]}
        print(f"{label}: fastest tile by twiddle source: " + ", ".join(
            f"{k} {best[f'{label} {k}']['ms']:.4f} ms (cols {best[f'{label} {k}']['cols']}, "
            f"threads {best[f'{label} {k}']['threads']})" for k in TW_SOURCES
            if f"{label} {k}" in best) + f" [{card}]", flush=True)
    return {"ptxas": ptxas, "rows": rows, "best": best}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join("build", "ntt_bench.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ntt bench: a CUDA card is required", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    kernels.library()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    results = {"card": card, "transforms": [], "passes": [], "single": [], "best": {}}

    for exp in EXPS:
        dom = Domain(exp)
        x = random_words(dom.d, gen)
        for name in TRANSFORMS:
            fns = {"block": lambda: getattr(dom, name)(x),
                   "stages": lambda: getattr(dom.as_stages(), name)(x)}
            if not torch.equal(fns["block"](), fns["stages"]()):
                print(f"FAILED: {name} 2^{exp}: the block route differs from the stage loop",
                      file=sys.stderr)
                return 1
            order = list(fns) + list(reversed(fns))
            runs = {k: [] for k in fns}
            for k in order:
                runs[k].append(_timed(fns[k], 20 if exp <= 15 else 5))
            row = {"exp": exp, "transform": name}
            for k, v in runs.items():
                row[f"{k}_call_ms"] = sum(r[0] for r in v) / len(v)
                row[f"{k}_device_ms"] = sum(r[2] for r in v) / len(v)
                row[f"{k}_launches"] = _launches(fns[k])
            results["transforms"].append(row)
            print(json.dumps(row), flush=True)

    for exp in SWEEP_EXPS:
        dom = Domain(exp)
        x = random_words(dom.d, gen)
        split_ms = {}
        for exp_r in range(max(3, exp - cuda_field.NTT_TILE_EXP),
                           min(cuda_field.NTT_TILE_EXP, exp - 3) + 1):
            total = 0.0
            for pname, (fn, m) in pass_calls(dom, exp_r, x).items():
                best = None
                for c in _tiles(m):
                    for t in THREADS:
                        ms = peaks.held_ms(lambda: fn(c, t), 10)
                        row = {"exp": exp, "exp_r": exp_r, "pass": pname, "m": m, "cols": c,
                               "threads": t, "device_ms": ms}
                        results["passes"].append(row)
                        print(json.dumps(row), flush=True)
                        if best is None or ms < best["device_ms"]:
                            best = row
                total += best["device_ms"]
                results["best"][f"2^{exp} r={exp_r} {pname}"] = best
            split_ms[exp_r] = total
        exp_r = min(split_ms, key=split_ms.get)
        results["best"][f"2^{exp} split"] = {"exp_r": exp_r, "device_ms": split_ms[exp_r],
                                             "by_split": split_ms}
        print(f"2^{exp}: fastest split exp_r = {exp_r} ({split_ms[exp_r]:.4f} ms, both passes "
              f"at their fastest tiles) [{card}]", flush=True)

    dom = Domain(12)
    x = random_words(dom.d, gen).reshape(8, 1, dom.d, 1)
    tw = dom._stage_table(False, dev)
    for t in THREADS:
        row = {"exp": 12, "threads": t,
               "device_ms": peaks.held_ms(lambda: cuda_field.ntt_block(x, tw, threads=t), 20)}
        results["single"].append(row)
        print(json.dumps(row), flush=True)
    results["twiddles"] = twiddle_sources(Path(os.path.dirname(args.out) or "."), gen, card)
    if results["twiddles"] is None:
        return 1
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps({"card": card, "best": results["best"],
                      "twiddles": results["twiddles"]["best"]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
