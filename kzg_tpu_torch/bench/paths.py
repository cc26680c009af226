"""The port's main paths timed and profiled in one process, for the port in
this checkout or in another tree, so that two versions compare in one call
on one NVIDIA GPU.

    python3 kzg_tpu_torch/bench/paths.py [--root DIR] [--tag NAME] [--out JSON]
                                         [--only SUBSTRING ...]

`--root` is the directory that holds the `kzg_tpu_torch` package to time
(default: this checkout); the script imports it from there, so a parent
commit unpacked with `git archive` into a directory that .gitignore lists
runs as it was. Run two trees in turns in one command (parent, change,
change, parent) and compare the medians.

Each path runs once to warm up, then three times, host-clocked and closed
by a synchronize (the median and the three runs), then once more counting
the port's launches by kernel and the peak device memory above what was
allocated before the call (`torch.cuda.max_memory_allocated`), then once
more under `torch.profiler`: the device's busy time (the sum of the
kernels' self device time; one stream, so kernels never overlap), the idle
share (1 - busy / wall) and the device time of K2 (every kernel whose name
holds `add_kernel`, `dbl_kernel` or `pointwise_`), of K1 (`binary_kernel`,
`mul_const_kernel`), of the scan and Horner kernels (`scan_kernel`,
`horner_kernel`), of K7 (`madd_multi`, either mode) and of K5 (`ntt_`:
`ntt_block_kernel` and the per-stage `ntt_stage_kernel`). Paths, with the
inputs of `chip_smoke.py`'s counted phases (random, from a seed); `--only`
keeps the paths whose name holds one of the given strings (the inputs are
built all the same):
  * setup_device(s, 2^20, g2_count=2), and commit and witness at 2^20, the
    witness's linear division alone;
  * commit and witness at 2^15, the witness's evaluation check and linear
    division alone, the batched witness and the batched verify at 2^15,
    k = 16 (the SRS from setup_device(s, 2^15, g2_count=2^15));
  * the group iNTT of the Lagrange SRS at d = 2^12, G1 and G2, with their
    affine conversion;
  * the evaluation-form commit and `create_witness` at d = 2^12 (one
    EIP-4844 blob, against the Lagrange SRS from the secret): a 2^12-point
    G1 MSM each, on the bucket loop (K7);
  * msm_g2 over 2^12 and 2^15 random scalars;
  * the NTT-bound ones: `Domain(e).ntt` at 2^12, 2^15 and 2^20, the 2^20
    coset division of the batched quotient (k = 16) alone, and
    `verify_poly` at d = 2^12 (one inverse transform and a 2^12 MSM).
Prints the card's name and power limit and one JSON line; writes it to
--out when given.
"""

import argparse
import json
import os
import random
import subprocess
import sys
import time

SEED = 20260401
K_BATCH = 16
# kernels by the names their device functions carry
GROUPS = {"k2": ("add_kernel", "dbl_kernel", "pointwise_"),
          "k1": ("binary_kernel", "mul_const_kernel"),
          "scan_horner": ("scan_kernel", "horner_kernel"),
          "k7": ("madd_multi",),
          "ntt": ("ntt_",)}


def _fr_words(torch, gen, n, dev, R):
    low = torch.randint(-(1 << 31), 1 << 31, (7, n), generator=gen, device=dev,
                        dtype=torch.int64)
    top = torch.randint(0, R >> 224, (1, n), generator=gen, device=dev, dtype=torch.int64)
    return torch.cat([low, top]).to(torch.int32)


def _profile(torch, fn):
    """(device busy ms, {group: device ms}) of one call under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    busy = 0.0
    groups = dict.fromkeys(GROUPS, 0.0)
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        if us > 0 and evt.device_type == DeviceType.CUDA:
            busy += us / 1e3
            for g, keys in GROUPS.items():
                if any(k in evt.key for k in keys):
                    groups[g] += us / 1e3
    return busy, groups


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=None)
    ap.add_argument("--only", nargs="*", default=None)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("paths: a CUDA card is required", file=sys.stderr)
        return 1
    from kzg_tpu_torch import kernels
    from kzg_tpu_torch.constants import R
    from kzg_tpu_torch.curve import G1, G2
    from kzg_tpu_torch.fields import FR
    from kzg_tpu_torch.kzg import eval_form
    from kzg_tpu_torch.kzg.coeff_form import KZGProver, KZGVerifier
    from kzg_tpu_torch.kzg.eval_form import (
        KZGProverEvalForm, KZGVerifierEvalForm, compute_lagrange_basis_from_secret,
    )
    from kzg_tpu_torch.kzg.srs import setup_device
    from kzg_tpu_torch.msm import msm_g2
    from kzg_tpu_torch.ntt import Domain
    from kzg_tpu_torch.poly import Polynomial, lagrange_interpolation, vanishing_poly

    if not kernels.__file__.startswith(root):
        print(f"paths: imported {kernels.__file__}, not from {root}", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    kernels.build()
    kernels.library()
    build_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    rng = random.Random(SEED)

    def horner(coeffs, x):
        acc = 0
        for c in reversed(coeffs):
            acc = (acc * x + c) % R
        return acc

    big = setup_device(SEED, 1 << 20, g2_count=2, device=dev)
    poly20 = Polynomial(_fr_words(torch, gen, 1 << 20, dev, R))
    x20 = rng.randrange(R)
    y20 = horner(poly20.to_ints(), x20)
    prover20 = KZGProver(big)
    p15 = setup_device(SEED, 1 << 15, g2_count=1 << 15, device=dev)
    poly15 = Polynomial(_fr_words(torch, gen, 1 << 15, dev, R))
    c15 = poly15.to_ints()
    x15 = rng.randrange(R)
    y15 = horner(c15, x15)
    xs = [rng.randrange(R) for _ in range(K_BATCH)]
    ys = [horner(c15, x) for x in xs]
    prover15, verifier15 = KZGProver(p15), KZGVerifier(p15)
    commitment15 = prover15.commit(poly15)
    bw = prover15.create_witness_batched(poly15, xs, ys)
    dom12 = Domain(12)
    g12 = tuple(t[..., :dom12.d] for t in p15.gs)
    h12 = tuple(t[..., :dom12.d] for t in p15.hs)
    s12 = _fr_words(torch, gen, 1 << 12, dev, R)
    s15 = _fr_words(torch, gen, 1 << 15, dev, R)
    hs12 = tuple(t[..., :1 << 12] for t in p15.hs)
    lag12 = compute_lagrange_basis_from_secret(SEED, 12, device=dev)
    eprover = KZGProverEvalForm(p15, lag12)
    evals12 = _fr_words(torch, gen, 1 << 12, dev, R)
    everifier = KZGVerifierEvalForm(p15, lag12)
    ecommit12 = eprover.commit(evals12)
    ntt_x = {e: _fr_words(torch, gen, 1 << e, dev, R) for e in (12, 15, 20)}
    xs20 = torch.from_numpy(FR.encode(xs)).to(dev)
    numerator20 = poly20 - lagrange_interpolation(xs20, poly20.eval_many(xs20))
    z20 = vanishing_poly(xs20)

    paths = {
        "setup_device 2^20": lambda: setup_device(SEED, 1 << 20, g2_count=2, device=dev),
        "commit 2^20": lambda: prover20.commit(poly20),
        "witness 2^20": lambda: prover20.create_witness(poly20, (x20, y20), check=False),
        "division 2^20": lambda: poly20.div_by_linear(x20, want_rem=False),
        "commit 2^15": lambda: prover15.commit(poly15),
        "witness 2^15": lambda: prover15.create_witness(poly15, (x15, y15)),
        "evaluation check 2^15": lambda: poly15.eval(x15),
        "division 2^15": lambda: poly15.div_by_linear(x15, want_rem=False),
        f"batched witness 2^15, k = {K_BATCH}":
            lambda: prover15.create_witness_batched(poly15, xs, ys),
        f"batched verify 2^15, k = {K_BATCH}":
            lambda: verifier15.verify_eval_batched(commitment15, bw, xs),
        "group iNTT G1 2^12": lambda: G1.to_affine(eval_form._group_intt(G1, g12, dom12)),
        "group iNTT G2 2^12": lambda: G2.to_affine(eval_form._group_intt(G2, h12, dom12)),
        "eval-form commit 2^12": lambda: eprover.commit(evals12),
        "eval-form create_witness 2^12": lambda: eprover.create_witness(evals12, 1234),
        "msm_g2 2^12": lambda: msm_g2(hs12, s12),
        "msm_g2 2^15": lambda: msm_g2(p15.hs, s15),
        "NTT 2^12": lambda: Domain(12).ntt(ntt_x[12]),
        "NTT 2^15": lambda: Domain(15).ntt(ntt_x[15]),
        "NTT 2^20": lambda: Domain(20).ntt(ntt_x[20]),
        f"coset division 2^20, k = {K_BATCH}":
            lambda: KZGProver._exact_div(numerator20, z20, xs_int=xs),
        "verify_poly 2^12": lambda: everifier.verify_poly(ecommit12, evals12),
    }
    if args.only:
        paths = {k: v for k, v in paths.items() if any(o in k for o in args.only)}
    rows = []
    for name, fn in paths.items():
        fn()
        runs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3)
        wall = sorted(runs)[1]
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        fn()
        torch.cuda.synchronize()
        peak_mib = (torch.cuda.max_memory_allocated() - resident) / 2**20
        launches = {k: v for k, v in kernels.launch_counts().items() if v}
        busy, groups = _profile(torch, fn)
        rows.append({"path": name, "wall_ms": wall, "runs_ms": runs, "device_busy_ms": busy,
                     "k2_device_ms": groups["k2"], "k1_device_ms": groups["k1"],
                     "scan_horner_device_ms": groups["scan_horner"],
                     "k7_device_ms": groups["k7"], "ntt_device_ms": groups["ntt"],
                     "peak_mib": peak_mib,
                     "launches": launches, "idle_share": max(0.0, 1 - busy / wall)})
        print(f"[{args.tag}] {name}: wall {wall:.2f} ms (runs "
              f"{', '.join(f'{t:.2f}' for t in runs)}), device busy {busy:.2f} ms, K2 "
              f"{groups['k2']:.3f} ms, K1 {groups['k1']:.3f} ms, scan / Horner "
              f"{groups['scan_horner']:.3f} ms, K7 {groups['k7']:.3f} ms, K5 "
              f"{groups['ntt']:.3f} ms, idle "
              f"{rows[-1]['idle_share']:.3f}, peak "
              f"{peak_mib:.1f} MiB above resident; launches {launches} [{card}]", flush=True)
    out = {"tag": args.tag, "root": root, "card": card, "build_s": build_s, "paths": rows}
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
