"""Benchmark harness mirroring the reference's criterion suite (port of
`kzg_tpu/bench/harness.py`): the same six groups over the same sizes,
timed on the port's public entry points.

Timing is CACHE-SAFE, as in the JAX package: every iteration runs on
DIFFERENT inputs (rolled copies of one batch) and every result is waited
for (`torch.cuda.synchronize`) before the clock stops, so no launch queue
or repeated input flatters a rate. A group's first call is a warm-up and is
not timed; it also builds the kernels on first use.

Reference bench-group parity (benches/*.rs):
  fft        -> bench_fft/bench_ifft                (benches/fft.rs:15-36)
  poly       -> add/mul_naive/mul_fft/long_division/interpolation
                                                    (benches/poly_arithmetic.rs:16-68)
  msm        -> no reference analog (blst-internal); the headline primitive
  commit     -> commit/create_witness coeff form    (benches/commit_coeff_form.rs,
                                                     benches/create_witness_coeff_form.rs)
  eval_form  -> commit/create_witness eval form     (benches/commit_eval_form.rs,
                                                     benches/create_witness_eval_form.rs)
  verify     -> verify_poly/verify_eval coeff form  (benches/poly_verify_coeff_form.rs:17-45,
                                                     benches/verify_eval_coeff_form.rs:18-53)

Run:  python -m kzg_tpu_torch.bench.harness [--sizes 16,64,256] [--json out.json]
      python -m kzg_tpu_torch.bench.harness --group fft --sizes 1024
      python -m kzg_tpu_torch.bench.harness --profile-dir build/traces
Runs on the card unless `--device cpu` is given (the plain twins: a CPU
time says nothing of the card).
"""

import argparse
import json
import os
import random
import time

import numpy as np
import torch

ITERS = 5


def expected_keys(group: str, n: int) -> list:
    """The result keys a group writes at size n (a power of two)."""
    return {
        "fft": [f"fft/{n}", f"ifft/{n}"],
        "poly": ([f"poly_add/{n}", f"poly_mul_fft/{n}"]
                 + [f"poly_mul_naive/{n}"] * (n <= 256)
                 + [f"poly_long_division/{n}"] * (n <= 512)
                 + [f"interpolation/{min(n, 64)}"]),
        "msm": [f"msm_g1/{n}", f"msm_g1_points_per_sec/{n}"],
        "commit": [f"commit_coeff_form/{n}", f"create_witness_coeff_form/{n}"],
        "eval_form": [f"commit_eval_form/{n}", f"create_witness_eval_form/{n}"],
        "verify": [f"verify_poly_coeff_form/{n}", f"verify_eval_coeff_form/{n}"],
    }[group]


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _timeit(fn, iters=ITERS):
    """Seconds a call of fn(i) for i = 1..iters after a warm-up call fn(0).

    fn MUST do different work for each i (callers pass per-iteration input
    variants); the device is synchronised before the clock stops."""
    fn(0)
    _sync()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(1 + i % iters)
    _sync()
    return (time.perf_counter() - t0) / iters


def _rand_scalars(rng, n, device):
    from ..constants import R
    from ..fields import FR

    return torch.from_numpy(FR.encode([rng.randrange(R) for _ in range(n)])).to(device)


def _scalar_variants(x, k=ITERS):
    """k + 1 distinct copies (cyclic rolls) of a scalar batch: the
    per-iteration inputs."""
    return [torch.roll(x, i, dims=-1) if i else x for i in range(k + 1)]


def _rand_points(n, device, seed=42):
    """n pseudorandom G1 points, k G for random 30-bit k (one batched
    ladder)."""
    from ..curve import G1, g1_generator_device

    ks = np.random.default_rng(seed).integers(1, 1 << 30, size=n, dtype=np.int64)
    bits = torch.from_numpy(((ks[None, :] >> np.arange(30)[:, None]) & 1).astype(np.int32))
    return G1.to_affine(G1.scalar_mul_bits(g1_generator_device(n, device), bits.to(device)))


def bench_fft(sizes, rng, results, device):
    from ..ntt import Domain

    for n in sizes:
        dom = Domain((n - 1).bit_length())
        xs = _scalar_variants(_rand_scalars(rng, dom.d, device))
        results[f"fft/{dom.d}"] = _timeit(lambda i: dom.ntt(xs[i]))
        results[f"ifft/{dom.d}"] = _timeit(lambda i: dom.intt(xs[i]))


def bench_poly(sizes, rng, results, device):
    from ..poly import Polynomial, lagrange_interpolation

    for n in sizes:
        polys_a = [Polynomial(a) for a in _scalar_variants(_rand_scalars(rng, n, device))]
        polys_b = [Polynomial(b) for b in _scalar_variants(_rand_scalars(rng, n, device))]
        results[f"poly_add/{n}"] = _timeit(lambda i: polys_a[i] + polys_b[i])
        results[f"poly_mul_fft/{n}"] = _timeit(lambda i: polys_a[i].best_mul(polys_b[i]))
        if n <= 256:
            # naive O(n^2) mul, the reference's bench_mul_naive comparison
            # (poly_arithmetic.rs:28-38); kept small, it is the slow oracle
            results[f"poly_mul_naive/{n}"] = _timeit(
                lambda i: polys_a[i].naive_mul(polys_b[i]))
        if n <= 512:
            divs = [Polynomial(v) for v in _scalar_variants(_rand_scalars(rng, n // 2, device))]
            results[f"poly_long_division/{n}"] = _timeit(
                lambda i: polys_a[i].long_division(divs[i]))
        k = min(n, 64)
        xvs = _scalar_variants(_rand_scalars(rng, k, device))
        yvs = _scalar_variants(_rand_scalars(rng, k, device))
        results[f"interpolation/{k}"] = _timeit(lambda i: lagrange_interpolation(xvs[i], yvs[i]))


def bench_msm(sizes, rng, results, device):
    from ..curve import G1
    from ..msm.pippenger import msm, pick_window

    for n in sizes:
        pts = _rand_points(n, device)
        svs = _scalar_variants(_rand_scalars(rng, n, device))
        dt = _timeit(lambda i: msm(G1, pts, svs[i], pick_window(n)))
        results[f"msm_g1/{n}"] = dt
        results[f"msm_g1_points_per_sec/{n}"] = n / dt


def bench_commit(sizes, rng, results, device):
    from ..kzg import KZGProver, setup
    from ..poly import Polynomial

    for n in sizes:
        prover = KZGProver(setup(69696969, n, device))
        polys = [Polynomial(v) for v in _scalar_variants(_rand_scalars(rng, n, device))]
        results[f"commit_coeff_form/{n}"] = _timeit(lambda i: prover.commit(polys[i]))
        pts = [(x := rng.randrange(1 << 62), polys[i].eval(x)) for i in range(ITERS + 1)]
        results[f"create_witness_coeff_form/{n}"] = _timeit(
            lambda i: prover.create_witness(polys[i], pts[i]))


def bench_eval_form(sizes, rng, results, device):
    from ..kzg import compute_lagrange_basis_from_secret, setup
    from ..kzg.eval_form import KZGProverEvalForm

    for n in sizes:
        exp = (n - 1).bit_length()
        d = 1 << exp
        prover = KZGProverEvalForm(setup(69696969, d, device),
                                   compute_lagrange_basis_from_secret(69696969, exp, device))
        evs = _scalar_variants(_rand_scalars(rng, d, device))
        results[f"commit_eval_form/{d}"] = _timeit(lambda i: prover.commit(evs[i]))
        results[f"create_witness_eval_form/{d}"] = _timeit(
            lambda i: prover.create_witness(evs[i], 5))


def bench_verify(sizes, rng, results, device):
    """verify_poly + verify_eval, coefficient form (reference
    poly_verify_coeff_form.rs:17-45, verify_eval_coeff_form.rs:18-53)."""
    from ..kzg import KZGProver, KZGVerifier, setup
    from ..poly import Polynomial

    for n in sizes:
        params = setup(69696969, n, device)
        prover = KZGProver(params)
        verifier = KZGVerifier(params)
        polys = [Polynomial(v) for v in _scalar_variants(_rand_scalars(rng, n, device))]
        commits = [prover.commit(p) for p in polys]
        results[f"verify_poly_coeff_form/{n}"] = _timeit(
            lambda i: verifier.verify_poly(commits[i], polys[i]))
        opens = []
        for i in range(ITERS + 1):
            x = rng.randrange(1 << 62)
            y = polys[i].eval(x)
            opens.append(((x, y), commits[i], prover.create_witness(polys[i], (x, y))))
        results[f"verify_eval_coeff_form/{n}"] = _timeit(
            lambda i: verifier.verify_eval(*opens[i]))


GROUPS = {
    "fft": bench_fft,
    "poly": bench_poly,
    "msm": bench_msm,
    "commit": bench_commit,
    "eval_form": bench_eval_form,
    "verify": bench_verify,
}


def run_group(name, sizes, rng, results, device, profile_dir=None):
    """One group; with profile_dir, inside a `torch.profiler` session whose
    Chrome trace goes to <profile_dir>/<name>/trace.json (the flamegraph
    hook of the reference, benches/perf.rs:40-72)."""
    fn = GROUPS[name]
    if profile_dir is None:
        return fn(sizes, rng, results, device)
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    out = os.path.join(profile_dir, name)
    os.makedirs(out, exist_ok=True)
    with profile(activities=activities) as prof:
        fn(sizes, rng, results, device)
        _sync()
    prof.export_chrome_trace(os.path.join(out, "trace.json"))


def main(argv=None) -> int:
    """Run the groups; print one line a result and return 0 (1 when a card
    is asked for and there is none). With --json, also write
    {"device": ..., "results": {key: seconds or points/s}}."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", default="16,64,128,256")
    ap.add_argument("--group", default="all", choices=["all"] + list(GROUPS))
    ap.add_argument("--json", default=None)
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    ap.add_argument("--profile-dir", default=None,
                    help="write a torch.profiler Chrome trace per bench group under this "
                    "directory")
    args = ap.parse_args(argv)
    from ..config import configure, get_config, set_config

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("harness: a card was asked for, but torch.cuda.is_available() is false")
        return 1
    sizes = [int(s) for s in args.sizes.split(",")]
    rng = random.Random(42)
    old = get_config()
    configure(device=args.device)
    results = {}
    try:
        for name in GROUPS:
            if args.group in ("all", name):
                run_group(name, sizes, rng, results, torch.device(args.device), args.profile_dir)
    finally:
        set_config(old)
    where = (torch.cuda.get_device_name(torch.device(args.device))
             if torch.device(args.device).type == "cuda" else "cpu")
    print(f"device {args.device} ({where})")
    for k, v in results.items():
        unit = "points/s" if "per_sec" in k else "s"
        print(f"{k:40s} {v:12.6g} {unit}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"device": where, "results": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
