"""Drive the PyTorch + CUDA port (kzg_tpu_torch) on one NVIDIA GPU, end to end.

    python3 chip_smoke.py [--profile [JSON]]

Phases, each printed with its result and wall time; any failure exits
non-zero before the result line:
  1. device   - a CUDA card is required; prints its name and power limit;
  2. build    - compiles the port's kernels (nvcc, sm_90a) from the sources,
                one nvcc per source, all started together;
  3. kernels  - every kernel against its plain PyTorch twin on the card, at
                main-path shapes, exact equality (all of it is integer math):
                K1 field ops at 2^15 (Fr and Fp, edges 0, 1, p-1) and the
                standalone make_mul / make_add / make_sub entries, K2 add/dbl
                on 2^12 points (infinity, P+P, P+(-P) lanes), K6 madd on 2^12
                and 2^11 lanes (skip, infinite, same and opposite lanes
                planted), K7 madd_multi at the shape a 2^12-point MSM gives
                it (16 steps over 37 x 128 bucket lanes; neg mask, same and
                opposite steps planted), K3 one 2^15 MSM's buckets at c = 10,
                K4 the window join at W = 37, c = 7 and at W = 26, c = 10,
                K5 every stage of a 2^20 NTT in the Pease layout and in the
                four-step layout, of a 2^12 Pease transform, and the whole
                2^20 NTT against the domain's plain twin; over Fp2: add/dbl,
                K6 and K7 as over Fp, K3 / K4 on a dense G2 MSM's buckets at
                2^12 (c = 7) and at 2^15 (c = 10);
  4. golden   - the coeff_2e10 vector of tests/vectors.json: setup, commit,
                witness bytes, verify accepts, tampered y rejected;
  5. 2^15     - setup (host engine; cached under build/kzg_tpu_torch/),
                commit of a seeded random polynomial checked against the
                native engine's MSM, witness, verify, tampered y rejected;
  6. counts   - kernel launch counts of phases 4-5 (reset just before
                phase 4): K1, K2, K3, K4 and K7 (the witness's MSM has 512
                buckets a window) must each be > 0;
  7. golden   - the batched_2e8_k16 vector: commit, batched witness, h^Z
                (G2) and g^r bytes, verify_eval_batched accepts;
  8. batched  - 2^15 coefficients opened at k = 16 points on the 2^15 SRS:
                commit, create_witness_batched, verify_eval_batched
                accepts, other xs rejected;
  9. coset    - the batched quotient's coset division alone at 2^20: a
                seeded numerator f - r divided by a 16-point Z, q Z ==
                numerator checked at two random points with host ints;
 10. counts   - launch counts of phases 7-9 (reset just before phase 7),
                every kernel of that path must be > 0;
      (the Lagrange build timed group by group, before the next reset);
 11. G2 MSM   - msm_g2 (G2 Pippenger) at 2^12 (the bucket loop on K7) and
                2^15 points (K3) with random scalars, equal to the native
                engine's g2_msm;
 12. golden   - the eval_2e7 vector: Lagrange SRS from the secret, commit
                and witness bytes, verify_eval accepts;
 13. eval     - the evaluation-form path at d = 2^12 (one EIP-4844 blob):
                the Lagrange SRS by the group iNTT of the first 2^12 SRS
                powers (G1 and G2) held point for point against the
                from-secret basis of the host engine, commit (equal to the
                native MSM and to the coefficient-form commitment of the
                interpolated polynomial), create_witness, verify_eval,
                tampered y and wrong index rejected, verify_poly,
                create_witness_all + verify_eval_all (G2 Pippenger over the
                Lagrange G2 points, h^z == lh[d-1] - lh[0]);
 14. counts   - launch counts of phases 11-13 (reset just before phase 11),
                every kernel of that path must be > 0 (all but K3 over Fp:
                its MSMs have 128 buckets a window and take K7).
With --profile, the evaluation-form path is then profiled phase by phase
(wall, launches, device time by kernel, idle share) and the table written
to JSON (default build/profile_eval.json).
The last lines are the kernel report (launches summed over the three
counted runs), the nvidia-smi line, and {"ok": true, "device": {...}}.

Bounds in the kernel report. `bound_ms` is the larger of two times: the
bytes the function must move (each input read once, each output written
once) over the H100's 3.35 TB/s of device memory, and its 32-bit integer
multiply-adds over the card's rate for them. That rate is not in NVIDIA's
data sheet; it is taken as a quarter of the 67 TFLOP/s float32 figure: a
float32 FMA counts two operations, and a Hopper SM has 64 INT32 lanes to
its 128 FP32 lanes, which gives 16.75e12 multiply-adds a second. A
Montgomery multiplication of N words is counted as 2 N^2 + N multiply-adds
(CIOS), a field add or sub as 2 N word operations, a point operation by its
field multiplications (dbl 7, madd 11, add 16 over Fp; 16, 29, 43 over
Fp2). Data-dependent kernels count what this run's inputs need (the points
in non-empty buckets, the live lanes of a masked madd). `library_ms` is
null for every kernel: no PyTorch call computes 255- or 381-bit modular
arithmetic.
"""

import argparse
import hashlib
import json
import os
import random
import subprocess
import sys
import time

import torch

SEED = 20260401
N_MAIN = 1 << 15
C_MAIN = 10
N_POINT = 1 << 12
K_BATCH = 16
EXP_COSET = 20
EXP_EVAL = 12  # one EIP-4844 blob: 4096 evaluations

HBM_BYTES_PER_S = 3.35e12
INT_MADS_PER_S = 67e12 / 4  # see the module docstring
FP_MUL_MADS = 2 * 12 * 12 + 12
FR_MUL_MADS = 2 * 8 * 8 + 8
# Fp multiplications of one point operation: (G1, G2)
POINT_MULS = {"dbl": (7, 16), "madd": (11, 29), "add": (16, 43)}
ROOT = os.path.dirname(os.path.abspath(__file__))


class SmokeFailure(RuntimeError):
    pass


def log(msg):
    print(msg, flush=True)


def phase(name):
    """Context manager printing a phase's outcome and wall time."""

    class _Phase:
        def __enter__(self):
            self.t0 = time.perf_counter()
            log(f"[{name}] start")
            return self

        def __exit__(self, et, ev, tb):
            dt = time.perf_counter() - self.t0
            log(f"[{name}] {'ok' if et is None else 'FAILED'} in {dt:.2f} s")
            return False

    return _Phase()


def check(ok, what):
    if not ok:
        raise SmokeFailure(what)
    log(f"  pass: {what}")


def cuda_ms(fn, iters):
    """Mean milliseconds per call of fn on the card (CUDA events), after a
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes, mads):
    """(bound_ms, bound_by) of a kernel that must move nbytes and do mads
    32-bit multiply-adds."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = mads / INT_MADS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def point_bound(op, g2, lanes, coords_moved, live=None):
    """Bound of a pointwise add / dbl / madd over `lanes` points:
    coords_moved coordinates of 48 (G1) or 96 (G2) bytes a lane, the
    formula's multiplications on the `live` lanes."""
    live = lanes if live is None else live
    return bound(coords_moved * (96 if g2 else 48) * lanes,
                 POINT_MULS[op][g2] * FP_MUL_MADS * live)


def bucket_bound(g2, inputs, n_out):
    """Bound of K3 on these inputs: every array once, one madd per point
    that sits in a counted bucket."""
    rows, order, start, count = inputs
    nbytes = 4 * (rows.numel() + order.numel() + start.numel() + count.numel() + n_out)
    return bound(nbytes, int(count.sum()) * POINT_MULS["madd"][g2] * FP_MUL_MADS)


def horner_bound(g2, windows, c):
    """Bound of K4: W window sums in, one point out, W (c dbl + 1 add)."""
    muls = windows * (c * POINT_MULS["dbl"][g2] + POINT_MULS["add"][g2])
    return bound(3 * (96 if g2 else 48) * (windows + 1), muls * FP_MUL_MADS)


def horner(coeffs, x, mod):
    y = 0
    for c in reversed(coeffs):
        y = (y * x + c) % mod
    return y


def random_fr_words(gen, shape, dev):
    """Uniform-ish Fr elements as (8, *shape) Montgomery words drawn on the
    card: seven free words and a top word below R's, so each is < R."""
    from kzg_tpu_torch.constants import R

    low = torch.randint(-(1 << 31), 1 << 31, (7,) + shape, generator=gen, device=dev,
                        dtype=torch.int64)
    top = torch.randint(0, R >> 224, (1,) + shape, generator=gen, device=dev,
                        dtype=torch.int64)
    return torch.cat([low, top]).to(torch.int32)


def random_fp2(gen, n, dev):
    """n nonzero-with-overwhelming-probability Fp2 elements, (12, 2, n)
    Montgomery words: eleven free words and a top word below P's."""
    from kzg_tpu_torch.constants import P

    low = torch.randint(-(1 << 31), 1 << 31, (11, 2, n), generator=gen, device=dev,
                        dtype=torch.int64)
    top = torch.randint(0, P >> 352, (1, 2, n), generator=gen, device=dev, dtype=torch.int64)
    return torch.cat([low, top]).to(torch.int32)


def max_abs_diff(a, b):
    a = a if isinstance(a, (tuple, list)) else (a,)
    b = b if isinstance(b, (tuple, list)) else (b,)
    return max(
        int((x.to(torch.int64) - y.to(torch.int64)).abs().max()) if x.numel() else 0
        for x, y in zip(a, b)
    )


def profile_phases(phases, card, out_path):
    """For each (name, fn): the wall time (host clock closed by a
    synchronize, median of 3 after a warm-up call), the port's launches in
    one call, the device time by kernel (`torch.profiler` self device time
    of one more call; only device-side events, the host-side operator
    events repeat the time of the kernels they launch) and the device's
    idle share, 1 - busy / wall (one stream, so kernels never overlap and
    the sum is the busy time). Printed, and written to out_path as JSON."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from kzg_tpu_torch import kernels

    results = []
    for name, fn in phases:
        fn()
        runs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
        wall = sorted(runs)[1]
        kernels.reset_launches()
        fn()
        torch.cuda.synchronize()
        launches = {k: v for k, v in kernels.launch_counts().items() if v}
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        by_kernel = {}
        for evt in prof.key_averages():
            us = getattr(evt, "self_device_time_total", None)
            if us is None:
                us = evt.self_cuda_time_total
            if us > 0 and evt.device_type == DeviceType.CUDA:
                by_kernel[evt.key] = by_kernel.get(evt.key, 0.0) + us / 1e3
        busy = sum(by_kernel.values())
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
        idle = max(0.0, 1.0 - busy / (wall * 1e3))
        log(f"[profile {name}] wall {wall * 1e3:.2f} ms "
            f"(runs {', '.join(f'{t * 1e3:.2f}' for t in runs)}), device busy {busy:.2f} ms, "
            f"idle share {idle:.3f} [{card}]")
        log(f"  launches: {launches}")
        for k, ms in top:
            log(f"  {ms:10.3f} ms  {k[:110]}")
        results.append({"phase": name, "wall_ms": wall * 1e3, "runs_ms": [t * 1e3 for t in runs],
                        "device_busy_ms": busy, "idle_share": idle, "launches": launches,
                        "device_ms_by_kernel": dict(top)})
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump({"card": card, "phases": results}, f, indent=1)
    log(f"  wrote {out_path}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", nargs="?", const=os.path.join("build", "profile_eval.json"),
                    metavar="JSON", help="after the checks, profile the evaluation-form path "
                    "phase by phase and write the table here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; a CUDA card is required",
              file=sys.stderr)
        return 1

    from kzg_tpu_torch import kernels, native
    from kzg_tpu_torch.config import get_config
    from kzg_tpu_torch.constants import P, R
    from kzg_tpu_torch.curve import G1, G2, cuda_ops, g1_from_device, g2_from_device
    from kzg_tpu_torch.fields import FP, FR
    from kzg_tpu_torch.fields import cuda_field
    from kzg_tpu_torch.kzg.coeff_form import (
        KZGProver, KZGVerifier, g1_compressed, g2_compressed,
    )
    from kzg_tpu_torch.kzg.eval_form import (
        KZGBatchWitnessEvalForm, KZGProverEvalForm, KZGVerifierEvalForm,
        compute_lagrange_basis, compute_lagrange_basis_from_secret,
    )
    from kzg_tpu_torch.kzg.srs import KZGParams, setup
    from kzg_tpu_torch.msm import msm_g1, msm_g2, pippenger
    from kzg_tpu_torch.ntt import Domain
    from kzg_tpu_torch.oracle import ec_add, ec_neg
    from kzg_tpu_torch.poly import Polynomial, lagrange_interpolation, vanishing_poly

    dev = torch.device("cuda", 0)
    report = {}

    # ---- 1. device -----------------------------------------------------------------
    with phase("device"):
        name = torch.cuda.get_device_name(0)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[0]
        card = smi
        log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, device {name}")
        log(f"  nvidia-smi: {smi}")

    # ---- 2. build ------------------------------------------------------------------
    with phase("build"):
        t0 = time.perf_counter()
        lib_path = kernels.build()
        kernels.library()
        log(f"  build seconds {time.perf_counter() - t0:.2f} -> {lib_path}")
        for line in (lib_path.parent / "ptxas.log").read_text().splitlines():
            if ("registers" in line or "spill" in line or "Compiling entry" in line
                    or line.startswith("nvcc seconds")):
                log(f"  ptxas: {line.strip()}")

    # the 2^15 SRS is needed by phases 3 and 5; setup launches no kernel
    with phase("srs 2^15"):
        key = hashlib.sha256(f"{SEED}:{N_MAIN}".encode()).hexdigest()[:16]
        cache = os.path.join(ROOT, "build", "kzg_tpu_torch", f"srs_{key}.npz")
        t0 = time.perf_counter()
        if os.path.exists(cache):
            params = KZGParams.load(cache, device=dev)
            how = "loaded from cache"
        else:
            params = setup(SEED, N_MAIN, device=dev)
            os.makedirs(os.path.dirname(cache), exist_ok=True)
            params.save(cache)
            how = "built on the host engine"
        setup_s = time.perf_counter() - t0
        log(f"  setup(secret, 2^15) {how} in {setup_s:.2f} s")

    rng = random.Random(SEED)
    kinfo = {k: {} for k in kernels.REGISTRY}

    # ---- 3. kernels against their plain twins ---------------------------------------------
    with phase("kernels vs plain"):
        # K1
        k1_err = 0
        for F, mod in ((FR, R), (FP, P)):
            xs = [0, 1, mod - 1] + [rng.randrange(mod) for _ in range(N_MAIN - 3)]
            ys = [mod - 1, mod - 1, mod - 1] + [rng.randrange(mod) for _ in range(N_MAIN - 3)]
            a = torch.from_numpy(F.encode(xs)).to(dev)
            b = torch.from_numpy(F.encode(ys)).to(dev)
            for op, opname in ((cuda_field.ADD, "add"), (cuda_field.SUB, "sub"),
                               (cuda_field.MUL, "mul")):
                got = cuda_field.binary(F, op, a, b)
                want = cuda_field.binary_plain(F, op, a, b)
                err = max_abs_diff(got, want)
                k1_err = max(k1_err, err)
                check(err == 0, f"K1 {F.name} {opname} 2^15 equals plain")
                ms = cuda_ms(lambda: cuda_field.binary(F, op, a, b), 50)
                pms = cuda_ms(lambda: cuda_field.binary_plain(F, op, a, b), 3)
                log(f"  K1 {F.name} {opname} 2^15: kernel {ms:.4f} ms, plain {pms:.4f} ms [{card}]")
                if F is FP and op == cuda_field.MUL:
                    kinfo["field_elementwise"].update(
                        ms=ms, plain_ms=pms, bound=bound(3 * 48 * N_MAIN, FP_MUL_MADS * N_MAIN))
            # the standalone entries over K1 (make_mul / make_add / make_sub)
            for make, op, opname in ((cuda_field.make_mul, cuda_field.MUL, "mul"),
                                     (cuda_field.make_add, cuda_field.ADD, "add"),
                                     (cuda_field.make_sub, cuda_field.SUB, "sub")):
                fn = make(F)
                err = max_abs_diff(fn(a, b), cuda_field.binary_plain(F, op, a, b))
                k1_err = max(k1_err, err)
                check(err == 0, f"K1 make_{opname}({F.name}) 2^15 equals plain")
                log(f"  K1 make_{opname}({F.name}) 2^15: kernel "
                    f"{cuda_ms(lambda: fn(a, b), 50):.4f} ms [{card}]")
            got = cuda_field.mul_const(F, a, F.r2_words)
            want = cuda_field.mul_const_plain(F, a, F.r2_words)
            err = max_abs_diff(got, want)
            k1_err = max(k1_err, err)
            check(err == 0, f"K1 {F.name} mul_const 2^15 equals plain")
            check(F.decode(got[:, :3]) == [(x * F.mont_r) % mod for x in xs[:3]],
                  f"K1 {F.name} to_mont edges against Python ints")
        kinfo["field_elementwise"]["max_abs_err"] = k1_err

        # K2: Jacobian points with random Z built from SRS points
        fplain = FP.as_plain()
        gx, gy, _ = params.gs

        def jacobian(x, y, zs):
            z = torch.from_numpy(FP.encode(zs)).to(dev)
            z2 = fplain.sqr(z)
            return (fplain.mul(x, z2), fplain.mul(y, fplain.mul(z2, z)), z)

        n = N_POINT
        p = jacobian(gx[:, :n], gy[:, :n], [rng.randrange(1, P) for _ in range(n)])
        q = jacobian(gx[:, n:2 * n], gy[:, n:2 * n], [rng.randrange(1, P) for _ in range(n)])
        p = tuple(t.clone() for t in p)
        q = tuple(t.clone() for t in q)
        lam = torch.from_numpy(FP.encode([rng.randrange(1, P)])).to(dev)[:, 0]
        lam2 = fplain.sqr(lam)
        # lane 0: P at infinity; 1: Q at infinity; 2: both; 3: Q = P with another Z;
        # 4: Q = -P; 5: Q = P word for word
        p[2][:, 0] = 0
        q[2][:, 1] = 0
        p[2][:, 2] = 0
        q[2][:, 2] = 0
        q[0][:, 3] = fplain.mul(p[0][:, 3], lam2)
        q[1][:, 3] = fplain.mul(p[1][:, 3], fplain.mul(lam2, lam))
        q[2][:, 3] = fplain.mul(p[2][:, 3], lam)
        q[0][:, 4] = p[0][:, 4]
        q[1][:, 4] = fplain.neg(p[1][:, 4])
        q[2][:, 4] = p[2][:, 4]
        for i in range(3):
            q[i][:, 5] = p[i][:, 5]
        got = cuda_ops.add(p, q)
        want = cuda_ops.add_plain(p, q)
        err = max_abs_diff(got, want)
        check(err == 0, "K2 add 2^12 (inf, P+P, P-P lanes) equals plain")
        check(bool(G1.is_inf(got)[4]) and not bool(G1.is_inf(got)[3]),
              "K2 add: P + (-P) is infinity, P + P is not")
        kinfo["g1_add"].update(
            max_abs_err=err,
            ms=cuda_ms(lambda: cuda_ops.add(p, q), 20),
            plain_ms=cuda_ms(lambda: cuda_ops.add_plain(p, q), 2),
            bound=point_bound("add", 0, n, 9),
        )
        got = cuda_ops.dbl(p)
        want = cuda_ops.dbl_plain(p)
        err = max_abs_diff(got, want)
        check(err == 0, "K2 dbl 2^12 equals plain")
        kinfo["g1_dbl"].update(
            max_abs_err=err,
            ms=cuda_ms(lambda: cuda_ops.dbl(p), 20),
            plain_ms=cuda_ms(lambda: cuda_ops.dbl_plain(p), 2),
            bound=point_bound("dbl", 0, n, 6),
        )

        def madd_case(curve, kname, kernel_fn, plain_fn, p_jac, qx, qy, jac_of, g2):
            """K6 on n lanes: lane 0 p infinite, 3 p == q under another Z,
            4 p == -q, every eighth lane skipped, the rest generic."""
            p_jac = tuple(t.clone() for t in p_jac)
            p_jac[2][..., 0] = 0
            same = jac_of(qx[..., 3:4], qy[..., 3:4])
            opp = jac_of(qx[..., 4:5], curve.f.neg(qy[..., 4:5]))
            for i in range(3):
                p_jac[i][..., 3] = same[i][..., 0]
                p_jac[i][..., 4] = opp[i][..., 0]
            skip = (torch.arange(n, device=dev) % 8) == 7
            got = kernel_fn(p_jac, (qx, qy), skip)
            want = plain_fn(p_jac, (qx, qy), skip)
            err = max_abs_diff(got, want)
            check(err == 0, f"K6 {kname} 2^12 (skip, inf, same, opposite lanes) equals plain")
            inf = curve.is_inf(got)
            check(bool(inf[4]) and not bool(inf[3]) and not bool(inf[0])
                  and all(torch.equal(g[..., 7], t[..., 7]) for g, t in zip(got, p_jac)),
                  f"K6 {kname}: P + (-P) is infinity, P + P and inf + Q are not, skip keeps P")
            kinfo[kname].update(
                max_abs_err=err,
                ms=cuda_ms(lambda: kernel_fn(p_jac, (qx, qy), skip), 20),
                plain_ms=cuda_ms(lambda: plain_fn(p_jac, (qx, qy), skip), 2),
                bound=bound((8 * (96 if g2 else 48) + 1) * n,
                            POINT_MULS["madd"][g2] * FP_MUL_MADS * int((~skip).sum())),
            )
            # all but the last ladder of a 2^12 group iNTT run on half batches
            h = n // 2
            half = [tuple(t[..., :h].contiguous() for t in x) for x in (p_jac, (qx, qy))]
            got = kernel_fn(*half, skip[:h])
            check(max_abs_diff(got, tuple(t[..., :h] for t in want)) == 0,
                  f"K6 {kname} 2^11 lanes equals plain")
            report[f"{kname}_2e11_ms"] = cuda_ms(lambda: kernel_fn(*half, skip[:h]), 20)
            log(f"  K6 {kname} at 2^11 lanes: kernel {report[f'{kname}_2e11_ms']:.4f} ms "
                f"[{card}]")

        def madd_multi_case(curve, kname, kernel_fn, plain_fn, pts, g2):
            """K7 at the shape a 2^12-point MSM gives it (c = 7: 16 steps over
            37 x 128 bucket lanes): the first two launches of the bucket loop
            on random scalars, from infinity and from the first one's sums;
            then the second with a neg mask, a lane whose step adds the
            accumulator's own point and a lane that adds its opposite."""
            c7 = pippenger.effective_window(n)
            fuse = get_config().msm_fuse_steps
            ints = [rng.randrange(R) for _ in range(n)]
            std = FR.from_mont(torch.from_numpy(FR.encode(ints)).to(dev))
            inputs = pippenger.bucket_inputs(*pts, std, c7)
            q0, skip0 = pippenger.loop_chunk(*inputs, 0, fuse)
            q1, skip1 = pippenger.loop_chunk(*inputs, fuse, fuse)
            q1 = tuple(t.contiguous() for t in q1)
            acc0 = curve.infinity(tuple(inputs[2].shape), dev)
            acc1 = kernel_fn(acc0, q0, skip0)
            err = max_abs_diff(acc1, plain_fn(acc0, q0, skip0))
            got = kernel_fn(acc1, q1, skip1)
            err = max(err, max_abs_diff(got, plain_fn(acc1, q1, skip1)))
            check(err == 0, f"K7 {kname} S={fuse}, lanes {tuple(skip0.shape[1:])} (c = {c7}) "
                  "equals plain on two launches of the bucket loop")
            ax, ay, ainf = curve.to_affine(acc1)
            check(not bool(ainf[0, 5]) and not bool(ainf[0, 6]), "planted lanes hold points")
            skip_p = skip1.clone()
            gen_m = torch.Generator(device=dev).manual_seed(SEED + 7)
            neg = torch.rand(skip1.shape, generator=gen_m, device=dev) < 0.3
            for b, negate in ((5, False), (6, True)):
                q1[0][..., 0, 0, b] = ax[..., 0, b]
                q1[1][..., 0, 0, b] = ay[..., 0, b]
                skip_p[0, 0, b] = False
                skip_p[1:, 0, b] = True
                neg[0, 0, b] = negate
            got = kernel_fn(acc1, q1, skip_p, neg)
            err = max(err, max_abs_diff(got, plain_fn(acc1, q1, skip_p, neg)))
            inf = curve.is_inf(got)
            check(err == 0 and bool(inf[0, 6]) and not bool(inf[0, 5]),
                  f"K7 {kname} with neg mask: P + P doubles, P + (-P) is infinity, equals plain")
            w_, b_ = tuple(skip1.shape[1:])
            lanes = w_ * b_
            kinfo[kname].update(
                max_abs_err=err,
                ms=cuda_ms(lambda: kernel_fn(acc1, q1, skip1), 10),
                plain_ms=cuda_ms(lambda: plain_fn(acc1, q1, skip1), 1),
                bound=bound(((6 + 2 * fuse) * (96 if g2 else 48) + 2 * fuse) * lanes,
                            POINT_MULS["madd"][g2] * FP_MUL_MADS * int((~skip1).sum())),
            )
            # the whole MSM on this route, and K4 at its window count
            acc = pippenger._bucket_loop(curve, *inputs)
            s_all = pippenger.weighted_bucket_sum(curve, acc)
            return ints, s_all, c7

        madd_case(G1, "g1_madd", cuda_ops.madd, cuda_ops.madd_plain, p,
                  gx[:, n:2 * n].contiguous(), gy[:, n:2 * n].contiguous(),
                  lambda x, y: jacobian(x, y, [rng.randrange(1, P)]), 0)

        # K7 over G1, and K4 at the window count of a 2^12-point MSM
        gs12 = tuple(t[..., :n].contiguous() for t in params.gs)
        ints12, s_all12, c12 = madd_multi_case(
            G1, "g1_madd_multi", cuda_ops.madd_multi, cuda_ops.madd_multi_plain, gs12, 0)
        got = cuda_ops.horner_join(s_all12, c12)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = cuda_ops.horner_join_plain(s_all12, c12)
        torch.cuda.synchronize()
        k4_12_plain_ms = (time.perf_counter() - t0) * 1e3
        k4_12_err = max_abs_diff(got, want)
        check(k4_12_err == 0,
              f"K4 horner_join W={s_all12[0].shape[-1]}, c={c12} equals plain")
        report["g1_horner_join_2e12_ms"] = cuda_ms(lambda: cuda_ops.horner_join(s_all12, c12), 5)
        log(f"  K4 W={s_all12[0].shape[-1]}, c={c12}: kernel "
            f"{report['g1_horner_join_2e12_ms']:.4f} ms, plain {k4_12_plain_ms:.2f} ms [{card}]")
        pts_host = g1_from_device(params.gs)
        check(g1_from_device(tuple(t[..., None] for t in got))[0]
              == native.g1_msm(pts_host[:n], ints12),
              "K7 + K2 + K4 MSM at 2^12 equals the native engine's")

        # K3 / K4: the buckets of one 2^15 MSM at c = 10
        scal = torch.from_numpy(FR.encode([rng.randrange(R) for _ in range(N_MAIN)])).to(dev)
        inputs = pippenger.bucket_inputs(gx, gy, params.gs[2], FR.from_mont(scal), C_MAIN)
        log(f"  K3 shapes: rows {tuple(inputs[0].shape)}, order {tuple(inputs[1].shape)}, "
            f"buckets {tuple(inputs[2].shape)}, fullest bucket {int(inputs[3].max())}")
        got = cuda_ops.bucket_accumulate(*inputs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = cuda_ops.bucket_accumulate_plain(*inputs)
        torch.cuda.synchronize()
        k3_plain_ms = (time.perf_counter() - t0) * 1e3
        err = max_abs_diff(got, want)
        check(err == 0, "K3 bucket_accumulate 2^15, c=10 equals plain")
        kinfo["g1_bucket_accumulate"].update(
            max_abs_err=err,
            ms=cuda_ms(lambda: cuda_ops.bucket_accumulate(*inputs), 5),
            plain_ms=k3_plain_ms,
            bound=bucket_bound(0, inputs, sum(t.numel() for t in got)),
        )
        s_all = pippenger.weighted_bucket_sum(G1, got)
        got = cuda_ops.horner_join(s_all, C_MAIN)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = cuda_ops.horner_join_plain(s_all, C_MAIN)
        torch.cuda.synchronize()
        k4_plain_ms = (time.perf_counter() - t0) * 1e3
        err = max_abs_diff(got, want)
        check(err == 0, f"K4 horner_join W={s_all[0].shape[-1]}, c=10 equals plain")
        kinfo["g1_horner_join"].update(
            max_abs_err=max(err, k4_12_err),
            ms=cuda_ms(lambda: cuda_ops.horner_join(s_all, C_MAIN), 5),
            plain_ms=k4_plain_ms,
            bound=horner_bound(0, s_all[0].shape[-1], C_MAIN),
        )
        scal_ints = FR.decode(scal)
        want_pt = native.g1_msm(pts_host, scal_ints)
        check(g1_from_device(tuple(t[..., None] for t in got))[0] == want_pt,
              "K3 + K2 + K4 MSM equals the native engine's")

        # K5: every stage of one 2^20 NTT, in the Pease layout (bt = 1, the
        # 2^20 half table) and in the four-step layout (two passes of
        # 2^10-point transforms over 2^10-lane rows), then the whole NTT
        dom20 = Domain(EXP_COSET)
        d20 = dom20.d
        x20 = random_fr_words(torch.Generator(device=dev).manual_seed(SEED), (d20,), dev)
        tw_pease = torch.from_numpy(Domain._powers(dom20.omega, d20 // 2)).to(dev)
        sub = Domain(EXP_COSET // 2)
        tw_fs = torch.from_numpy(Domain._powers(sub.omega, sub.d // 2)).to(dev)
        k5_err = 0
        stage_ms = {}
        for layout, x, tw in (("Pease", x20.reshape(FR.W, 1, d20, 1), tw_pease),
                              ("four-step", x20.reshape(FR.W, 1, sub.d, d20 // sub.d), tw_fs)):
            kms, pms = [], []
            for st in range(x.shape[2].bit_length() - 1):
                got = cuda_field.ntt_stage(x, tw, st)
                want = cuda_field.ntt_stage_layout_plain(x, tw, st)
                k5_err = max(k5_err, max_abs_diff(got, want))
                kms.append(cuda_ms(lambda: cuda_field.ntt_stage(x, tw, st), 10))
                pms.append(cuda_ms(lambda: cuda_field.ntt_stage_layout_plain(x, tw, st), 1))
                x = got
            stage_ms[layout] = (sum(kms) / len(kms), sum(pms) / len(pms), len(kms))
            check(k5_err == 0,
                  f"K5 {layout} layout, all {len(kms)} stages of 2^{EXP_COSET} equal plain")
            log(f"  K5 {layout} 2^{EXP_COSET} stage mean: kernel {stage_ms[layout][0]:.4f} ms, "
                f"plain {stage_ms[layout][1]:.4f} ms [{card}]")
        # the Pease transform verify_poly runs at 2^12: all 12 stages
        dom_e = Domain(EXP_EVAL)
        tw_e = torch.from_numpy(Domain._powers(dom_e.omega, dom_e.d // 2)).to(dev)
        x = x20[:, :dom_e.d].reshape(FR.W, 1, dom_e.d, 1)
        kms = []
        for st in range(EXP_EVAL):
            got = cuda_field.ntt_stage(x, tw_e, st)
            k5_err = max(k5_err, max_abs_diff(got, cuda_field.ntt_stage_layout_plain(x, tw_e, st)))
            kms.append(cuda_ms(lambda: cuda_field.ntt_stage(x, tw_e, st), 10))
            x = got
        check(k5_err == 0, f"K5 Pease layout, all {EXP_EVAL} stages of 2^{EXP_EVAL} equal plain")
        report["ntt_stage_2e12_ms"] = sum(kms) / len(kms)
        log(f"  K5 Pease 2^{EXP_EVAL} stage mean: kernel {report['ntt_stage_2e12_ms']:.4f} ms "
            f"[{card}]")
        got = dom20.ntt(x20)
        want = dom20.as_plain().ntt(x20)
        k5_err = max(k5_err, max_abs_diff(got, want))
        check(k5_err == 0, f"NTT 2^{EXP_COSET} (four-step, split tables) equals the plain twin")
        got_c = dom20.coset_intt(dom20.coset_ntt(x20))
        check(torch.equal(got_c, x20), f"coset_intt(coset_ntt(x)) == x at 2^{EXP_COSET}")
        ntt_ms = cuda_ms(lambda: dom20.ntt(x20), 5)
        ntt_plain_ms = cuda_ms(lambda: dom20.as_plain().ntt(x20), 1)
        log(f"  NTT 2^{EXP_COSET}: kernel {ntt_ms:.4f} ms, plain twin {ntt_plain_ms:.2f} ms "
            f"[{card}]")
        # a stage reads and writes the 2^20 elements once, and multiplies
        # 2^19 differences by a twiddle (the half table is 2^9 elements)
        kinfo["ntt_stage"].update(
            max_abs_err=k5_err, ms=stage_ms["four-step"][0], plain_ms=stage_ms["four-step"][1],
            bound=bound(32 * (2 * d20 + sub.d // 2), (FR_MUL_MADS + 4 * 8) * (d20 // 2)))
        report.update(ntt_2e20_ms=ntt_ms, ntt_2e20_plain_ms=ntt_plain_ms)

        # G2 add / dbl: SRS G2 points at random Fp2 Z, special lanes as K2
        f2 = cuda_ops.PLAIN2.f
        hx, hy, _ = params.hs

        def jacobian2(x, y, gen):
            z = random_fp2(gen, x.shape[-1], dev)
            z2 = f2.sqr(z)
            return (f2.mul(x, z2), f2.mul(y, f2.mul(z2, z)), z)

        gen2 = torch.Generator(device=dev).manual_seed(SEED + 2)
        p2 = tuple(t.clone() for t in jacobian2(hx[..., :n], hy[..., :n], gen2))
        q2 = tuple(t.clone() for t in jacobian2(hx[..., n:2 * n], hy[..., n:2 * n], gen2))
        lam = random_fp2(gen2, 1, dev)[..., 0]
        lam2 = f2.sqr(lam)
        p2[2][..., 0] = 0
        q2[2][..., 1] = 0
        p2[2][..., 2] = 0
        q2[2][..., 2] = 0
        q2[0][..., 3] = f2.mul(p2[0][..., 3], lam2)
        q2[1][..., 3] = f2.mul(p2[1][..., 3], f2.mul(lam2, lam))
        q2[2][..., 3] = f2.mul(p2[2][..., 3], lam)
        q2[0][..., 4] = p2[0][..., 4]
        q2[1][..., 4] = f2.neg(p2[1][..., 4])
        q2[2][..., 4] = p2[2][..., 4]
        for i in range(3):
            q2[i][..., 5] = p2[i][..., 5]
        got = cuda_ops.g2_add(p2, q2)
        want = cuda_ops.g2_add_plain(p2, q2)
        err = max_abs_diff(got, want)
        check(err == 0, "G2 add 2^12 (inf, P+P, P-P lanes) equals plain")
        check(bool(G2.is_inf(got)[4]) and not bool(G2.is_inf(got)[3]),
              "G2 add: P + (-P) is infinity, P + P is not")
        kinfo["g2_add"].update(
            max_abs_err=err,
            ms=cuda_ms(lambda: cuda_ops.g2_add(p2, q2), 10),
            plain_ms=cuda_ms(lambda: cuda_ops.g2_add_plain(p2, q2), 1),
            bound=point_bound("add", 1, n, 9),
        )
        got = cuda_ops.g2_dbl(p2)
        err = max_abs_diff(got, cuda_ops.g2_dbl_plain(p2))
        check(err == 0, "G2 dbl 2^12 equals plain")
        kinfo["g2_dbl"].update(
            max_abs_err=err,
            ms=cuda_ms(lambda: cuda_ops.g2_dbl(p2), 10),
            plain_ms=cuda_ms(lambda: cuda_ops.g2_dbl_plain(p2), 1),
            bound=point_bound("dbl", 1, n, 6),
        )
        madd_case(G2, "g2_madd", cuda_ops.g2_madd, cuda_ops.g2_madd_plain, p2,
                  hx[..., n:2 * n].contiguous(), hy[..., n:2 * n].contiguous(),
                  lambda x, y: jacobian2(x, y, gen2), 1)

        # K7 over Fp2, and K4 over Fp2 at the window count of a 2^12-point MSM
        hs12 = tuple(t[..., :n].contiguous() for t in params.hs)
        ints2, s_all2, c2 = madd_multi_case(
            G2, "g2_madd_multi", cuda_ops.g2_madd_multi, cuda_ops.g2_madd_multi_plain, hs12, 1)
        hs_host = g2_from_device(params.hs)
        check(g2_from_device(tuple(t[..., None] for t in cuda_ops.horner_join(s_all2, c2)))[0]
              == native.g2_msm(hs_host[:n], ints2),
              "K7-G2 + G2 add/dbl + K4-G2 MSM at 2^12 equals the native engine's")

        def g2_bucket_kernels(pts, ints, c, label):
            """K3 and K4 over Fp2 against their twins on one dense MSM's
            buckets; returns (errors, kernel ms, plain ms, bounds)."""
            std = FR.from_mont(torch.from_numpy(FR.encode(ints)).to(dev))
            inputs2 = pippenger.bucket_inputs(*pts, std, c)
            log(f"  K3-G2 {label} shapes: rows {tuple(inputs2[0].shape)}, order "
                f"{tuple(inputs2[1].shape)}, buckets {tuple(inputs2[2].shape)}, fullest bucket "
                f"{int(inputs2[3].max())}")
            got = cuda_ops.bucket_accumulate(*inputs2)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = cuda_ops.bucket_accumulate_plain(*inputs2)
            torch.cuda.synchronize()
            k3_plain = (time.perf_counter() - t0) * 1e3
            k3_err = max_abs_diff(got, want)
            check(k3_err == 0, f"K3-G2 bucket_accumulate {label}, c={c} equals plain")
            k3_ms = cuda_ms(lambda: cuda_ops.bucket_accumulate(*inputs2), 5)
            k3_bound = bucket_bound(1, inputs2, sum(t.numel() for t in got))
            s_all = pippenger.weighted_bucket_sum(G2, got)
            got = cuda_ops.horner_join(s_all, c)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = cuda_ops.horner_join_plain(s_all, c)
            torch.cuda.synchronize()
            k4_plain = (time.perf_counter() - t0) * 1e3
            k4_err = max_abs_diff(got, want)
            windows = s_all[0].shape[-1]
            check(k4_err == 0, f"K4-G2 horner_join W={windows}, c={c} equals plain")
            k4_ms = cuda_ms(lambda: cuda_ops.horner_join(s_all, c), 5)
            check(g2_from_device(tuple(t[..., None] for t in got))[0]
                  == native.g2_msm(hs_host[:len(ints)], ints),
                  f"K3-G2 + G2 add/dbl + K4-G2 MSM {label} equals the native engine's")
            log(f"  K3-G2 {label}: kernel {k3_ms:.4f} ms, plain {k3_plain:.2f} ms; K4-G2 "
                f"W={windows}, c={c}: kernel {k4_ms:.4f} ms, plain {k4_plain:.2f} ms [{card}]")
            return ((k3_err, k4_err), (k3_ms, k4_ms), (k3_plain, k4_plain),
                    (k3_bound, horner_bound(1, windows, c)))

        # a dense 2^12-point MSM's buckets through K3 (c = 7; the MSM itself
        # takes the bucket loop at this size), then the shape the G2 MSM
        # path gives K3 and K4: 2^15 points, c = 10
        errs12, ms12, _, _ = g2_bucket_kernels(hs12, ints2, c2, "2^12")
        report.update(g2_bucket_accumulate_2e12_ms=ms12[0], g2_horner_join_2e12_ms=ms12[1])
        errs, ms, plain, bounds = g2_bucket_kernels(params.hs, scal_ints, C_MAIN, "2^15")
        for i, kname in enumerate(("g2_bucket_accumulate", "g2_horner_join")):
            kinfo[kname].update(max_abs_err=max(errs[i], errs12[i]), ms=ms[i],
                                plain_ms=plain[i], bound=bounds[i])
        for k, v in kinfo.items():
            log(f"  {k}: kernel {v['ms']:.4f} ms, plain {v['plain_ms']:.2f} ms, bound "
                f"{v['bound'][0]:.6f} ms ({v['bound'][1]}) [{card}]")

    # ---- 4-5. the main path, counted ---------------------------------------------------------
    kernels.reset_launches()

    with phase("golden coeff_2e10"):
        vec = json.load(open(os.path.join(ROOT, "tests", "vectors.json")))
        v = vec["configs"]["coeff_2e10"]
        grng = random.Random(vec["seed"])
        coeffs = [grng.randrange(R) for _ in range(v["n"])]
        x = grng.randrange(R)
        check(hex(x) == v["open_x"], "seed stream reproduces open_x")
        y = horner(coeffs, x, R)
        gparams = setup(int(vec["secret"], 16), v["n"], device=dev)
        prover = KZGProver(gparams)
        poly = Polynomial.from_ints(coeffs, device=dev)
        commitment = prover.commit(poly)
        check(g1_compressed(commitment).hex() == v["commit"], "commitment bytes")
        witness = prover.create_witness(poly, (x, y))
        check(g1_compressed(witness).hex() == v["witness"], "witness bytes")
        verifier = KZGVerifier(gparams)
        check(verifier.verify_eval((x, y), commitment, witness), "verify_eval accepts")
        check(not verifier.verify_eval((x, (y + 1) % R), commitment, witness),
              "verify_eval rejects a tampered y")

    with phase("main path 2^15"):
        coeffs = [rng.randrange(R) for _ in range(N_MAIN)]
        poly = Polynomial.from_ints(coeffs, device=dev)
        prover = KZGProver(params)
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            commitment = prover.commit(poly)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        commit_s = sorted(times)[1]
        t0 = time.perf_counter()
        want_pt = native.g1_msm(pts_host, coeffs)
        native_s = time.perf_counter() - t0
        check(g1_from_device(tuple(t[..., None] for t in commitment))[0] == want_pt,
              "2^15 commitment equals native.g1_msm (affine)")
        x = rng.randrange(R)
        y = horner(coeffs, x, R)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        witness = prover.create_witness(poly, (x, y))
        torch.cuda.synchronize()
        witness_s = time.perf_counter() - t0
        verifier = KZGVerifier(params)
        t0 = time.perf_counter()
        ok = verifier.verify_eval((x, y), commitment, witness)
        verify_s = time.perf_counter() - t0
        check(ok, "2^15 verify_eval accepts")
        check(not verifier.verify_eval((x, (y + 1) % R), commitment, witness),
              "2^15 verify_eval rejects a tampered y")
        log(f"  2^15 commit {commit_s:.4f} s (runs {', '.join(f'{t:.4f}' for t in times)}), "
            f"{N_MAIN / commit_s:.0f} points/s; witness {witness_s:.4f} s; "
            f"verify {verify_s:.4f} s; native host MSM {native_s:.4f} s; setup {setup_s:.2f} s "
            f"[{card}]")
        report.update(commit_s=commit_s, witness_s=witness_s, verify_s=verify_s,
                      points_per_s=N_MAIN / commit_s)

    # ---- 6. launch counts of the single-opening path ---------------------------------------------
    with phase("launch counts 4-5"):
        counts_single = kernels.launch_counts()
        log(f"  {counts_single}")
        for k in ("field_elementwise", "g1_add", "g1_dbl", "g1_bucket_accumulate",
                  "g1_madd_multi", "g1_horner_join"):
            check(counts_single[k] > 0,
                  f"{k} launched {counts_single[k]} times on the single-opening path")

    # ---- 7-9. the batched opening, counted --------------------------------------------------------
    kernels.reset_launches()

    with phase("golden batched_2e8_k16"):
        bv = vec["configs"]["batched_2e8_k16"]
        grng = random.Random(vec["seed"])
        for _ in range(v["n"] + 1):  # the generator consumed coeff_2e10 first
            grng.randrange(R)
        coeffs = [grng.randrange(R) for _ in range(bv["n"])]
        xs = [grng.randrange(R) for _ in range(bv["k"])]
        check([hex(x) for x in xs] == bv["xs"], "seed stream reproduces xs")
        ys = [horner(coeffs, x, R) for x in xs]
        bparams = setup(int(vec["secret"], 16), bv["n"], device=dev)
        prover = KZGProver(bparams)
        poly = Polynomial.from_ints(coeffs, device=dev)
        commitment = prover.commit(poly)
        check(g1_compressed(commitment).hex() == bv["commit"], "commitment bytes")
        bw = prover.create_witness_batched(poly, xs, ys)
        check(g1_compressed(bw.w).hex() == bv["witness"], "batched witness bytes")
        z = vanishing_poly(torch.from_numpy(FR.encode(xs)).to(dev))
        hz = msm_g2(tuple(t[..., : z.num_coeffs()] for t in bparams.hs), z.trimmed())
        check(g2_compressed(hz).hex() == bv["h_z"], "h^Z bytes (G2 ladder MSM)")
        gr = msm_g1(tuple(t[..., : bw.r.num_coeffs()] for t in bparams.gs), bw.r.trimmed())
        check(g1_compressed(gr).hex() == bv["g_r"], "g^r bytes")
        check(KZGVerifier(bparams).verify_eval_batched(commitment, bw, xs),
              "verify_eval_batched accepts")

    with phase(f"batched 2^15, k = {K_BATCH}"):
        coeffs = [rng.randrange(R) for _ in range(N_MAIN)]
        poly = Polynomial.from_ints(coeffs, device=dev)
        xs = [rng.randrange(R) for _ in range(K_BATCH)]
        ys = [horner(coeffs, x, R) for x in xs]
        prover = KZGProver(params)
        commitment = prover.commit(poly)
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bw = prover.create_witness_batched(poly, xs, ys)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        bwitness_s = sorted(times)[1]
        verifier = KZGVerifier(params)
        t0 = time.perf_counter()
        ok = verifier.verify_eval_batched(commitment, bw, xs)
        bverify_s = time.perf_counter() - t0
        check(ok, "2^15, k = 16 verify_eval_batched accepts")
        other = list(xs)
        other[0] = (other[0] + 1) % R
        check(not verifier.verify_eval_batched(commitment, bw, other),
              "2^15, k = 16 verify_eval_batched rejects other xs")
        log(f"  batched 2^15, k = {K_BATCH}: witness {bwitness_s:.4f} s "
            f"(runs {', '.join(f'{t:.4f}' for t in times)}), verify {bverify_s:.4f} s [{card}]")
        report.update(batched_witness_s=bwitness_s, batched_verify_s=bverify_s)

    with phase(f"coset division 2^{EXP_COSET}"):
        n = 1 << EXP_COSET
        gen = torch.Generator(device=dev).manual_seed(SEED + 3)
        poly = Polynomial(random_fr_words(gen, (n,), dev))
        xs = [rng.randrange(R) for _ in range(K_BATCH)]
        xs_d = torch.from_numpy(FR.encode(xs)).to(dev)
        numerator = poly - lagrange_interpolation(xs_d, poly.eval_many(xs_d))
        z = vanishing_poly(xs_d)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        q = KZGProver._exact_div(numerator, z, xs_int=xs)
        torch.cuda.synchronize()
        div_s = time.perf_counter() - t0
        check(q.num_coeffs() == n - K_BATCH, f"quotient has {n - K_BATCH} coefficients")
        num_ints = numerator.to_ints()
        q_ints = q.to_ints()
        z_ints = z.to_ints()
        for t in (rng.randrange(R), rng.randrange(R)):
            check(horner(q_ints, t, R) * horner(z_ints, t, R) % R == horner(num_ints, t, R),
                  "q(t) Z(t) == numerator(t) at a random t (host ints)")
        log(f"  coset division 2^{EXP_COSET} (k = {K_BATCH}) {div_s:.4f} s; NTT 2^{EXP_COSET} "
            f"kernel {ntt_ms:.4f} ms, plain twin {ntt_plain_ms:.2f} ms [{card}]")
        report.update(coset_div_2e20_s=div_s)

    # ---- 10. launch counts of the batched path ---------------------------------------------------
    with phase("launch counts 7-9"):
        counts_batched = kernels.launch_counts()
        log(f"  {counts_batched}")
        for k in ("field_elementwise", "g1_add", "g1_dbl", "g1_bucket_accumulate",
                  "g1_madd_multi", "g1_horner_join", "ntt_stage", "g2_add", "g2_dbl"):
            check(counts_batched[k] > 0,
                  f"{k} launched {counts_batched[k]} times on the batched path")

    # the Lagrange build timed group by group, outside the counted run
    # (compute_lagrange_basis below runs both groups again)
    d = 1 << EXP_EVAL
    sub_params = KZGParams(gs=tuple(t[..., :d] for t in params.gs),
                           hs=tuple(t[..., :d] for t in params.hs), n=d)
    dom12 = Domain(EXP_EVAL)
    with phase(f"group iNTT 2^{EXP_EVAL}, G1 and G2"):
        from kzg_tpu_torch.kzg import eval_form

        group_s = {}
        basis = {}
        for curve, src in ((G1, sub_params.gs), (G2, sub_params.hs)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            basis[curve.name] = curve.to_affine(eval_form._group_intt(curve, src, dom12))
            torch.cuda.synchronize()
            group_s[curve.name] = time.perf_counter() - t0

    # ---- 11-13. the G2 MSM and the evaluation-form path, counted --------------------------------
    kernels.reset_launches()

    # G2 Pippenger against the native engine: the bucket loop on K7 at 2^12, K3 at 2^15
    with phase("G2 MSM 2^12, 2^15"):
        for exp in (EXP_EVAL, N_MAIN.bit_length() - 1):
            m = 1 << exp
            ints = [rng.randrange(R) for _ in range(m)]
            scal = torch.from_numpy(FR.encode(ints)).to(dev)
            pts = tuple(t[..., :m].contiguous() for t in params.hs)
            times = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = msm_g2(pts, scal)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            g2_s = sorted(times)[1]
            t0 = time.perf_counter()
            want_pt = native.g2_msm(hs_host[:m], ints)
            native_s = time.perf_counter() - t0
            check(g2_from_device(tuple(t[..., None] for t in got))[0] == want_pt,
                  f"msm_g2 2^{exp} (Pippenger, c = {pippenger.effective_window(m)}) equals "
                  "native.g2_msm")
            log(f"  msm_g2 2^{exp}: {g2_s:.4f} s (runs {', '.join(f'{t:.4f}' for t in times)}), "
                f"{m / g2_s:.0f} points/s; native host g2_msm {native_s:.4f} s [{card}]")
            report[f"msm_g2_2e{exp}_s"] = g2_s


    with phase("golden eval_2e7"):
        ev = vec["configs"]["eval_2e7"]
        grng = random.Random(vec["seed"])
        for _ in range(v["n"] + 1 + bv["n"] + bv["k"]):  # the two earlier configs' draws
            grng.randrange(R)
        d7 = 1 << ev["exp"]
        evals = [grng.randrange(R) for _ in range(d7)]
        check(hex(evals[ev["index"]]) == ev["y"], "seed stream reproduces y")
        secret = int(vec["secret"], 16)
        eparams = setup(secret, d7, device=dev)
        lag7 = compute_lagrange_basis_from_secret(secret, ev["exp"], device=dev)
        eprover = KZGProverEvalForm(eparams, lag7)
        evals_d = torch.from_numpy(FR.encode(evals)).to(dev)
        commitment = eprover.commit(evals_d)
        check(g1_compressed(commitment).hex() == ev["commit"], "commitment bytes")
        witness = eprover.create_witness(evals_d, ev["index"])
        check(g1_compressed(witness).hex() == ev["witness"], "witness bytes")
        check(KZGVerifierEvalForm(eparams, lag7).verify_eval(
            (ev["index"], evals[ev["index"]]), commitment, witness), "verify_eval accepts")

    with phase(f"eval path 2^{EXP_EVAL}"):
        t0 = time.perf_counter()
        lag = compute_lagrange_basis(sub_params, EXP_EVAL)
        torch.cuda.synchronize()
        lagrange_s = time.perf_counter() - t0
        check(all(torch.equal(a, b) for a, b in
                  zip(lag.lg + lag.lh, basis["G1"] + basis["G2"])),
              "compute_lagrange_basis equals the per-group iNTTs")
        t0 = time.perf_counter()
        ref = compute_lagrange_basis_from_secret(SEED, EXP_EVAL, device=dev)
        secret_s = time.perf_counter() - t0
        check(all(torch.equal(a, b) for a, b in zip(lag.lg, ref.lg)),
              f"trusted Lagrange G1 basis equals the from-secret basis, all {d} points")
        check(all(torch.equal(a, b) for a, b in zip(lag.lh, ref.lh)),
              f"trusted Lagrange G2 basis equals the from-secret basis, all {d} points")
        log(f"  Lagrange SRS 2^{EXP_EVAL}: group iNTT G1 {group_s['G1']:.4f} s, G2 "
            f"{group_s['G2']:.4f} s, compute_lagrange_basis {lagrange_s:.4f} s; from the secret "
            f"on the host engine {secret_s:.4f} s [{card}]")

        evals = [rng.randrange(R) for _ in range(d)]
        evals_d = torch.from_numpy(FR.encode(evals)).to(dev)
        eprover = KZGProverEvalForm(sub_params, lag)
        everifier = KZGVerifierEvalForm(sub_params, lag)

        def median3(fn):
            times = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn()
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            return out, sorted(times)[1], times

        commitment, ecommit_s, ctimes = median3(lambda: eprover.commit(evals_d))
        lg_host = g1_from_device(lag.lg)
        check(g1_from_device(tuple(t[..., None] for t in commitment))[0]
              == native.g1_msm(lg_host, evals), "eval-form commitment equals native.g1_msm")
        coeff_commit = KZGProver(sub_params).commit(Polynomial(dom12.intt(evals_d)))
        check(bool(G1.eq(commitment, coeff_commit)),
              "commit(evals) == KZGProver.commit(Polynomial(intt(evals)))")
        index = 1234
        witness, ewitness_s, wtimes = median3(lambda: eprover.create_witness(evals_d, index))
        t0 = time.perf_counter()
        ok = everifier.verify_eval((index, evals[index]), commitment, witness)
        everify_s = time.perf_counter() - t0
        check(ok, "verify_eval accepts")
        check(not everifier.verify_eval((index, (evals[index] + 1) % R), commitment, witness),
              "verify_eval rejects a tampered evaluation")
        check(not everifier.verify_eval((index + 1, evals[index]), commitment, witness),
              "verify_eval rejects a wrong index")
        for edge in (0, d - 1):
            w_edge = eprover.create_witness(evals_d, edge)
            check(everifier.verify_eval((edge, evals[edge]), commitment, w_edge),
                  f"witness at index {edge} verifies")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ok = everifier.verify_poly(commitment, evals_d)
        vpoly_s = time.perf_counter() - t0
        check(ok, "verify_poly accepts (iNTT + monomial MSM)")
        bw = KZGBatchWitnessEvalForm(r=evals_d, w=eprover.create_witness_all())
        t0 = time.perf_counter()
        ok = everifier.verify_eval_all(commitment, bw)
        vall_s = time.perf_counter() - t0
        check(ok, "verify_eval_all accepts (G2 Pippenger over the Lagrange G2 points)")
        tampered = evals_d.clone()
        tampered[:, 7] = evals_d[:, 8]
        check(not everifier.verify_eval_all(
            commitment, KZGBatchWitnessEvalForm(r=tampered, w=bw.w)),
            "verify_eval_all rejects a tampered evaluation vector")
        z = FR.zeros((d,), dev)
        z[:, 0] = FR.neg(FR.one((), dev))
        z[:, d - 1] = FR.one((), dev)
        lh_host = g2_from_device(tuple(t[..., [0, d - 1]] for t in lag.lh))
        check(g2_from_device(tuple(t[..., None] for t in msm_g2(lag.lh, z)))[0]
              == ec_add(lh_host[1], ec_neg(lh_host[0])),
              "h^z of the all-points check equals lh[d-1] - lh[0] (oracle)")
        log(f"  eval 2^{EXP_EVAL}: commit {ecommit_s:.4f} s "
            f"(runs {', '.join(f'{t:.4f}' for t in ctimes)}), {d / ecommit_s:.0f} points/s; "
            f"witness {ewitness_s:.4f} s (runs {', '.join(f'{t:.4f}' for t in wtimes)}); "
            f"verify_eval {everify_s:.4f} s; verify_poly {vpoly_s:.4f} s; "
            f"verify_eval_all {vall_s:.4f} s [{card}]")
        report.update(lagrange_g1_s=group_s["G1"], lagrange_g2_s=group_s["G2"],
                      eval_commit_s=ecommit_s, eval_witness_s=ewitness_s,
                      eval_verify_s=everify_s, eval_verify_poly_s=vpoly_s,
                      eval_verify_all_s=vall_s)

    # ---- 14. launch counts of the evaluation-form path ---------------------------------------
    with phase("launch counts 11-13"):
        counts_eval = kernels.launch_counts()
        log(f"  {counts_eval}")
        for k, n_launch in counts_eval.items():
            # a 2^12-point G1 MSM takes the bucket loop on K7, so this run
            # gives the G1 instantiation of K3 nothing
            check(n_launch > 0 or k == "g1_bucket_accumulate",
                  f"{k} launched {n_launch} times on the G2 MSM and evaluation-form path")
        counts = {k: counts_single[k] + counts_batched[k] + counts_eval[k] for k in counts_eval}

    if args.profile:
        with phase(f"profile of the evaluation-form path 2^{EXP_EVAL}"):
            dense = torch.from_numpy(FR.encode([rng.randrange(R) for _ in range(d)])).to(dev)
            dense15 = torch.from_numpy(
                FR.encode([rng.randrange(R) for _ in range(N_MAIN)])).to(dev)
            profile_phases([
                ("lagrange G1 group iNTT",
                 lambda: G1.to_affine(eval_form._group_intt(G1, sub_params.gs, dom12))),
                ("lagrange G2 group iNTT",
                 lambda: G2.to_affine(eval_form._group_intt(G2, sub_params.hs, dom12))),
                ("commit", lambda: eprover.commit(evals_d)),
                ("create_witness", lambda: eprover.create_witness(evals_d, d // 3)),
                ("verify_poly", lambda: everifier.verify_poly(commitment, evals_d)),
                ("msm_g2 all-points vector", lambda: msm_g2(lag.lh, z)),
                ("verify_eval_all", lambda: everifier.verify_eval_all(commitment, bw)),
                ("msm_g2 dense 2^12", lambda: msm_g2(lag.lh, dense)),
                ("msm_g2 dense 2^15", lambda: msm_g2(params.hs, dense15)),
            ], card, args.profile)

    kreport = {"kernels": [
        {
            "name": k.name,
            "route": "cuda",
            "source": k.source,
            "replaces": k.replaces,
            "launches": counts[k.name],
            "max_abs_err": kinfo[k.name]["max_abs_err"],
            "ms": kinfo[k.name]["ms"],
            "plain_ms": kinfo[k.name]["plain_ms"],
            "bound_ms": kinfo[k.name]["bound"][0],
            "bound_by": kinfo[k.name]["bound"][1],
            "library_ms": None,
        }
        for k in kernels.REGISTRY.values()
    ]}
    log("main paths: " + ", ".join(f"{k} {v}" for k, v in report.items()) + f" [{card}]")
    log(json.dumps(kreport))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
