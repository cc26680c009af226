"""Drive the PyTorch + CUDA port (kzg_tpu_torch) on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

Phases, each printed with its result and wall time; any failure exits
non-zero before the result line:
  1. device   - a CUDA card is required; prints its name and power limit;
  2. build    - compiles the port's kernels (nvcc, sm_90a) from the sources;
  3. kernels  - every kernel against its plain PyTorch twin on the card, at
                main-path shapes, exact equality (all of it is integer math):
                K1 field ops at 2^15 (Fr and Fp, edges 0, 1, p-1), K2 add/dbl
                on 2^12 points (infinity, P+P, P+(-P) lanes), K3 one 2^15
                MSM's buckets at c = 10, K4 the window join of those buckets;
  4. golden   - the coeff_2e10 vector of tests/vectors.json: setup, commit,
                witness bytes, verify accepts, tampered y rejected;
  5. 2^15     - setup (host engine; cached under build/kzg_tpu_torch/),
                commit of a seeded random polynomial checked against the
                native engine's MSM, witness, verify, tampered y rejected;
  6. counts   - kernel launch counts of phases 4-5, each must be > 0.
The last lines are the kernel report, the nvidia-smi line, and
{"ok": true, "device": {...}}.
"""

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


def max_abs_diff(a, b):
    a = a if isinstance(a, (tuple, list)) else (a,)
    b = b if isinstance(b, (tuple, list)) else (b,)
    return max(
        int((x.to(torch.int64) - y.to(torch.int64)).abs().max()) if x.numel() else 0
        for x, y in zip(a, b)
    )


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; a CUDA card is required",
              file=sys.stderr)
        return 1

    from kzg_tpu_torch import kernels, native
    from kzg_tpu_torch.constants import P, R
    from kzg_tpu_torch.curve import G1, cuda_ops, g1_from_device
    from kzg_tpu_torch.fields import FP, FR
    from kzg_tpu_torch.fields import cuda_field
    from kzg_tpu_torch.kzg.coeff_form import KZGProver, KZGVerifier, g1_compressed
    from kzg_tpu_torch.kzg.srs import KZGParams, setup
    from kzg_tpu_torch.msm import pippenger
    from kzg_tpu_torch.poly import Polynomial

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
            if "registers" in line or "spill" in line or "Compiling entry" in line:
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
                    kinfo["field_elementwise"].update(ms=ms, plain_ms=pms)
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
        )
        got = cuda_ops.dbl(p)
        want = cuda_ops.dbl_plain(p)
        err = max_abs_diff(got, want)
        check(err == 0, "K2 dbl 2^12 equals plain")
        kinfo["g1_dbl"].update(
            max_abs_err=err,
            ms=cuda_ms(lambda: cuda_ops.dbl(p), 20),
            plain_ms=cuda_ms(lambda: cuda_ops.dbl_plain(p), 2),
        )

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
        kinfo["bucket_accumulate"].update(
            max_abs_err=err,
            ms=cuda_ms(lambda: cuda_ops.bucket_accumulate(*inputs), 5),
            plain_ms=k3_plain_ms,
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
        kinfo["horner_join"].update(
            max_abs_err=err,
            ms=cuda_ms(lambda: cuda_ops.horner_join(s_all, C_MAIN), 5),
            plain_ms=k4_plain_ms,
        )
        pts_host = g1_from_device(params.gs)
        scal_ints = FR.decode(scal)
        want_pt = native.g1_msm(pts_host, scal_ints)
        check(g1_from_device(tuple(t[..., None] for t in got))[0] == want_pt,
              "K3 + K2 + K4 MSM equals the native engine's")
        for k, v in kinfo.items():
            log(f"  {k}: kernel {v['ms']:.4f} ms, plain {v['plain_ms']:.2f} ms [{card}]")

    # ---- 4-5. the main path, counted ---------------------------------------------------------
    kernels.reset_launches()

    with phase("golden coeff_2e10"):
        vec = json.load(open(os.path.join(ROOT, "tests", "vectors.json")))
        v = vec["configs"]["coeff_2e10"]
        grng = random.Random(vec["seed"])
        coeffs = [grng.randrange(R) for _ in range(v["n"])]
        x = grng.randrange(R)
        check(hex(x) == v["open_x"], "seed stream reproduces open_x")
        y = 0
        for c in reversed(coeffs):
            y = (y * x + c) % R
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
        y = 0
        for c in reversed(coeffs):
            y = (y * x + c) % R
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

    # ---- 6. launch counts of the main path ------------------------------------------------------
    with phase("launch counts"):
        counts = kernels.launch_counts()
        log(f"  {counts}")
        for k, n_launch in counts.items():
            check(n_launch > 0, f"{k} launched {n_launch} times on the main path")

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
        }
        for k in kernels.REGISTRY.values()
    ]}
    log("main path 2^15: " + ", ".join(f"{k} {v}" for k, v in report.items()) + f" [{card}]")
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
