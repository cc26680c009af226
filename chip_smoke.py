"""Drive the PyTorch + CUDA port (kzg_tpu_torch) on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

Phases, each printed with its result and wall time; any failure exits
non-zero before the result line:
  1. device   - a CUDA card is required; prints its name and power limit;
  2. build    - compiles the port's kernels (nvcc, sm_90a) from the sources,
                one nvcc per source, all started together;
  3. kernels  - every kernel against its plain PyTorch twin on the card, at
                main-path shapes, exact equality (all of it is integer math):
                K1 field ops at 2^15 (Fr and Fp, edges 0, 1, p-1), K2 add/dbl
                on 2^12 points (infinity, P+P, P+(-P) lanes), K3 one 2^15
                MSM's buckets at c = 10, K4 the window join of those buckets,
                K5 every stage of a 2^20 NTT in the Pease layout and in the
                four-step layout, and the whole 2^20 NTT against the
                domain's plain twin, G2 add/dbl on 2^12 points (special
                lanes as K2);
  4. golden   - the coeff_2e10 vector of tests/vectors.json: setup, commit,
                witness bytes, verify accepts, tampered y rejected;
  5. 2^15     - setup (host engine; cached under build/kzg_tpu_torch/),
                commit of a seeded random polynomial checked against the
                native engine's MSM, witness, verify, tampered y rejected;
  6. counts   - kernel launch counts of phases 4-5 (reset just before
                phase 4), K1-K4 must each be > 0;
  7. golden   - the batched_2e8_k16 vector: commit, batched witness, h^Z
                (G2) and g^r bytes, verify_eval_batched accepts;
  8. batched  - 2^15 coefficients opened at k = 16 points on the 2^15 SRS:
                commit, create_witness_batched, verify_eval_batched
                accepts, other xs rejected;
  9. coset    - the batched quotient's coset division alone at 2^20: a
                seeded numerator f - r divided by a 16-point Z, q Z ==
                numerator checked at two random points with host ints;
 10. counts   - launch counts of phases 7-9 (reset just before phase 7),
                every kernel must be > 0.
The last lines are the kernel report (launches of both counted runs), the
nvidia-smi line, and {"ok": true, "device": {...}}.
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
K_BATCH = 16
EXP_COSET = 20
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; a CUDA card is required",
              file=sys.stderr)
        return 1

    from kzg_tpu_torch import kernels, native
    from kzg_tpu_torch.constants import P, R
    from kzg_tpu_torch.curve import G1, G2, cuda_ops, g1_from_device
    from kzg_tpu_torch.fields import FP, FR
    from kzg_tpu_torch.fields import cuda_field
    from kzg_tpu_torch.kzg.coeff_form import (
        KZGProver, KZGVerifier, g1_compressed, g2_compressed,
    )
    from kzg_tpu_torch.kzg.srs import KZGParams, setup
    from kzg_tpu_torch.msm import msm_g1, msm_g2, pippenger
    from kzg_tpu_torch.ntt import Domain
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
        kinfo["ntt_stage"].update(max_abs_err=k5_err, ms=stage_ms["four-step"][0],
                                  plain_ms=stage_ms["four-step"][1])
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
        )
        got = cuda_ops.g2_dbl(p2)
        err = max_abs_diff(got, cuda_ops.g2_dbl_plain(p2))
        check(err == 0, "G2 dbl 2^12 equals plain")
        kinfo["g2_dbl"].update(
            max_abs_err=err,
            ms=cuda_ms(lambda: cuda_ops.g2_dbl(p2), 10),
            plain_ms=cuda_ms(lambda: cuda_ops.g2_dbl_plain(p2), 1),
        )
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
        for k in ("field_elementwise", "g1_add", "g1_dbl", "bucket_accumulate", "horner_join"):
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
        for k, n_launch in counts_batched.items():
            check(n_launch > 0, f"{k} launched {n_launch} times on the batched path")
        counts = {k: counts_single[k] + counts_batched[k] for k in counts_batched}

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
