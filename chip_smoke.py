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
                standalone make_mul / make_add / make_sub entries; every
                ordered pair of `bench.field_body.carry_operands` (runs of
                all-ones and zero words, values just below each 2^(32 k),
                p - 1, R and R^2 mod p) through each kernel that runs
                field.cuh's one-thread body (K1 add / sub / mul / a * a /
                mul_const, K8 at k = 1 and 65, field_scan, ntt_block and
                ntt_stage at 2^12 and 2^15, fr_horner, wide K2 and K7 and K3
                over G1 and G2 on points of those coordinates), K2 add/dbl
                in both modes (narrow: two points a block on 16-lane
                products; wide: one thread a point) at 1, 3 and 2^12 points
                (infinity, P+P, P+(-P) lanes), at each kernel's crossover
                (the most points its narrow mode takes on this card) and at
                2^20 (random, `bench.pointwise.edge_pairs` planted first:
                every pair of cases in both halves of a block), K6 madd (K7's
                narrow kernel at S = 1) on 2^12 and 2^11 lanes (skip,
                infinite, same and opposite lanes planted) and on one and
                four waves of that kernel, K7 madd_multi in both modes (narrow: two lanes a
                block on 16-lane products; wide: one thread a lane) at the
                shape a 2^12-point MSM gives it (16 steps over the sub-run
                lanes of 37 x 128 buckets; neg mask, same and opposite steps
                planted) and the bucket loop's launches in the mode the width
                picks, K3 on the sub-runs of one 2^15 MSM at c = 10 and
                of 2^15 all-equal scalars (one bucket a window; that MSM
                against the native engine's, joined by one K4 launch), K7 in
                both modes at the 2^15 witness's shape (c = 9: its launches,
                the loop equal to the K3 route), K4 the window join at W = 37, c = 7 and at
                W = 26, c = 10 on real window sums, timed also at the 2^20
                paths' W = 18, c = 15 and W = 19, c = 14, and held to its
                twin at the join's edge cases (`bench.horner.CASES`, G1 and
                G2: empty top windows, all infinity, P == Q, P == -Q, W = 1,
                c = 1, c = 16),
                K5's per-stage entry `ntt_stage` (the route as it was) at
                every stage of a 2^20 NTT in the Pease layout and in the
                four-step layout and of a 2^12 Pease transform; K5's block
                entry `ntt_block` through whole transforms at 2^12 (one
                launch), 2^15 and 2^20 (two: the four-step), forward and
                inverse, plain and coset, 0, 1 and r - 1 planted, against
                the plain domain word for word, their launches printed and
                checked (at most 1 up to 2^BLOCK_MAX_EXP, 3 above, no
                ntt_stage), each timed beside the stage loop it replaced
                (`Domain.as_stages()`) in turns; over Fp2: add/dbl,
                K6 and K7 as over Fp, K3 / K4 on a dense G2 MSM's buckets at
                2^12 (c = 7) and at 2^15 (c = 10), every window, and the
                native engine's MSM for the whole; K8 mul_chain for Fr and Fp at
                2^15 lanes with k = 1, 2, 65, one thread an element and in its
                cooperative mode (16 lanes a product, as K4 runs it), timed at
                the probe's 2^19 lanes, and at one element for the latency of
                one product of each mode, printed on a line of its own;
                K1's Fermat chain `field_pow` (Fr and Fp, 1 and 16 elements,
                e = m - 2 and a random e; timed beside the K1 chain it
                replaced); the scan kernel `field_scan` (Fr and Fp, mul and
                add, forward and reverse, the array, column, total and pair
                modes, n = 1, 3, 4097, 2^15 at 1 and 16 rows and 2^20 at one
                row, edges 0, 1, m - 1; timed at the paths' shapes beside the
                K1 chain it replaced) and the Horner kernel `fr_horner`
                (division and remainder alone, n = 2, 4097, 2^15, 2^20 at 1
                and 16 points, one of them 0, with and without a carry in;
                timed at the witness's and the evaluation check's shapes
                beside the K1 chain it replaced, the remainder at 1, 16 and
                63 points also beside the chunked power method on
                `field_scan`); the digit ladder over G1 and G2 at the group
                iNTT's shape (2^11 lanes, c = 4, 64 windows; a lane with p
                infinite, one with all-zero digits) and at its edge cases
                (`bench.ladder.EDGE_DIGITS`: P == Q, P == -Q, infinity + Q;
                also against the oracle), timed also at 2^12 and 2^14 lanes;
                the fixed-base comb `fk20_comb` at its edge cases (0, 1,
                r - 1, every digit 15, P == -Q, P == Q, an infinite point;
                also against the oracle) and at FK20's 73,728 lanes;
                K9 mxu_reduce on the digit sums of a real 128-point DFT product
                at 2^15 lanes and on the largest legal digit sums, timed on
                the (64, 2^20) digit array of a 2^20 NTT's first pass, with
                the product's own time (`torch._int_mm` and its exact
                corrections) and a float64 matmul's beside it;
  4. golden   - the coeff_2e10 vector of tests/vectors.json: setup, commit,
                witness bytes, verify accepts, tampered y rejected;
  5. 2^15     - setup (host engine, asked for by name; cached under
                build/kzg_tpu_torch/; `setup_device` on the card must give the
                same SRS in every affine coordinate),
                commit of a seeded random polynomial checked against the
                native engine's MSM, witness, verify, tampered y rejected;
  6. counts   - kernel launch counts of phases 4-5 (reset just before
                phase 4): K1, field_pow, K2, K3, K4 and K7 (the witness's MSM
                has 512 buckets a window) must each be > 0, and K2 add and
                dbl must have taken the narrow mode, field_scan and
                fr_horner among them; phase 5 also shows the 2^15 witness
                dividing on fr_horner with at most 10 K1 launches (181
                before) and verify_eval converting with two field_pow
                launches and fewer K1 launches than one Fermat chain of K1
                products took (609 over Fp);
  7. golden   - the batched_2e8_k16 vector: commit, batched witness, h^Z
                (G2) and g^r bytes, verify_eval_batched accepts;
  8. batched  - 2^15 coefficients opened at k = 16 points on the 2^15 SRS:
                commit, create_witness_batched, verify_eval_batched
                accepts, other xs rejected;
  9. coset    - the batched quotient's coset division alone at 2^20: a
                seeded numerator f - r divided by a 16-point Z, q Z ==
                numerator checked at two random points with host ints;
 10. counts   - launch counts of phases 7-9 (reset just before phase 7),
                every kernel of that path must be > 0, the G1 and G2
                ladders (h^Z and g^r) and G2 add in the narrow mode among
                them, no G2 dbl, ntt_block > 0 and the per-stage
                ntt_stage = 0 (as on every counted path);
      (the Lagrange build timed group by group, before the next reset:
      one ladder launch a ladder, no stand-alone dbl or madd, one
      field_pow an affine conversion);
 11. G2 MSM   - msm_g2 (G2 Pippenger) at 2^12 (the bucket loop on K7) and
                2^15 points (K3) with random scalars, equal to the native
                engine's g2_msm, one K4 launch a call;
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
                its MSMs have 128 buckets a window and take K7; K6,
                whose madd runs inside the ladder kernel: 0 there; the
                pairing kernels, which the host engine's verifies leave to
                phase 24; and the per-stage ntt_stage, which must be 0);
 15. peaks    - `bench.mul_peak` for Fr and Fp at 2^19 lanes: the k = 65 rate,
                the marginal rate (launch cost cancelled) and the k = 1 launch
                beside the rate the kernel report's bound assumes;
 16. mxu NTT  - `Domain` transforms under `ntt_mxu="auto"` (matmul-DFT blocks,
                kernel K9) equal to `"off"` word for word at 2^14 (balanced
                split), 2^15 (pinned split) and 2^20, both directions; K9 > 0
                and both K5 entries = 0 inside the transform; the 2^20 coset division of
                phase 9 again with the same quotient; times under both
                settings (CUDA events, mean of 5);
 17. 2^20     - `setup_device(s, 2^20, g2_count=2)` (powers 0, 1, 2^19 and
                2^20 - 1 against the native engine), commit (equal to the
                native engine's MSM and to f(s) G), witness (with its peak
                device memory above the resident SRS and f, and the
                division alone: seconds and peak), verify, tampered
                y rejected; the Lagrange basis from the secret by the device
                route at 2^12 equal to the trusted one in `lg` and `lh`;
 18. counts   - launch counts of phases 15-17 (reset just before phase 15):
                K8, K9 and every kernel device setup and the 2^20 path touch
                must be > 0 (ntt_block among them, ntt_stage = 0), G1 add in
                both modes;
 19. K3 2^20  - K3 alone at the 2^20 witness's shape (2^20 - 1 points,
                c = 14), timed with its bound, its twin on the top window;
 20. Lagrange - the trusted Lagrange SRS at 2^15 (the ceremony's largest
                transcript) by the group iNTT of the 2^15 SRS's G1 and G2
                powers (the ladder at 2^14 lanes), each group timed, held
                point for point against the from-secret basis of the device
                route;
 21. counts   - launch counts of phase 20's group iNTTs (reset just before):
                the ladders, field_pow, K1 and K2 must be > 0;
 22. ntt_block - every shape at which the paths since phase 3 launched
                ntt_block (recorded by shape and scales: the subproduct
                trees' small stacked transforms, 2^12, both four-step passes
                at 2^15 and 2^20), replayed on random words with 0, 1 and
                r - 1 planted against the twin word for word, each timed
                with its bound;
 23. 2^24     - `setup_device(s, 2^24, g2_count=2)` (powers 0, 1, 2^23 and
                2^24 - 1 against the native engine), commit (median of 3,
                equal to f(s) G: f(s) and y = f(x) by Horner over Python
                ints on the host), witness (median of 3) equal to the
                witness streamed at the JAX package's chunk logs (22 and 20:
                one `fr_horner` call and one MSM a chunk of 2^20) and to the
                one-shot witness (both chunk logs 24), verify on
                the host and on the device engine (median of 3 each), a
                tampered y rejected by both. Then, after the count: every
                K3, K4 and fr_horner call of the default commit and witness,
                recorded by shape, replayed against its twin word for word
                (K3 on 2^24 points, c = 16: a sample of its sub-runs, every
                window's first and last among them; K4 at W = 16, c = 16;
                fr_horner on the 2^22-coefficient chunks, carry 0 and a
                carry in), each timed with its bound; and, for each chunk
                setting of CHUNK_SWEEP, setup seconds and peak memory (equal
                SRS), commit and witness seconds (median of 3), points/s and
                the peak device memory above the resident SRS and f;
 23b. pairing kernels - not counted: the `miller_loop` kernel (one block
                a pair) and the `final_exp` kernel (lane mode, and product
                mode: the Miller values' product first) at 1, 2 and 5 lanes,
                one lane at infinity (P or Q) but in one of the 1-lane runs,
                against their plain versions (the tower code over K1 and
                `field_pow`) word for word and against the oracle (the
                projective Miller value over the oracle's affine one lies in
                Fp6; the final exponentiations equal); each timed (CUDA events)
                with its plain version's time, its bound (the programs'
                products) and `chain_ms` (its critical path of dependent
                16-lane products at phase 3's latency);
 24. pairing  - `pairing_device` on two random pairs equal to the oracle's
                pairing; the device engine against the host engine on phase
                5's 2^15 single proof, phase 8's batched proof and phase
                13's evaluation-form proofs (`verify_eval`, and
                `verify_eval_all`, whose true claim puts both G1 points at
                infinity): the same verdicts on the true
                and a tampered claim, each engine's wall (median of 3) and
                launches by kernel a verify, the device verify's device
                time by kernel (`torch.profiler`) and idle share; every
                device verify launches miller_loop and final_exp once,
                `verify_eval` at most 100 counted launches in all, and the
                batched proof's h^Z and g^r run on the ladder kernel with
                at most 60 K2 launches on either engine;
 25. counts   - launch counts of phase 23 and of phase 24 (each reset just
                before it): K1, field_pow, field_scan, fr_horner, K2 (G1 add
                and dbl, G2 add), K3, K4, the G1 and G2 ladders and the
                pairing kernels (its device verify) > 0 on the 2^24 path;
                miller_loop, final_exp, g1_ladder and g2_ladder on the
                device verifies, with each proof's launches a verify;
                ntt_stage 0 on both;
 26. sharded  - `kzg_tpu_torch.parallel` at world 1 on NCCL (a file store
                under build/): ShardedDomain(2^20)'s ntt, intt, coset_ntt,
                coset_intt and ntt_t -> intt_t equal Domain(2^20) word for
                word; make_sharded_msm over G1 at 2^20 (phase 23's SRS) and
                G2 at 2^12 equals msm in affine form; then, counted from a
                reset: the commit-witness step at 2^24 on phase 23's SRS and
                f (median of 3; commit, y and witness equal phase 23's in
                affine form, the host engine accepts and rejects a tampered
                y; one more call's launches, one's parts by CUDA events (the
                MSMs, the coset transforms, batch_inv, y, the all_to_all and
                all_gather) and one's peak memory above what was allocated
                before it), the batched step at 2^16, k = 64 (equal to
                create_witness_batched; verify_eval_batched accepts) and the
                evaluation-form step at 2^14 at indices 5 and 2^14 - 3
                (equal to the one-device prover; verify_eval accepts), each
                a median of 3 beside the one-device commit and witness
                (timed before the count), their ntt_block, field_scan and
                fr_horner calls recorded by shape; then
                kzg_tpu_torch.smoke.main(), bench.harness --sizes 16,64
                (every group's keys) and bench.scaling --devices 1. With two
                cards or more, the MSMs and the 2^24 step also on a world of
                every card (the largest power of two), one NCCL process a
                card (`--sharded-rank`), equal to world 1; with one card the
                phase says so;
 27. replay   - every ntt_block shape phase 26's steps launched (Domain(24)'s
                two 2^12-point passes over 4,096 columns among them) on
                random words with 0, 1 and r - 1 planted, every field_scan
                call (the 2^24-wide rows of powers, batch_inv's pair scan at
                2^24) and every fr_horner call (the remainder over the 2^24
                block, held against the twin's division above 2^20
                coefficients; the first and the latest call of a shape) on
                the recorded inputs, each against its twin word for word,
                timed with its bound, added to the kernel's `shapes`;
 28. counts   - launch counts of phase 26's steps: K1, field_pow,
                field_scan, fr_horner, ntt_block, K2, K3, K4 and K7 > 0,
                ntt_stage 0.
K3 and K7 run over sub-runs of at most L points of each bucket's run
(`msm.pippenger.split_runs`); each phase that runs them prints L, the
number of sub-runs, the longest one, the most sub-runs of one bucket and,
for K7, its launches an MSM.
Setups other than phase 5's take the default engine, the device route.
With --profile, the evaluation-form path, the batched verify of phase 8
and the 2^15 and 2^20 coefficient-form witnesses are then profiled phase by phase (wall, launches, device time by kernel,
idle share) and the table written to JSON (default
build/profile_eval.json).
Every counted run prints K2's and K7's launches by mode, and requires K7
launches in the mode its rule picks at the path's shape. The last lines are the
kernel report (launches summed over the eight counted runs; K2 has a row a
mode, `g1_add_narrow`, `g1_add_wide` and so on, each with its launches in
that mode, its times at 2^12 points (narrow) or 2^20 (wide), every width
it was held and timed at, `chain_ms` (the narrow mode's critical path of
16-lane products, the wide mode's serial one-thread chain, at the measured
latencies) and `throughput_ms` (all the points' products at the measured
rate); K7 has a row a mode too (`g1_madd_multi_narrow`, ...), its times
at the 2^12 MSM's shape and `shapes`, each timed shape (the 2^15
witness's too) with its time, twin time, bound, `chain_ms` (S steps of
the madd's critical path at those latencies) and `throughput_ms` (the
live steps' products at the measured rate); K6's rows (`g1_madd`,
`g2_madd`) take their times at 2^12 lanes and carry `widths` (2^12, 2^11,
one and four waves); `ntt_block`'s row takes its time at the 2^20
transform's first pass and carries `shapes` (phases 22 and 27: every
shape the paths launched, with its path, time, twin time and bound) and
`transforms` (phase 3:
whole transforms beside the stage loop, with launches); K4's rows also carry `chain_ms`, its critical path in
dependent products at W = 26, c = 10 times the 16-lane Fp product's
latency; the ladders' `chain_ms` is a lane's critical path at c = 4,
W = 64 at that latency and `throughput_ms` all the lanes' Fp products at
the rate phase 15 measured; field_pow's `chain_ms` its 381 Fp products at
that latency; miller_loop's and final_exp's rows take their times at
phase 23b's two lanes (final_exp in product mode, the check's shape) and
carry `chain_ms` and `shapes` (every lane count and mode it timed); field_scan's and fr_horner's rows carry `k1_chain_ms`, the
K1 chain each replaced, timed in the same run, and `shapes`, each timed
shape, phase 27's and fr_horner's phase 23 shapes among them), the
nvidia-smi line, and {"ok": true, "device": {...}}.

Bounds in the kernel report. `bound_ms` is the larger of two times: the
bytes the function must move (each input read once, each output written
once) over the H100's 3.35 TB/s of device memory, and its 32-bit integer
multiply-adds over the card's rate for them. That rate is not in NVIDIA's
data sheet; it is taken as a quarter of the 67 TFLOP/s float32 figure: a
float32 FMA counts two operations, and a Hopper SM has 64 INT32 lanes to
its 128 FP32 lanes, which gives 16.75e12 multiply-adds a second (phase 15 prints the rate the card shows for a
dependent multiply beside it). A
Montgomery multiplication of N words is counted as 2 N^2 + N multiply-adds
(CIOS), a field add or sub as 2 N word operations, a point operation by its
field multiplications (dbl 7, madd 11, add 16 over Fp; 16, 29, 43 over
Fp2). Data-dependent kernels count what this run's inputs need (the points
of the sub-runs, the live lanes of a masked madd, the ladder's non-zero
digits). `library_ms` is
null for every kernel: no PyTorch call computes 255- or 381-bit modular
arithmetic.
"""

import argparse
import contextlib
import hashlib
import io
import json
import os
import random
import subprocess
import sys
import time
import types

import torch

SEED = 20260401
N_MAIN = 1 << 15
C_MAIN = 10
N_POINT = 1 << 12
K_BATCH = 16
EXP_COSET = 20
EXP_EVAL = 12  # one EIP-4844 blob: 4096 evaluations
EXP_LAGRANGE = 15  # the ceremony's largest transcript
EXP_BIG = 24  # the north star: commit + witness of a 2^24-coefficient polynomial
# the chunk settings phase 23 times at 2^EXP_BIG (EXP_BIG: one shot)
CHUNK_SWEEP = {"msm_chunk_log": (22, 23, 24), "div_chunk_log": (20, 22)}
# the JAX package's defaults, under which the 2^EXP_BIG witness streams
STREAM_CHUNKS = {"msm_chunk_log": 22, "div_chunk_log": 20}

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


def once_ms(fn):
    """(result, milliseconds) of one call of fn on the card (CUDA events)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def median3(fn):
    """(result, median seconds, the three times) of fn, host-clocked and
    closed by a synchronize."""
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return out, sorted(times)[1], times


def bound(nbytes, mads):
    """(bound_ms, bound_by) of a kernel that must move nbytes and do mads
    32-bit multiply-adds."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = mads / INT_MADS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def scan_bound(F, mul, mode, rows, n):
    """Bound of one field_scan call over rows x n elements of F: its input
    read once (a column: rows elements) and its output written once (a
    fold: rows; a pair: two arrays), one product (`mul`) or sum an element
    a scan (a pair: two scans)."""
    scans = 2 if mode == "pair" else 1
    elements = (rows if mode == "column" else rows * n) + (
        rows if mode == "total" else scans * rows * n)
    per = 2 * F.W * F.W + F.W if mul else 2 * F.W
    return bound(4 * F.W * elements, scans * rows * n * per)


def block_products(shape, pre, post):
    """Fr products one ntt_block launch on x of `shape` (8, nb, m, bt)
    needs: (m / 2)(log2 m - 1) a column (every butterfly but the last
    stage's, whose twiddle is 1) and one an element a scale, whatever the
    layout of its table."""
    _, nb, m, bt = shape
    n = nb * m * bt
    return n // 2 * (m.bit_length() - 2) + n * sum(sc is not None for sc in (pre, post))


def block_bound(shape, out_bt, pre, post):
    """Bound of one ntt_block launch on x of `shape` (8, nb, m, bt): the
    array read and written once with the stage and scale tables; the
    (m / 2) log2 m butterflies of every column, an add and a sub each, and
    `block_products`."""
    _, nb, m, bt = shape
    n = nb * m * bt
    butterflies = n // 2 * (m.bit_length() - 1)
    products = block_products(shape, pre, post)
    tables = m + sum(0 if sc is None else sc.lo.shape[0] + (0 if sc.hi is None else sc.hi.shape[0])
                     for sc in (pre, post))
    return bound(32 * (2 * n + tables), products * FR_MUL_MADS + butterflies * 4 * 8)


def point_bound(op, g2, lanes, coords_moved, live=None):
    """Bound of a pointwise add / dbl / madd over `lanes` points:
    coords_moved coordinates of 48 (G1) or 96 (G2) bytes a lane, the
    formula's multiplications on the `live` lanes."""
    live = lanes if live is None else live
    return bound(coords_moved * (96 if g2 else 48) * lanes,
                 POINT_MULS[op][g2] * FP_MUL_MADS * live)


def runs_bound(g2, rows, order, runs, n_out):
    """Bound of K3 on these sub-runs: every array once, one madd per point
    of a sub-run (the points in counted buckets)."""
    nbytes = 4 * (rows.numel() + order.numel() + 2 * runs.pos.numel() + n_out)
    return bound(nbytes, int(runs.length.sum()) * POINT_MULS["madd"][g2] * FP_MUL_MADS)


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


def device_ms(fn):
    """(busy ms, the eight largest (kernel, ms)) of one call of fn:
    `torch.profiler` self device time of the device-side events (one
    stream, so kernels never overlap and the sum is the busy time). Only
    the CUDA activity is traced: the host-side operator events would repeat
    the kernels' time, and on a device verify's chain of ~20,000 launches
    recording them took most of the pairing phase's time. The program's
    spans (`kzg_tpu_torch.trace.SPANS`) are ranges, not work: skipped."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from kzg_tpu_torch.trace import SPANS

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_kernel = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        if us > 0 and evt.device_type == DeviceType.CUDA and evt.key not in SPANS:
            by_kernel[evt.key] = by_kernel.get(evt.key, 0.0) + us / 1e3
    return sum(by_kernel.values()), sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]


def profile_phases(phases, card, out_path):
    """For each (name, fn): the wall time (host clock closed by a
    synchronize, median of 3 after a warm-up call), the port's launches in
    one call, the device time by kernel (`torch.profiler` self device time
    of one more call; only device-side events, the host-side operator
    events repeat the time of the kernels they launch) and the device's
    idle share, 1 - busy / wall (one stream, so kernels never overlap and
    the sum is the busy time). Printed, and written to out_path as JSON.
    The launch counts are read before and after, never reset."""
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
        torch.cuda.synchronize()
        before = kernels.launch_counts()
        fn()
        torch.cuda.synchronize()
        launches = {k: v - before[k] for k, v in kernels.launch_counts().items() if v != before[k]}
        busy, top = device_ms(fn)
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


def sharded_rank(out_dir: str, x: int) -> int:
    """One rank of phase 26's run across cards (`--sharded-rank DIR --x X`,
    RANK and WORLD_SIZE set by `parallel.runtime.launch`): phase 23's SRS
    and f, phase 26's MSM inputs (the same seeds and draws), the sharded G1
    2^20 and G2 2^12 MSMs and the 2^24 commit-witness step (median of 3);
    rank 0 saves the results to DIR/rank0.pt."""
    import torch.distributed as dist

    from kzg_tpu_torch import parallel
    from kzg_tpu_torch.curve import G1, G2
    from kzg_tpu_torch.fields import FR
    from kzg_tpu_torch.kzg.srs import KZGParams, setup_device

    parallel.initialize_distributed(init_method=f"file://{os.path.join(out_dir, 'store')}")
    dev = parallel.runtime.rank_device()
    mesh = parallel.make_mesh()
    big = setup_device(SEED, 1 << EXP_BIG, g2_count=2, device=dev)
    coeffs = random_fr_words(torch.Generator(device=dev).manual_seed(SEED + 24),
                             (1 << EXP_BIG,), dev)
    gen26 = torch.Generator(device=dev).manual_seed(SEED + 26)
    random_fr_words(gen26, (1 << EXP_COSET,), dev)  # phase 26's transform input
    key = hashlib.sha256(f"{SEED}:{N_MAIN}".encode()).hexdigest()[:16]
    p15 = KZGParams.load(os.path.join(ROOT, "build", "kzg_tpu_torch", f"srs_{key}.npz"),
                         device=dev)
    out = {}
    for curve, pts, n, what in ((G1, big.gs, 1 << EXP_COSET, "G1 2^20"),
                                (G2, p15.hs, N_POINT, "G2 2^12")):
        run = parallel.make_sharded_msm(mesh, "shard", curve)
        s = random_fr_words(gen26, (n,), dev)
        out[what] = torch.stack(run(tuple(run.shard(t[..., :n]) for t in pts),
                                    run.shard(s))).cpu()
    step = parallel.make_commit_witness_step(mesh, "shard", EXP_BIG)
    args = (*(step.shard(t) for t in big.gs), step.shard(coeffs),
            torch.from_numpy(FR.encode([x])).to(dev))
    (commit, y, wit), out["seconds"], _ = median3(lambda: step(*args))
    out.update(commit=torch.stack(commit).cpu(), y=y.cpu(), wit=torch.stack(wit).cpu())
    if dist.get_rank() == 0:
        torch.save(out, os.path.join(out_dir, "rank0.pt"))
    dist.destroy_process_group()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", nargs="?", const=os.path.join("build", "profile_eval.json"),
                    metavar="JSON", help="after the checks, profile the evaluation-form path "
                    "phase by phase and write the table here")
    ap.add_argument("--sharded-rank", metavar="DIR", help=argparse.SUPPRESS)
    ap.add_argument("--x", type=int, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; a CUDA card is required",
              file=sys.stderr)
        return 1
    if args.sharded_rank:
        return sharded_rank(args.sharded_rank, args.x)

    from kzg_tpu_torch import kernels, native
    from kzg_tpu_torch.bench import comb as cbench
    from kzg_tpu_torch.bench import field_body as fbench
    from kzg_tpu_torch.bench import horner as hbench
    from kzg_tpu_torch.bench import ladder as lbench
    from kzg_tpu_torch.bench import madd_multi as mmbench
    from kzg_tpu_torch.bench import mul_peak, peaks
    from kzg_tpu_torch.bench import pointwise as pwbench
    from kzg_tpu_torch.curve import horner_schedule
    from kzg_tpu_torch.config import configure, get_config, set_config
    from kzg_tpu_torch.constants import P, R
    from kzg_tpu_torch.curve import (
        G1, G2, cuda_ops, g1_from_device, g1_to_device, g2_from_device, g2_to_device,
    )
    from kzg_tpu_torch.fields import FP, FR
    from kzg_tpu_torch.fields import cuda_field
    from kzg_tpu_torch.fields.limb import ints_to_words, words_to_ints
    from kzg_tpu_torch.kzg.coeff_form import (
        KZGProver, KZGVerifier, g1_compressed, g2_compressed,
    )
    from kzg_tpu_torch.kzg.eval_form import (
        KZGBatchWitnessEvalForm, KZGProverEvalForm, KZGVerifierEvalForm,
        compute_lagrange_basis, compute_lagrange_basis_from_secret,
    )
    from kzg_tpu_torch.kzg.srs import KZGParams, setup, setup_device
    from kzg_tpu_torch.msm import msm_g1, msm_g2, pippenger
    from kzg_tpu_torch.ntt import Domain, mxu
    from kzg_tpu_torch.ntt import domain as ntt_domain
    from kzg_tpu_torch.oracle import ec_add, ec_mul, ec_neg, g1_generator, g2_generator
    from kzg_tpu_torch.oracle import pairing as oracle_pairing
    from kzg_tpu_torch.pairing import pairing as pairing_mod
    from kzg_tpu_torch.pairing import pairing_device, tower
    from kzg_tpu_torch.pairing import schedule as pair_schedule
    from kzg_tpu_torch.poly import Polynomial, lagrange_interpolation, vanishing_poly
    from kzg_tpu_torch.poly import horner as horner_mod
    from kzg_tpu_torch.poly import polynomial as poly_mod

    dev = torch.device("cuda", 0)
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
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
            configure(setup_engine="host")
            params = setup(SEED, N_MAIN, device=dev)
            configure(setup_engine="auto")
            os.makedirs(os.path.dirname(cache), exist_ok=True)
            params.save(cache)
            how = "built on the host engine"
        setup_s = time.perf_counter() - t0
        log(f"  setup(secret, 2^15) {how} in {setup_s:.2f} s")

    rng = random.Random(SEED)
    kinfo = {k: {} for k in kernels.REGISTRY}
    # ntt_block calls by shape, recorded from phase 3 on (`record_block`) and
    # replayed against the twin in phase 22; whole transforms timed in phase 3
    block_calls = {}
    block_transforms = []
    launch_block = cuda_field.ntt_block

    def record_block(x, tw, pre=None, post=None, out_bt=None, cols=None, threads=None):
        # a Domain's stage tables are built once a device, so the table's
        # address tells the forward calls of a shape from the inverse ones
        inverse = tw.data_ptr() == Domain(tw.shape[0].bit_length() - 1)._stage_table(
            True, tw.device).data_ptr()
        key = (tuple(x.shape), out_bt or x.shape[3], "inverse" if inverse else "forward") + tuple(
            None if sc is None else (sc.kind, sc.hi is not None) for sc in (pre, post))
        block_calls.setdefault(key, (tw, pre, post))
        return launch_block(x, tw, pre, post, out_bt, cols, threads)

    def check_group_launches(group, before, exp):
        """A group iNTT of 2^exp points (and its to_affine) since `before`:
        one ladder launch a ladder (exp stages and the 1/d scale), no
        stand-alone dbl or madd, one field_pow an affine conversion (each
        ladder's table and the result) and no chain of K1 launches."""
        after = kernels.launch_counts()
        got = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        log(f"  {group} group iNTT 2^{exp} launches: {got}")
        check(got.get(f"{group}_ladder", 0) == exp + 1
              and got.get(f"{group}_dbl", 0) == 0 and got.get(f"{group}_madd", 0) == 0,
              f"{group} group iNTT 2^{exp}: {exp + 1} ladder launches, no dbl or madd launch")
        check(got.get("field_pow", 0) == exp + 2
              and got.get("field_elementwise", 0) < (exp + 2) * 100,
              f"{group} group iNTT 2^{exp}: one field_pow an affine conversion, "
              f"{got.get('field_elementwise', 0)} K1 launches (the Fp chains alone were "
              f"{(exp + 2) * 609})")

    def check_k2(group, curve, add_fn, dbl_fn, add_plain_fn, dbl_plain_fn, p, q):
        """K2 add and dbl of one group in both modes against the plain twin:
        at 1, 3 and 2^12 points (p, q: lane 0 P at infinity, 1 Q at
        infinity, 2 both, 3 Q = P under another Z, 4 Q = -P, 5 Q = P word
        for word), at the kernel's crossover (the most points its narrow
        mode takes on this card) and at 2^20 (random points, the edge pairs
        of `bench.pointwise` first: every pair of cases in both halves of a
        narrow block). Each width timed in both modes: the kernel's device
        time (CUDA events around calls the card runs back to back, the
        stream held while the host enqueues them: `peaks.held_ms`) and a
        call's time (events around a run of calls as the host makes them:
        the host's launch, where it is the longer); the twin once.
        The report's row of a mode takes its times at 2^12 (narrow) or 2^20
        (wide)."""
        g2 = int(group == "g2")
        edges = pwbench.edge_pairs(group, dev)
        for op, fn, plain_fn, moved in (("add", add_fn, add_plain_fn, 9),
                                        ("dbl", dbl_fn, dbl_plain_fn, 6)):
            kname = f"{group}_{op}"
            top = cuda_ops.NARROW_WAVES[kname] * 2 * sm_count * cuda_ops.narrow_min_blocks(
                1 + g2)
            modes = {m: {"widths": [], "max_abs_err": 0} for m in cuda_ops.MODES}
            gen_k2 = torch.Generator(device=dev).manual_seed(SEED + 20 + g2)
            for w in (1, 3, N_POINT, top, 1 << 20):
                if w <= N_POINT:
                    a, b = (tuple(t[..., :w].contiguous() for t in pt) for pt in (p, q))
                else:
                    a, b = pwbench.planted(group, w, gen_k2, edges[:2])
                args = (a, b) if op == "add" else (a,)
                want, plain_ms = once_ms(lambda: plain_fn(*args))
                iters = 20 if w <= 1 << 14 else 3
                for m, row in modes.items():
                    err = max_abs_diff(fn(*args, mode=m), want)
                    row["max_abs_err"] = max(row["max_abs_err"], err)
                    call_ms = cuda_ms(lambda: fn(*args, mode=m), iters)
                    row["widths"].append({
                        "points": w, "ms": peaks.held_ms(lambda: fn(*args, mode=m), iters),
                        "call_ms": call_ms, "plain_ms": plain_ms,
                        "bound_ms": point_bound(op, g2, w, moved)[0]})
                    check(err == 0, f"K2 {kname} {m} at {w} points equals plain")
                if op == "add" and w == N_POINT:
                    out = fn(*args)
                    check(bool(curve.is_inf(out)[4]) and not bool(curve.is_inf(out)[3]),
                          f"K2 {kname}: P + (-P) is infinity, P + P is not")
                del a, b, args, want
            for m, row in modes.items():
                ref = next(r for r in row["widths"]
                           if r["points"] == (N_POINT if m == "narrow" else 1 << 20))
                row.update(ms=ref["ms"], plain_ms=ref["plain_ms"], points=ref["points"],
                           bound=point_bound(op, g2, ref["points"], moved))
                log(f"  K2 {kname} {m}, device ms (a call's ms, twin ms, bound ms): " + ", ".join(
                    f"{r['points']} points {r['ms']:.4f} ({r['call_ms']:.4f}, "
                    f"{r['plain_ms']:.2f}, {r['bound_ms']:.6f})" for r in row["widths"])
                    + f" [{card}]")
            kinfo[kname]["modes"] = modes
            kinfo[kname]["max_abs_err"] = max(r["max_abs_err"] for r in modes.values())

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

        # the carry operands (`bench.field_body.carry_operands`: runs of
        # all-ones and zero words, values just below each 2^(32 k), p - 1, R
        # and R^2 mod p, ...): every ordered pair through every kernel that
        # runs field.cuh's one-thread body, word for word against its plain
        # version, the products also against Python ints
        t0 = time.perf_counter()
        for F, mod in ((FR, R), (FP, P)):
            a, b = fbench.carry_words(F, dev)
            n_pairs = a.shape[-1]
            errs = [max_abs_diff(cuda_field.binary(F, op, x, y),
                                 cuda_field.binary_plain(F, op, x, y))
                    for op in (cuda_field.ADD, cuda_field.SUB, cuda_field.MUL)
                    for x, y in ((a, b), (a, a))]
            for c in fbench.carry_operands(mod, F.W)[::7]:
                cw = ints_to_words([c], F.W)[:, 0]
                errs.append(max_abs_diff(cuda_field.mul_const(F, a, cw),
                                         cuda_field.mul_const_plain(F, a, cw)))
            r_inv = pow(1 << (32 * F.W), -1, mod)
            check(max(errs) == 0 and words_to_ints(cuda_field.binary(F, cuda_field.MUL, a, b))
                  == [x * y * r_inv % mod for x, y in zip(words_to_ints(a), words_to_ints(b))],
                  f"K1 {F.name} add, sub, mul, a * a and mul_const on the {n_pairs} carry-operand "
                  "pairs equal plain (the products also Python ints)")
            err = max(max_abs_diff(cuda_field.mul_chain(F, k, a, b),
                                   cuda_field.mul_chain_plain(F, k, a, b)) for k in (1, 65))
            check(err == 0, f"K8 {F.name} one thread, k = 1 and 65, on the carry-operand pairs "
                  "equals plain")
            err = max(max_abs_diff(cuda_field.field_scan(F, op, a, rev),
                                   cuda_field.field_scan_plain(F, op, a, rev))
                      for op in (cuda_field.MUL, cuda_field.ADD) for rev in (False, True))
            check(err == 0, f"field_scan {F.name} mul and add, both directions, over the "
                  "carry-operand pairs equals plain")
        ops_r = fbench.carry_operands(R, FR.W)
        for e in (12, 15):
            x = torch.from_numpy(ints_to_words(
                [ops_r[i % len(ops_r)] for i in range(1 << e)], FR.W)).to(dev)
            dom = Domain(e)
            for fwd in ("ntt", "intt", "coset_ntt"):
                want = getattr(dom.as_plain(), fwd)(x)
                err = max(max_abs_diff(getattr(d, fwd)(x), want) for d in (dom, dom.as_stages()))
                check(err == 0, f"ntt_block and ntt_stage: {fwd} 2^{e} of the Fr carry operands "
                      "equals the plain domain")
        f = torch.from_numpy(ints_to_words(
            [ops_r[i % len(ops_r)] for i in range(4097)], FR.W)).to(dev)
        xk = torch.from_numpy(ints_to_words([ops_r[1], ops_r[-1], ops_r[len(ops_r) // 2]],
                                            FR.W)).to(dev)
        err = max_abs_diff(horner_mod.fr_horner(f, xk), horner_mod.fr_horner_plain(f, xk))
        check(err == 0, "fr_horner: 4,097 Fr carry operands divided at three of them equals plain")
        for group, add_fn, dbl_fn, add_p, dbl_p, mm_fn, mm_p in (
                ("g1", cuda_ops.add, cuda_ops.dbl, cuda_ops.add_plain, cuda_ops.dbl_plain,
                 cuda_ops.madd_multi, cuda_ops.madd_multi_plain),
                ("g2", cuda_ops.g2_add, cuda_ops.g2_dbl, cuda_ops.g2_add_plain,
                 cuda_ops.g2_dbl_plain, cuda_ops.g2_madd_multi, cuda_ops.g2_madd_multi_plain)):
            p, q = fbench.carry_points(group, dev)
            n_pts = p[0].shape[-1]
            err = max(max_abs_diff(add_fn(p, q, mode="wide"), add_p(p, q)),
                      max_abs_diff(dbl_fn(p, mode="wide"), dbl_p(p)))
            check(err == 0, f"K2 {group} add and dbl, wide, on {n_pts} carry-operand points "
                  "equal plain")
            lanes = torch.arange(n_pts, device=dev)
            qa = (torch.stack([q[0], q[2]], dim=-2), torch.stack([q[1], p[2]], dim=-2))
            skip = torch.stack([lanes % 5 == 0, lanes % 7 == 1])
            neg = torch.stack([lanes % 3 == 0, lanes % 3 == 2])
            err = max_abs_diff(mm_fn(p, qa, skip, neg, mode="wide"), mm_p(p, qa, skip, neg))
            check(err == 0, f"K7 {group} wide, two steps over {n_pts} carry-operand lanes, "
                  "equals plain")
            rows = cuda_ops.point_rows(q[0], q[1])
            order = torch.arange(n_pts, dtype=torch.int32, device=dev)[None]
            pos = torch.arange(0, n_pts, 16, dtype=torch.int32, device=dev)
            length = (n_pts - pos).clamp(max=16).to(torch.int32)
            err = max_abs_diff(cuda_ops.bucket_runs(rows, order, pos, length),
                               cuda_ops.bucket_runs_plain(rows, order, pos, length))
            check(err == 0, f"K3 {group}: sub-runs of 16 carry-operand points equal plain")
        log(f"  carry operands through K1, K8, field_scan, ntt_block, ntt_stage, fr_horner, wide "
            f"K2 and K7, K3: equal their plain versions ({time.perf_counter() - t0:.1f} s)")

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
        check_k2("g1", G1, cuda_ops.add, cuda_ops.dbl, cuda_ops.add_plain, cuda_ops.dbl_plain,
                 p, q)

        def madd_case(curve, kname, kernel_fn, plain_fn, p_jac, qx, qy, jac_of, g2):
            """K6 (K7's narrow kernel at S = 1) on n lanes (lane 0 p
            infinite, 3 p == q under another Z, 4 p == -q, every eighth
            lane skipped, the rest generic), on their first 2^11 and on one
            and four waves of the kernel (`bench.madd_multi`'s random
            operands at S = 1, its planted lanes first), each width against
            the twin word for word and timed (device time behind a held
            stream, a call's time). The report's row takes its times at
            2^12 lanes."""
            p_jac = tuple(t.clone() for t in p_jac)
            p_jac[2][..., 0] = 0
            same = jac_of(qx[..., 3:4], qy[..., 3:4])
            opp = jac_of(qx[..., 4:5], curve.f.neg(qy[..., 4:5]))
            for i in range(3):
                p_jac[i][..., 3] = same[i][..., 0]
                p_jac[i][..., 4] = opp[i][..., 0]
            skip = (torch.arange(n, device=dev) % 8) == 7
            h = n // 2
            wave = 2 * sm_count * cuda_ops.narrow_min_blocks(1 + g2)
            cases = [(n, (p_jac, (qx, qy), skip)),
                     (h, (tuple(t[..., :h].contiguous() for t in p_jac),
                          (qx[..., :h].contiguous(), qy[..., :h].contiguous()), skip[:h]))]
            for k in (1, 4):
                acc_t, q_t, skip_t, _ = mmbench.random_steps(
                    kname[:2], k * wave, 1, torch.Generator(device=dev).manual_seed(SEED + 30 + g2))
                cases.append((k * wave, (acc_t, tuple(t.select(-2, 0) for t in q_t), skip_t[0])))
            row = {"widths": [], "max_abs_err": 0}
            for lanes, args in cases:
                want, plain_ms = once_ms(lambda: plain_fn(*args))
                got = kernel_fn(*args)
                err = max_abs_diff(got, want)
                row["max_abs_err"] = max(row["max_abs_err"], err)
                check(err == 0, f"K6 {kname} at {lanes} lanes equals plain")
                if lanes == n:
                    inf = curve.is_inf(got)
                    check(bool(inf[4]) and not bool(inf[3]) and not bool(inf[0])
                          and all(torch.equal(g[..., 7], t[..., 7]) for g, t in zip(got, p_jac)),
                          f"K6 {kname}: P + (-P) is infinity, P + P and inf + Q are not, "
                          "skip keeps P")
                live = int((~args[2]).sum())
                row["widths"].append({
                    "lanes": lanes, "ms": peaks.held_ms(lambda: kernel_fn(*args), 20),
                    "call_ms": cuda_ms(lambda: kernel_fn(*args), 20),
                    "plain_ms": plain_ms,
                    "bound_ms": bound((8 * (96 if g2 else 48) + 1) * lanes,
                                      POINT_MULS["madd"][g2] * FP_MUL_MADS * live)[0]})
            ref = row["widths"][0]
            row.update(ms=ref["ms"], plain_ms=ref["plain_ms"], lanes=n,
                       bound=bound((8 * (96 if g2 else 48) + 1) * n,
                                   POINT_MULS["madd"][g2] * FP_MUL_MADS * int((~skip).sum())))
            log(f"  K6 {kname}, device ms (a call's ms, twin ms, bound ms): " + ", ".join(
                f"{r['lanes']} lanes {r['ms']:.4f} ({r['call_ms']:.4f}, {r['plain_ms']:.2f}, "
                f"{r['bound_ms']:.6f})" for r in row["widths"]) + f" [{card}]")
            kinfo[kname].update(row)
            report[f"{kname}_2e11_ms"] = row["widths"][1]["ms"]

        def k7_modes(kname, kernel_fn, plain_fn, cases, g2, label):
            """K7 in each mode against the twin on `cases` ((acc, q, skip[,
            neg]) operand tuples), word for word; both modes timed on the
            first case: the device time (CUDA events around calls the card
            runs back to back, the stream held while the host enqueues them:
            `peaks.held_ms`) and a call's time (events around calls as the
            host makes them); the twin once; the bound from these inputs.
            The report's row of a mode takes its times at the first shape
            timed (a 2^12-point MSM's) and lists every shape."""
            fuse = cases[0][1][0].shape[-2]
            rows = kinfo[kname].setdefault(
                "modes", {m: {"shapes": [], "max_abs_err": 0} for m in cuda_ops.MODES})
            args = cases[0]
            want, plain_ms = once_ms(lambda: plain_fn(*args))
            wants = [want] + [plain_fn(*c) for c in cases[1:]]
            lanes, live = args[2].shape[1], int((~args[2]).sum())
            muls = POINT_MULS["madd"][g2] * live
            nbytes = ((6 + 2 * fuse) * (96 if g2 else 48) + 2 * fuse) * lanes
            b = bound(nbytes, muls * FP_MUL_MADS)
            for m, row in rows.items():
                err = max(max_abs_diff(kernel_fn(*c, mode=m), w) for c, w in zip(cases, wants))
                row["max_abs_err"] = max(row["max_abs_err"], err)
                check(err == 0, f"K7 {kname} {m} at the {label} shape ({lanes} lanes, S = {fuse}, "
                      f"{len(cases)} operand sets) equals plain")
                row["shapes"].append({
                    "shape": label, "lanes": lanes, "steps": fuse, "live_steps": live, "muls": muls,
                    "ms": peaks.held_ms(lambda: kernel_fn(*args, mode=m), 10),
                    "call_ms": cuda_ms(lambda: kernel_fn(*args, mode=m), 10),
                    "plain_ms": plain_ms, "bound_ms": b[0], "bound_by": b[1],
                    "bytes_ms": bound(nbytes, 0)[0], "ops_ms": bound(0, muls * FP_MUL_MADS)[0]})
            mode = cuda_ops.width_mode(cuda_ops._G2K if g2 else cuda_ops._G1K, "madd_multi", lanes,
                                       dev)
            log(f"  K7 {kname} at the {label} shape ({lanes} lanes, S = {fuse}, {live} live "
                f"steps; the rule picks {mode}): device ms (a call's ms) " + ", ".join(
                    f"{m} {r['shapes'][-1]['ms']:.4f} ({r['shapes'][-1]['call_ms']:.4f})"
                    for m, r in rows.items())
                + f", twin {plain_ms:.2f} ms, bound {b[0]:.6f} ms ({b[1]}) [{card}]")
            return mode

        def madd_multi_case(curve, kname, kernel_fn, plain_fn, pts, g2):
            """K7 at the shape a 2^12-point MSM gives it (c = 7: 16 steps over
            the sub-run lanes of 37 x 128 buckets), in both modes: the first
            two launches of the bucket loop on random scalars, from infinity
            and from the twin's sums of the first; then the second with a neg
            mask, a lane whose step adds the accumulator's own point and a
            lane that adds its opposite. Then the whole loop, its K7
            launches counted."""
            c7 = pippenger.effective_window(n)
            fuse = get_config().msm_fuse_steps
            ints = [rng.randrange(R) for _ in range(n)]
            std = FR.from_mont(torch.from_numpy(FR.encode(ints)).to(dev))
            inputs = pippenger.bucket_inputs(*pts, std, c7)
            runs = pippenger.split_runs(inputs[2], inputs[3], n)
            q0, skip0 = pippenger.loop_chunk(inputs[0], inputs[1], runs, 0, fuse)
            q1, skip1 = pippenger.loop_chunk(inputs[0], inputs[1], runs, fuse, fuse)
            q0, q1 = (tuple(t.contiguous() for t in q) for q in (q0, q1))
            acc0 = curve.infinity((runs.pos.numel(),), dev)
            acc1 = plain_fn(acc0, q0, skip0)
            lanes = runs.pos.numel()
            ax, ay, ainf = curve.to_affine(acc1)
            check(not bool(ainf[5]) and not bool(ainf[6]), "planted lanes hold points")
            q_p = tuple(t.clone() for t in q1)
            skip_p = skip1.clone()
            gen_m = torch.Generator(device=dev).manual_seed(SEED + 7)
            neg = torch.rand(skip1.shape, generator=gen_m, device=dev) < 0.3
            for b, negate in ((5, False), (6, True)):
                q_p[0][..., 0, b] = ax[..., b]
                q_p[1][..., 0, b] = ay[..., b]
                skip_p[0, b] = False
                skip_p[1:, b] = True
                neg[0, b] = negate
            inf = curve.is_inf(plain_fn(acc1, q_p, skip_p, neg))
            check(bool(inf[6]) and not bool(inf[5]),
                  f"K7 {kname} twin with neg mask: P + P doubles, P + (-P) is infinity")
            mode = k7_modes(kname, kernel_fn, plain_fn,
                            [(acc1, q1, skip1), (acc0, q0, skip0), (acc1, q_p, skip_p, neg)], g2,
                            f"2^{n.bit_length() - 1} MSM (launch 2 of the loop, c = {c7})")
            # the whole MSM on this route, and K4 at its window count
            before, before_m = kernels.launch_counts()[kname], kernels.mode_counts()[kname]
            acc = pippenger._bucket_loop(curve, *inputs)
            launches = kernels.launch_counts()[kname] - before
            took = kernels.mode_counts()[kname][mode] - before_m[mode]
            log(f"  bucket loop 2^{n.bit_length() - 1}, c = {c7} ({kname}): L {runs.run_length}, "
                f"{lanes} sub-runs, longest {runs.longest}, most sub-runs of a bucket "
                f"{runs.max_split}; {launches} K7 launches an MSM, {took} {mode}")
            check(launches == took == -(-runs.longest // fuse) <= -(-runs.run_length // fuse),
                  f"the bucket loop took ceil(longest / S) = {launches} K7 launches, all {mode}")
            s_all = pippenger.weighted_bucket_sum(curve, acc)
            return ints, s_all, c7, mode

        madd_case(G1, "g1_madd", cuda_ops.madd, cuda_ops.madd_plain, p,
                  gx[:, n:2 * n].contiguous(), gy[:, n:2 * n].contiguous(),
                  lambda x, y: jacobian(x, y, [rng.randrange(1, P)]), 0)

        # K7 over G1, and K4 at the window count of a 2^12-point MSM
        gs12 = tuple(t[..., :n].contiguous() for t in params.gs)
        ints12, s_all12, c12, k7_mode12 = madd_multi_case(
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

        def k3_case(label, pts, std, c, g2):
            """K3 on the sub-runs of one MSM's buckets against its twin word
            for word, every window; the route (split + K3 + combine on K2)
            against the twin's partials combined on plain adds. K3 and the
            route timed (CUDA events), the twin host-clocked, the bound from
            these inputs. Returns (inputs, bucket sums, info)."""
            inputs = pippenger.bucket_inputs(*pts, std, c)
            rows, order = inputs[:2]
            runs = pippenger.split_runs(inputs[2], inputs[3], rows.shape[0])
            name = "K3-G2" if g2 else "K3"
            log(f"  {name} {label}, c = {c}: rows {tuple(rows.shape)}, buckets "
                f"{tuple(inputs[2].shape)}, fullest bucket {int(inputs[3].max())}; L "
                f"{runs.run_length}, {runs.pos.numel()} sub-runs, longest {runs.longest}, most "
                f"sub-runs of a bucket {runs.max_split}")
            check(runs.longest <= runs.run_length, f"{name} {label}: no chain longer than L")
            part = cuda_ops.bucket_runs(rows, order, runs.pos, runs.length)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = cuda_ops.bucket_runs_plain(rows, order, runs.pos, runs.length)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            err = max_abs_diff(part, want)
            check(err == 0, f"{name} {label}, c={c} equals plain on all {inputs[2].shape[0]} "
                  "windows")
            got = cuda_ops.bucket_accumulate(*inputs)
            err = max(err, max_abs_diff(got, pippenger.combine_runs(
                cuda_ops.PLAIN2 if g2 else cuda_ops.PLAIN, want, runs)))
            check(err == 0, f"{name} route {label} (split, K3, combine on K2) equals plain")
            info = dict(err=err, plain_ms=plain_ms,
                        ms=cuda_ms(lambda: cuda_ops.bucket_runs(rows, order, runs.pos,
                                                                runs.length), 5),
                        route_ms=cuda_ms(lambda: cuda_ops.bucket_accumulate(*inputs), 5),
                        bound=runs_bound(g2, rows, order, runs, sum(t.numel() for t in part)))
            log(f"  {name} {label}: kernel {info['ms']:.4f} ms, route (split + K3 + combine) "
                f"{info['route_ms']:.4f} ms, plain {plain_ms:.2f} ms, bound "
                f"{info['bound'][0]:.6f} ms [{card}]")
            return inputs, got, info

        # K3 / K4: the buckets of one 2^15 MSM at c = 10
        scal = torch.from_numpy(FR.encode([rng.randrange(R) for _ in range(N_MAIN)])).to(dev)
        inputs, got, k3 = k3_case("2^15", (gx, gy, params.gs[2]), FR.from_mont(scal), C_MAIN, 0)
        # adversarial: all-equal scalars put every point of a window in one bucket
        eq_int = rng.randrange(R)
        scal_eq = torch.from_numpy(FR.encode([eq_int] * N_MAIN)).to(dev)
        _, _, k3_eq = k3_case("2^15 all-equal scalars", (gx, gy, params.gs[2]),
                              FR.from_mont(scal_eq), C_MAIN, 0)
        kinfo["g1_bucket_accumulate"].update(max_abs_err=max(k3["err"], k3_eq["err"]),
                                             ms=k3["ms"], plain_ms=k3["plain_ms"],
                                             bound=k3["bound"])
        report.update(k3_route_2e15_ms=k3["route_ms"], k3_equal_scalars_2e15_ms=k3_eq["ms"],
                      k3_equal_scalars_route_2e15_ms=k3_eq["route_ms"])
        before = kernels.launch_counts()["g1_horner_join"]
        check(g1_from_device(tuple(t[..., None] for t in msm_g1(params.gs, scal_eq, C_MAIN)))[0]
              == native.g1_msm(pts_host, [eq_int] * N_MAIN),
              "2^15 MSM of all-equal scalars (c = 10, K3) equals native.g1_msm")
        check(kernels.launch_counts()["g1_horner_join"] == before + 1,
              "the MSM joined its windows in one K4 launch")
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
        # K4 at the 2^20 commit's and witness's window shapes (random
        # coordinates: the same arithmetic and branches as points), and at
        # the join's edge cases against the twin
        gen4 = torch.Generator(device=dev).manual_seed(SEED + 4)
        k4_shape_ms = {}
        for windows, c in ((18, 15), (19, 14)):
            s_rand = hbench.random_sums("g1", windows, gen4)
            k4_shape_ms[(windows, c)] = cuda_ms(lambda: cuda_ops.horner_join(s_rand, c), 5)
            report[f"g1_horner_join_w{windows}_c{c}_ms"] = k4_shape_ms[(windows, c)]
            log(f"  K4 W={windows}, c={c} (the 2^20 {'commit' if c == 15 else 'witness'}'s "
                f"windows, every doubling live): kernel {k4_shape_ms[(windows, c)]:.4f} ms "
                f"[{card}]")
        k4_edge_err = {"g1": 0, "g2": 0}
        for group in ("g1", "g2"):
            for case in hbench.CASES:
                s_edge, c = hbench.edge_case_sums(group, case, dev)
                err = max_abs_diff(cuda_ops.horner_join(s_edge, c),
                                   cuda_ops.horner_join_plain(s_edge, c))
                k4_edge_err[group] = max(k4_edge_err[group], err)
                check(err == 0, f"K4 {group} edge case {case} (W={s_edge[0].shape[-1]}, c={c}) "
                      "equals plain")
        kinfo["g1_horner_join"]["max_abs_err"] = max(kinfo["g1_horner_join"]["max_abs_err"],
                                                     k4_edge_err["g1"])

        # K7 at the shape the 2^15 witness gives it: 2^15 - 1 points, c = 9
        nw = N_MAIN - 1
        c9 = pippenger.effective_window(nw)
        std = FR.from_mont(torch.from_numpy(FR.encode([rng.randrange(R) for _ in range(nw)])).to(dev))
        inputs = pippenger.bucket_inputs(gx[:, :nw], gy[:, :nw], params.gs[2][:nw], std, c9)
        runs = pippenger.split_runs(inputs[2], inputs[3], nw)
        fuse = get_config().msm_fuse_steps
        q, skip = pippenger.loop_chunk(inputs[0], inputs[1], runs, 0, fuse)
        q = tuple(t.contiguous() for t in q)
        acc0 = G1.infinity((runs.pos.numel(),), dev)
        k7_mode_w = k7_modes("g1_madd_multi", cuda_ops.madd_multi, cuda_ops.madd_multi_plain,
                             [(acc0, q, skip)], 0, f"2^15 witness (launch 1 of the loop, c = {c9})")
        before, before_m = kernels.launch_counts(), kernels.mode_counts()["g1_madd_multi"]
        loop_acc = pippenger._bucket_loop(G1, *inputs)
        after = kernels.launch_counts()
        k7_launches = after["g1_madd_multi"] - before["g1_madd_multi"]
        took = kernels.mode_counts()["g1_madd_multi"][k7_mode_w] - before_m[k7_mode_w]
        check(max_abs_diff(loop_acc, cuda_ops.bucket_accumulate(*inputs)) == 0,
              f"bucket loop 2^15 - 1, c = {c9} equals the K3 route word for word")
        check(k7_launches == took == -(-runs.longest // fuse) <= -(-runs.run_length // fuse),
              f"the 2^15 witness's bucket loop took ceil(longest / S) = {k7_launches} K7 "
              f"launches, all {k7_mode_w}")
        report.update(
            k7_witness_2e15_launches=k7_launches, k7_witness_2e15_mode=k7_mode_w,
            bucket_loop_witness_2e15_ms=cuda_ms(lambda: pippenger._bucket_loop(G1, *inputs), 3))
        log(f"  K7 at the 2^15 witness shape (c = {c9}): L {runs.run_length}, "
            f"{runs.pos.numel()} sub-run lanes, longest {runs.longest}, most sub-runs of a bucket "
            f"{runs.max_split}; {k7_launches} K7 launches an MSM ({k7_mode_w}; combine: "
            f"{after['g1_add'] - before['g1_add']} K2 adds), bucket loop "
            f"{report['bucket_loop_witness_2e15_ms']:.4f} ms [{card}]")
        del loop_acc, q, skip, acc0

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

        # K5 as a block transform (`ntt_block`): whole transforms at 2^12,
        # 2^15 and 2^20, each direction, plain and coset, with 0, 1 and r - 1
        # planted, against the plain domain word for word; the launches of
        # each; the device time (held stream) and a call's time beside the
        # stage loop it replaced (`as_stages`: a K5 stage launch a stage, a
        # gather, K1 scales) in turns. From here on every ntt_block call is
        # recorded by shape and replayed against the twin in phase 22.
        cuda_field.ntt_block = record_block
        blk_err = 0
        gen_b = torch.Generator(device=dev).manual_seed(SEED + 40)
        for exp in (EXP_EVAL, N_MAIN.bit_length() - 1, EXP_COSET):
            dom = Domain(exp)
            x = random_fr_words(gen_b, (dom.d,), dev)
            x[:, :3] = torch.from_numpy(FR.encode([0, 1, R - 1])).to(dev)
            for name in ("ntt", "intt", "coset_ntt", "coset_intt"):
                before = kernels.launch_counts()
                got = getattr(dom, name)(x)
                torch.cuda.synchronize()
                after = kernels.launch_counts()
                launched = {k: after[k] - before[k] for k in after if after[k] != before[k]}
                err = max_abs_diff(got, getattr(dom.as_plain(), name)(x))
                blk_err = max(blk_err, err)
                check(err == 0, f"ntt_block route {name} 2^{exp} equals the plain domain")
                most = 1 if exp <= ntt_domain.BLOCK_MAX_EXP else 3
                check(sum(launched.values()) <= most and launched.get("ntt_block", 0) >= 1
                      and launched.get("ntt_stage", 0) == 0,
                      f"{name} 2^{exp}: launches {launched} (at most {most}, no ntt_stage)")
                fns = {"block": lambda: getattr(dom, name)(x),
                       "stages": lambda: getattr(dom.as_stages(), name)(x)}
                before = kernels.launch_counts()
                fns["stages"]()
                after = kernels.launch_counts()
                iters = 20 if exp <= 15 else 5
                t = {k: [] for k in fns}
                for k in ("stages", "block", "block", "stages"):
                    t[k].append((peaks.held_ms(fns[k], iters), cuda_ms(fns[k], iters)))
                row = {"exp": exp, "transform": name, "launches": sum(launched.values()),
                       "stages_launches": sum(after[k] - before[k] for k in after)}
                for k, v in t.items():
                    row[f"{k}_ms"] = sum(a for a, _ in v) / len(v)
                    row[f"{k}_call_ms"] = sum(b for _, b in v) / len(v)
                block_transforms.append(row)
                log(f"  {name} 2^{exp}: ntt_block {row['block_ms']:.4f} ms device "
                    f"({row['block_call_ms']:.4f} a call), {row['launches']} launches; stage loop "
                    f"{row['stages_ms']:.4f} ms ({row['stages_call_ms']:.4f}), "
                    f"{row['stages_launches']} launches [{card}]")
            del x
        kinfo["ntt_block"].update(max_abs_err=blk_err, transforms=block_transforms)

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
        check_k2("g2", G2, cuda_ops.g2_add, cuda_ops.g2_dbl, cuda_ops.g2_add_plain,
                 cuda_ops.g2_dbl_plain, p2, q2)
        madd_case(G2, "g2_madd", cuda_ops.g2_madd, cuda_ops.g2_madd_plain, p2,
                  hx[..., n:2 * n].contiguous(), hy[..., n:2 * n].contiguous(),
                  lambda x, y: jacobian2(x, y, gen2), 1)

        # K7 over Fp2, and K4 over Fp2 at the window count of a 2^12-point MSM
        hs12 = tuple(t[..., :n].contiguous() for t in params.hs)
        ints2, s_all2, c2, k7_mode12_g2 = madd_multi_case(
            G2, "g2_madd_multi", cuda_ops.g2_madd_multi, cuda_ops.g2_madd_multi_plain, hs12, 1)
        hs_host = g2_from_device(params.hs)
        check(g2_from_device(tuple(t[..., None] for t in cuda_ops.horner_join(s_all2, c2)))[0]
              == native.g2_msm(hs_host[:n], ints2),
              "K7-G2 + G2 add/dbl + K4-G2 MSM at 2^12 equals the native engine's")

        def g2_bucket_kernels(pts, ints, c, label):
            """K3 and K4 over Fp2 against their twins on one dense MSM's
            buckets, every window; returns (errors, kernel ms, plain ms,
            bounds)."""
            std = FR.from_mont(torch.from_numpy(FR.encode(ints)).to(dev))
            _, got, k3g2 = k3_case(label, pts, std, c, 1)
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
            log(f"  K4-G2 W={windows}, c={c}: kernel {k4_ms:.4f} ms, plain {k4_plain:.2f} ms "
                f"[{card}]")
            return ((k3g2["err"], k4_err), (k3g2["ms"], k4_ms), (k3g2["plain_ms"], k4_plain),
                    (k3g2["bound"], horner_bound(1, windows, c)))

        # a dense 2^12-point MSM's buckets through K3 (c = 7; the MSM itself
        # takes the bucket loop at this size); then the shape the G2 MSM
        # path gives K3 and K4: 2^15 points, c = 10; every window against
        # the twins, and the native engine's MSM for the whole
        errs12, ms12, _, _ = g2_bucket_kernels(hs12, ints2, c2, "2^12")
        report.update(g2_bucket_accumulate_2e12_ms=ms12[0], g2_horner_join_2e12_ms=ms12[1])
        errs, ms, plain, bounds = g2_bucket_kernels(params.hs, scal_ints, C_MAIN, "2^15")
        for i, kname in enumerate(("g2_bucket_accumulate", "g2_horner_join")):
            kinfo[kname].update(max_abs_err=max(errs[i], errs12[i]), ms=ms[i],
                                plain_ms=plain[i], bound=bounds[i])
        kinfo["g2_horner_join"]["max_abs_err"] = max(kinfo["g2_horner_join"]["max_abs_err"],
                                                     k4_edge_err["g2"])
        # K8: k dependent multiplies, against the plain chain at 2^15 lanes;
        # timed at the probe's shape, 2^19 lanes and k = 65, over Fp
        gen8 = torch.Generator(device=dev).manual_seed(SEED + 8)
        k8_err = 0
        for F in (FR, FP):
            a = peaks.random_elements(F, N_MAIN, gen8)
            b = peaks.random_elements(F, N_MAIN, gen8)
            for k in (1, 2, 65):
                want = cuda_field.mul_chain_plain(F, k, a, b)
                err = max(max_abs_diff(cuda_field.mul_chain(F, k, a, b), want),
                          max_abs_diff(cuda_field.mul_chain(F, k, a, b, cooperative=True), want))
                k8_err = max(k8_err, err)
                check(err == 0, f"K8 mul_chain {F.name} k={k} 2^15, one thread and 16 lanes "
                      "an element, equals plain")
        # one product's latency: K8 at one element, k = 65 less k = 1
        latency_us = {}
        for F in (FR, FP):
            for coop in (False, True):
                pk = mul_peak(F, 1, device=dev, cooperative=coop,
                              generator=torch.Generator(device=dev).manual_seed(SEED + 9))
                latency_us[(F.name, coop)] = 1e6 / pk.marginal_rate
        report.update({f"{f.lower()}_mul_latency_{'coop' if coop else 'thread'}_us": v
                       for (f, coop), v in latency_us.items()})
        log("mul latency at one element (K8, k = 65 less k = 1): " + "; ".join(
            f"{f} {'16 lanes' if coop else 'one thread'} {v:.4f} us"
            for (f, coop), v in latency_us.items()) + f" [{card}]")
        # K1's Fermat chain at the path's shapes: one element (the witness's
        # Fr inverse, each to_affine's Fp root), and 16; an inverse and a
        # random exponent, against the plain loop
        pow_err = 0
        pow_ms = {}
        for F in (FR, FP):
            for n_pow in (1, 16):
                a = peaks.random_elements(F, n_pow, gen8)
                a[:, 0] = 0  # inv(0) = 0
                for e in (F.modulus - 2, rng.randrange(F.modulus)):
                    err = max_abs_diff(cuda_field.field_pow(F, a, e),
                                       cuda_field.field_pow_plain(F, a, e))
                    pow_err = max(pow_err, err)
                    check(err == 0, f"field_pow {F.name} at {n_pow} elements, "
                          f"{e.bit_length()}-bit e, equals plain")
                e = F.modulus - 2
                pow_ms[(F.name, n_pow)] = cuda_ms(lambda: cuda_field.field_pow(F, a, e), 20)
                if n_pow == 1:
                    t0 = time.perf_counter()
                    cuda_field.field_pow_plain(F, a, e)
                    torch.cuda.synchronize()
                    pow_ms[(F.name, "plain")] = (time.perf_counter() - t0) * 1e3
                    pow_ms[(F.name, "k1_chain")] = cuda_ms(
                        lambda: cuda_field.field_pow_chain(F, a, e), 3)
                report[f"field_pow_{F.name.lower()}_{n_pow}_ms"] = pow_ms[(F.name, n_pow)]
            log(f"  field_pow {F.name}, e = m - 2 ({F.modulus.bit_length()} bits): kernel "
                f"{pow_ms[(F.name, 1)]:.4f} ms at 1 element, {pow_ms[(F.name, 16)]:.4f} ms at 16; "
                f"the K1 chain it replaced {pow_ms[(F.name, 'k1_chain')]:.4f} ms; plain "
                f"{pow_ms[(F.name, 'plain')]:.2f} ms [{card}]")
        e_fp = P - 2
        kinfo["field_pow"].update(
            max_abs_err=pow_err, ms=pow_ms[("Fp", 1)], plain_ms=pow_ms[("Fp", "plain")],
            bound=bound(2 * 48, (e_fp.bit_length() + bin(e_fp).count("1")) * FP_MUL_MADS),
            chain_ms=e_fp.bit_length() * latency_us[("Fp", True)] * 1e-3)
        report["field_pow_fr_chain_ms"] = (R - 2).bit_length() * latency_us[("Fr", True)] * 1e-3

        # field_scan: Fr and Fp, mul and add, forward and reverse, the array,
        # column, total and pair modes, 16 rows up to 2^15 and one at 2^20 (edges 0,
        # 1, m - 1 first); then timed at the paths' shapes beside the chain of
        # K1 launches it replaced (`field_scan_chain`)
        scan_err = 0
        scan_cases = (("array", False), ("array", True), ("total", False), ("column", False),
                      ("pair", False))
        for F in (FR, FP):
            edge = torch.from_numpy(F.encode([0, 1, F.modulus - 1])).to(dev)
            for n_scan in (1, 3, 4097, N_MAIN, 1 << 20):
                for rows in ((1, 16) if n_scan <= N_MAIN else (1,)):
                    a = peaks.random_elements(F, rows * n_scan, gen8).reshape(F.W, rows, n_scan)
                    a[:, 0, :3] = edge[:, :n_scan]
                    col = a[..., -1].contiguous()
                    for op in (cuda_field.ADD, cuda_field.MUL):
                        for mode, rev in scan_cases:
                            src = col if mode == "column" else a
                            err = max_abs_diff(
                                cuda_field.field_scan(F, op, src, rev, mode, n_scan),
                                cuda_field.field_scan_plain(F, op, src, rev, mode, n_scan))
                            scan_err = max(scan_err, err)
                    check(scan_err == 0, f"field_scan {F.name} at {n_scan} x {rows} rows: add and "
                          "mul, forward, reverse, total, column and pair, equal plain")
        del a, col, src
        scan_ms = {}
        for F, op, mode, rev, n_scan, what in (
                (FP, cuda_field.MUL, "array", False, N_MAIN, "Fp prefix product 2^15 (batch_inv)"),
                (FR, cuda_field.MUL, "column", False, 1 << 20, "Fr powers 2^20 (setup_device)"),
                (FR, cuda_field.ADD, "array", True, N_MAIN, "Fr suffix sum 2^15"),
                (FR, cuda_field.ADD, "total", False, 1 << 12, "Fr sum of 2^12 (sum_last)")):
            a = peaks.random_elements(F, n_scan, gen8)
            src = a[:, -1].contiguous() if mode == "column" else a
            fn = lambda: cuda_field.field_scan(F, op, src, rev, mode, n_scan)  # noqa: E731
            kms = cuda_ms(fn, 20)
            chain = cuda_ms(lambda: cuda_field.field_scan_chain(F, op, src, rev, mode, n_scan), 3)
            _, pms = once_ms(lambda: cuda_field.field_scan_plain(F, op, src, rev, mode, n_scan))
            moved = (0 if mode == "column" else 1) + (0 if mode == "total" else 1)
            b = bound(4 * F.W * (n_scan * moved + 1),
                      n_scan * ((2 * F.W * F.W + F.W) if op == cuda_field.MUL else 2 * F.W))
            scan_ms[what] = dict(ms=kms, plain_ms=pms, k1_chain_ms=chain, bound=b)
            log(f"  field_scan {what}: kernel {kms:.4f} ms, the K1 chain it replaced "
                f"{chain:.4f} ms, plain {pms:.2f} ms, bound {b[0]:.6f} ms ({b[1]}) [{card}]")
        kinfo["field_scan"].update(max_abs_err=scan_err,
                                   shapes={k: {kk: vv for kk, vv in v.items() if kk != "bound"}
                                           for k, v in scan_ms.items()},
                                   **scan_ms["Fp prefix product 2^15 (batch_inv)"])

        # fr_horner: division and remainder alone, 1 and 16 points (one of
        # them 0), with and without a carry in; timed at the witness's and the
        # evaluation check's shapes beside the K1 chain it replaced
        hor_err = 0
        gen9 = torch.Generator(device=dev).manual_seed(SEED + 9)
        for n_h in (2, 4097, N_MAIN, 1 << 20):
            f_h = random_fr_words(gen9, (n_h,), dev)
            for k_h in (1, 16):
                x_h = random_fr_words(gen9, (k_h,), dev)
                if k_h > 1:
                    x_h[:, 1] = 0
                cin = random_fr_words(gen9, (k_h,), dev)
                for carry in (None, cin):
                    for rem_only in (False, True):
                        got = horner_mod.fr_horner(f_h, x_h, carry, rem_only)
                        want = horner_mod.fr_horner_plain(f_h, x_h, carry, rem_only)
                        err = max_abs_diff(got[1], want[1])
                        if not rem_only:
                            err = max(err, max_abs_diff(got[0], want[0]))
                        hor_err = max(hor_err, err)
                        del got, want
                check(hor_err == 0, f"fr_horner at n = {n_h}, {k_h} points: division and "
                      "remainder, with and without a carry in, equal plain")
            if n_h == 4097:
                ints = FR.decode(f_h)
                xv = FR.decode(x_h[:, :1])[0]
                check(FR.decode(horner_mod.fr_horner(f_h, x_h[:, :1])[1]) == [horner(ints, xv, R)],
                      "fr_horner's remainder at n = 4097 equals Python's Horner")
        hor_ms = {}
        for n_h, k_h, rem_only, what in ((N_MAIN, 1, False, "division 2^15 (witness)"),
                                         (1 << 20, 1, False, "division 2^20 (witness)"),
                                         (N_MAIN, 1, True, "evaluation 2^15 (check)"),
                                         (N_MAIN, K_BATCH, True, "evaluation 2^15 at 16 points"),
                                         (N_MAIN, 63, True, "evaluation 2^15 at 63 points")):
            f_h = random_fr_words(gen9, (n_h,), dev)
            x_h = random_fr_words(gen9, (k_h,), dev)
            fn = lambda: horner_mod.fr_horner(f_h, x_h, rem_only=rem_only)  # noqa: E731
            kms = cuda_ms(fn, 20)
            chain = cuda_ms(lambda: horner_mod.fr_horner_chain(f_h, x_h, rem_only=rem_only), 3)
            _, pms = once_ms(lambda: horner_mod.fr_horner_plain(f_h, x_h, rem_only=rem_only))
            b = bound(32 * (n_h + (0 if rem_only else k_h * (n_h - 1)) + 2 * k_h),
                      k_h * n_h * (FR_MUL_MADS + 16))
            hor_ms[what] = dict(ms=kms, plain_ms=pms, k1_chain_ms=chain, bound=b)
            power = ""
            if rem_only:
                # the chunked power method with its scans on field_scan: the
                # route Horner's remainder takes the place of at every k
                pm = lambda: horner_mod.evaluation_formula(  # noqa: E731
                    FR, cuda_field.field_scan, f_h, x_h)
                check(max_abs_diff(pm(), fn()[1]) == 0,
                      f"fr_horner {what}: the power method on field_scan gives the same words")
                hor_ms[what]["power_method_ms"] = cuda_ms(pm, 5)
                power = f", the power method on field_scan {hor_ms[what]['power_method_ms']:.4f} ms"
            log(f"  fr_horner {what}: kernel {kms:.4f} ms, the K1 chain it replaced "
                f"{chain:.4f} ms{power}, plain {pms:.2f} ms, bound {b[0]:.6f} ms ({b[1]}) "
                f"[{card}]")
        kinfo["fr_horner"].update(max_abs_err=hor_err,
                                  shapes={k: {kk: vv for kk, vv in v.items() if kk != "bound"}
                                          for k, v in hor_ms.items()},
                                  **hor_ms["division 2^15 (witness)"])
        del f_h, x_h

        # the digit ladder at the group iNTT's shape (2^11 lanes, c = 4, 64
        # windows), G1 and G2, against its twin; its edge cases against the
        # twin and the oracle; timed also at 2^12 and 2^14 lanes
        c_lad = get_config().group_ladder_window
        w_lad = -(-255 // c_lad)
        gen_l = torch.Generator(device=dev).manual_seed(SEED + 10)
        for group, kname in (("g1", "g1_ladder"), ("g2", "g2_ladder")):
            g2 = group == "g2"
            tab = lbench.random_ladder(group, N_POINT // 2, c_lad, w_lad, gen_l)
            tab[2][1] = True  # p infinite
            tab[3][:, 2] = 0  # every round skipped
            got = cuda_ops.ladder(*tab, c_lad)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = cuda_ops.ladder_plain(*tab, c_lad)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            err = max_abs_diff(got, want)
            check(err == 0, f"{kname} {N_POINT // 2} lanes, c = {c_lad}, W = {w_lad} equals plain")
            etab = lbench.edge_case(group, dev)
            got = cuda_ops.ladder(*etab[:5])
            e_err = max_abs_diff(got, cuda_ops.ladder_plain(*etab[:5]))
            check(e_err == 0 and (g2_from_device if g2 else g1_from_device)(got) == etab[5],
                  f"{kname} edge cases (P == Q, P == -Q, zero digits, p infinite, inf + Q) "
                  "equal plain and the oracle")
            live = int((tab[3] != 0).sum())
            muls = (w_lad * c_lad * POINT_MULS["dbl"][g2] * tab[3].shape[1]
                    + live * POINT_MULS["madd"][g2])
            coord_b = 96 if g2 else 48
            lanes_l = tab[3].shape[1]
            kinfo[kname].update(
                max_abs_err=max(err, e_err), ms=cuda_ms(lambda: cuda_ops.ladder(*tab, c_lad), 5),
                plain_ms=plain_ms,
                bound=bound(coord_b * (2 * ((1 << c_lad) - 1) + 3) * lanes_l
                            + 4 * w_lad * lanes_l + lanes_l, muls * FP_MUL_MADS),
                muls=muls)
            for lanes_t in (N_POINT, 1 << (EXP_LAGRANGE - 1)):
                tab_t = lbench.random_ladder(group, lanes_t, c_lad, w_lad, gen_l)
                report[f"{kname}_{lanes_t}_ms"] = cuda_ms(lambda: cuda_ops.ladder(*tab_t, c_lad), 3)
            log(f"  {kname} c = {c_lad}, W = {w_lad}: kernel {kinfo[kname]['ms']:.4f} ms at "
                f"{lanes_l} lanes, {report[f'{kname}_{N_POINT}_ms']:.4f} ms at {N_POINT}, "
                f"{report[f'{kname}_{1 << (EXP_LAGRANGE - 1)}_ms']:.4f} ms at "
                f"{1 << (EXP_LAGRANGE - 1)}; plain {plain_ms:.2f} ms [{card}]")
            del tab, tab_t

        # the fixed-base comb (FK20's MSM): its edge cases against the twin
        # and the oracle on a table made on the card, then FK20's shape
        # (73,728 lanes over 8,192 points) on a random table against the twin
        base_c, pts_c, sc_c = cbench.edge_case(dev)
        table_c = pippenger.comb_table(base_c)
        got = cuda_ops.fk20_comb(*table_c, sc_c)
        e_err = max_abs_diff(got, cuda_ops.fk20_comb_plain(*table_c, sc_c))
        ks = [int(v) for v in cbench.EDGE_SCALARS.values()]
        want = [None if pt is None or k % R == 0 else ec_mul(pt, k % R)
                for k in ks for pt in pts_c]
        check(e_err == 0 and g1_from_device(tuple(
            t[:, :len(ks)].reshape(12, -1) for t in got)) == want,
            "g1_fk20_comb edge cases (0, 1, r - 1, all digits 15, P == -Q, P == Q, an "
            "infinite point) equal plain and the oracle")
        gen_c = torch.Generator(device=dev).manual_seed(SEED + 21)
        rows_c, inf_c = cbench.random_comb(cbench.FREQS * cbench.COLS, gen_c)
        sc_c = cbench.random_scalars((cbench.BLOBS, cbench.FREQS, cbench.COLS), gen_c)
        got = cuda_ops.fk20_comb(rows_c, inf_c, sc_c)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = cuda_ops.fk20_comb_plain(rows_c, inf_c, sc_c)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = max_abs_diff(got, want)
        lanes_c = sc_c[0].numel()
        check(err == 0, f"g1_fk20_comb {lanes_c} lanes over {rows_c.shape[1]} points equals plain")
        words_c = sc_c.to(torch.int64) & 0xFFFFFFFF
        live = int(sum(((words_c >> (4 * k)) & 15).ne(0).sum() for k in range(8)))
        muls = live * POINT_MULS["madd"][0]
        kinfo["g1_fk20_comb"].update(
            max_abs_err=max(err, e_err), plain_ms=plain_ms, muls=muls, lanes=lanes_c,
            ms=cuda_ms(lambda: cuda_ops.fk20_comb(rows_c, inf_c, sc_c), 5),
            bound=bound(96 * live + (32 + 144) * lanes_c, muls * FP_MUL_MADS))
        log(f"  g1_fk20_comb at {lanes_c} lanes ({live} madds): kernel "
            f"{kinfo['g1_fk20_comb']['ms']:.4f} ms, plain {plain_ms:.2f} ms, bound "
            f"{kinfo['g1_fk20_comb']['bound'][0]:.6f} ms ({kinfo['g1_fk20_comb']['bound'][1]}) "
            f"[{card}]")
        del rows_c, inf_c, sc_c, table_c, got, want

        lanes8 = 1 << 19
        a = peaks.random_elements(FP, lanes8, gen8)
        b = peaks.random_elements(FP, lanes8, gen8)
        kinfo["mul_chain"].update(
            max_abs_err=k8_err,
            ms=cuda_ms(lambda: cuda_field.mul_chain(FP, peaks.K_LONG, a, b), 10),
            plain_ms=cuda_ms(lambda: cuda_field.mul_chain_plain(FP, peaks.K_LONG, a, b), 1),
            bound=bound(3 * 48 * lanes8, peaks.K_LONG * FP_MUL_MADS * lanes8))

        # K9: the digit sums of a real 128-point DFT product at 2^15 lanes, and
        # the largest legal digit sums; then timed, with the product, on the
        # first pass of the 2^20 NTT: 128-point blocks over 8192 columns
        x15 = x20[:, :N_MAIN].reshape(FR.W, 128, N_MAIN // 128)
        y15 = mxu.digit_sums(7, False, mxu.to_planes(x15, 7))
        check(torch.equal(y15, mxu.digit_sums_plain(7, False, mxu.to_planes(x15, 7))),
              "matmul-DFT product (torch._int_mm, shifted operands) equals the float64 product")
        y15 = y15.reshape(mxu.OUT_DIGITS, N_MAIN)
        k9_err = max_abs_diff(mxu.mxu_reduce(y15), mxu.mxu_reduce_plain(y15))
        check(k9_err == 0, "K9 mxu_reduce (64, 2^15) of a real product equals plain")
        check(torch.equal(mxu.dft_axis2(7, False, x15), Domain(7)._ntt_axis2(x15, False)),
              "matmul-DFT block 2^7 x 256 equals the butterfly stages (K5)")
        pairs = [min(mxu.PLANES - 1, dg) - max(0, dg - mxu.PLANES + 1) + 1
                 for dg in range(mxu.OUT_DIGITS - 1)] + [0]
        y_top = (torch.tensor(pairs, device=dev)[:, None] * (255 * 255 * 128)).to(
            torch.int32).expand(-1, N_MAIN).contiguous()
        err = max_abs_diff(mxu.mxu_reduce(y_top), mxu.mxu_reduce_plain(y_top))
        k9_err = max(k9_err, err)
        check(err == 0, "K9 mxu_reduce on the largest legal digit sums equals plain")
        x_pass = x20.reshape(FR.W, 128, d20 // 128)
        planes20 = mxu.to_planes(x_pass, 7)
        y20 = mxu.digit_sums(7, False, planes20).reshape(mxu.OUT_DIGITS, d20)
        err = max_abs_diff(mxu.mxu_reduce(y20), mxu.mxu_reduce_plain(y20))
        k9_err = max(k9_err, err)
        check(err == 0, "K9 mxu_reduce (64, 2^20), a 2^20 NTT's first pass, equals plain")
        w8, _ = mxu._wbig_device(7, False, dev, signed=True)
        x8 = planes20.bitwise_xor(0x80).view(torch.int8)  # column-major, as to_planes lays it out
        x8_rows = x8.contiguous()
        report.update(
            mxu_planes_2e20_ms=cuda_ms(lambda: mxu.to_planes(x_pass, 7), 5),
            mxu_product_2e20_ms=cuda_ms(lambda: mxu.digit_sums(7, False, planes20), 5),
            mxu_int_mm_2e20_ms=cuda_ms(lambda: torch._int_mm(w8, x8), 5),
            mxu_int_mm_rowmajor_2e20_ms=cuda_ms(lambda: torch._int_mm(w8, x8_rows), 5),
            mxu_float64_product_2e20_ms=cuda_ms(
                lambda: mxu.digit_sums_plain(7, False, planes20), 2))
        log(f"  matmul-DFT pass at 2^20 (8192 x 4096 @ 4096 x 8192): plane split "
            f"{report['mxu_planes_2e20_ms']:.4f} ms, product {report['mxu_product_2e20_ms']:.4f} ms "
            f"(torch._int_mm alone {report['mxu_int_mm_2e20_ms']:.4f} ms; on a row-major right "
            f"side {report['mxu_int_mm_rowmajor_2e20_ms']:.4f} ms), float64 matmul "
            f"{report['mxu_float64_product_2e20_ms']:.4f} ms [{card}]")
        kinfo["mxu_reduce"].update(
            max_abs_err=k9_err,
            ms=cuda_ms(lambda: mxu.mxu_reduce(y20), 10),
            plain_ms=cuda_ms(lambda: mxu.mxu_reduce_plain(y20), 1),
            bound=bound((4 * mxu.OUT_DIGITS + 32) * d20, (8 * 8 + 8) * d20))
        del y20, planes20, x8, x8_rows, y_top, y15

        for k, v in kinfo.items():
            # K2 and K7 logged their modes above and K6 its widths;
            # ntt_block's row is timed in phase 22, at the paths' shapes, and
            # the pairing kernels' in phase 23b
            if ("modes" not in v and "widths" not in v
                    and k not in ("ntt_block", "miller_loop", "final_exp")):
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
        t0 = time.perf_counter()
        gparams = setup(int(vec["secret"], 16), v["n"], device=dev)  # the device route
        torch.cuda.synchronize()
        first_setup_s = time.perf_counter() - t0
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
        before = kernels.launch_counts()
        t0 = time.perf_counter()
        witness = prover.create_witness(poly, (x, y))
        torch.cuda.synchronize()
        witness_s = time.perf_counter() - t0
        mid = kernels.launch_counts()
        verifier = KZGVerifier(params)
        t0 = time.perf_counter()
        ok = verifier.verify_eval((x, y), commitment, witness)
        verify_s = time.perf_counter() - t0
        after = kernels.launch_counts()
        check(ok, "2^15 verify_eval accepts")
        # the witness's evaluation check and division run on fr_horner (they
        # took 181 K1 launches and one field_pow); each inverse of verify_eval
        # is one field_pow launch (the Fp chain of p - 2 was 609 K1 launches)
        names = ("field_elementwise", "field_pow", "field_scan", "fr_horner")
        k1_w, pow_w, scan_w, hor_w = (mid[k] - before[k] for k in names)
        k1_v, pow_v, scan_v, hor_v = (after[k] - mid[k] for k in names)
        log(f"  launches: witness K1 {k1_w}, field_pow {pow_w}, field_scan {scan_w}, fr_horner "
            f"{hor_w}; verify_eval K1 {k1_v}, field_pow {pow_v}, field_scan {scan_v}, "
            f"fr_horner {hor_v}")
        check(hor_w >= 1 and k1_w <= 10,
              f"the witness divides on fr_horner ({hor_w} launches) with {k1_w} <= 10 K1 "
              "launches (181 before)")
        check(pow_v == 2 and k1_v < 609,
              f"verify_eval's two affine conversions take two field_pow launches and "
              f"{k1_v} < 609 K1 launches")
        check(not verifier.verify_eval((x, (y + 1) % R), commitment, witness),
              "2^15 verify_eval rejects a tampered y")
        log(f"  2^15 commit {commit_s:.4f} s (runs {', '.join(f'{t:.4f}' for t in times)}), "
            f"{N_MAIN / commit_s:.0f} points/s; witness {witness_s:.4f} s; "
            f"verify {verify_s:.4f} s; native host MSM {native_s:.4f} s; setup {setup_s:.2f} s "
            f"[{card}]")
        report.update(commit_s=commit_s, witness_s=witness_s, verify_s=verify_s,
                      points_per_s=N_MAIN / commit_s, witness_2e15_k1_launches=k1_w,
                      witness_2e15_fr_horner_launches=hor_w)
        witness15 = (prover, poly, x, y)  # profiled by phase with --profile
        single15 = (params, commitment, witness, x, y)  # verified again on the device (24)

    # ---- 6. launch counts of the single-opening path ---------------------------------------------
    with phase("launch counts 4-5"):
        counts_single, modes_single = kernels.launch_counts(), kernels.mode_counts()
        log(f"  {counts_single}")
        log(f"  K2 and K7 by mode: {modes_single}")
        for k in ("field_elementwise", "field_pow", "field_scan", "fr_horner", "g1_add", "g1_dbl",
                  "g1_bucket_accumulate", "g1_madd_multi", "g1_horner_join"):
            check(counts_single[k] > 0,
                  f"{k} launched {counts_single[k]} times on the single-opening path")
        for k in ("g1_add", "g1_dbl"):  # the reductions' last levels hold a few points
            check(modes_single[k]["narrow"] > 0,
                  f"{k} took its narrow mode {modes_single[k]['narrow']} times on the "
                  "single-opening path")
        check(counts_single["ntt_stage"] == 0, "no per-stage K5 launch on the single-opening path")
        check(modes_single["g1_madd_multi"][k7_mode_w] > 0,
              f"g1_madd_multi took the mode its rule picks at the witness's shape, {k7_mode_w}, "
              f"{modes_single['g1_madd_multi'][k7_mode_w]} times on the single-opening path")

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
        batched15 = (commitment, bw, list(xs))  # verified again on the device (24)
        batched_verify = (lambda v=verifier, c=commitment, w=bw, x=list(xs):
                          v.verify_eval_batched(c, w, x))  # profiled with --profile

    with phase(f"coset division 2^{EXP_COSET}"):
        n = 1 << EXP_COSET
        gen = torch.Generator(device=dev).manual_seed(SEED + 3)
        poly = Polynomial(random_fr_words(gen, (n,), dev))
        xs = [rng.randrange(R) for _ in range(K_BATCH)]
        xs_d = torch.from_numpy(FR.encode(xs)).to(dev)
        numerator = poly - lagrange_interpolation(xs_d, poly.eval_many(xs_d))
        z = vanishing_poly(xs_d)
        torch.cuda.synchronize()
        before = kernels.launch_counts()
        t0 = time.perf_counter()
        q = KZGProver._exact_div(numerator, z, xs_int=xs)
        torch.cuda.synchronize()
        div_s = time.perf_counter() - t0
        after = kernels.launch_counts()
        log(f"  coset division launches: "
            f"{ {k: after[k] - before[k] for k in after if after[k] != before[k]} }")
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
        coset_case = (numerator, z, xs, q)  # divided again under ntt_mxu="auto" (phase 16)

    # ---- 10. launch counts of the batched path ---------------------------------------------------
    with phase("launch counts 7-9"):
        counts_batched, modes_batched = kernels.launch_counts(), kernels.mode_counts()
        log(f"  {counts_batched}")
        log(f"  K2 and K7 by mode: {modes_batched}")
        # h^Z and g^r (17 and 16 points): the digit ladder, its tables on
        # narrow K2 adds; no G2 doubling is left on the path
        check(modes_batched["g2_add"]["narrow"] > 0 and counts_batched["g2_dbl"] == 0,
              f"g2_add took its narrow mode {modes_batched['g2_add']['narrow']} times on the "
              f"batched path, g2_dbl {counts_batched['g2_dbl']} times")
        for k in ("field_elementwise", "field_scan", "fr_horner", "g1_add", "g1_dbl",
                  "g1_bucket_accumulate", "g1_madd_multi", "g1_horner_join", "ntt_block", "g2_add",
                  "g1_ladder", "g2_ladder"):
            check(counts_batched[k] > 0,
                  f"{k} launched {counts_batched[k]} times on the batched path")
        check(counts_batched["ntt_stage"] == 0,
              "the batched path transforms on ntt_block, no per-stage K5 launch")

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
            before = kernels.launch_counts()
            t0 = time.perf_counter()
            basis[curve.name] = curve.to_affine(eval_form._group_intt(curve, src, dom12))
            torch.cuda.synchronize()
            group_s[curve.name] = time.perf_counter() - t0
            check_group_launches(curve.name.lower(), before, EXP_EVAL)

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
            before = kernels.launch_counts()["g2_horner_join"]
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = msm_g2(pts, scal)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            g2_s = sorted(times)[1]
            check(kernels.launch_counts()["g2_horner_join"] == before + 3,
                  f"msm_g2 2^{exp} joined its windows in one K4 launch a call")
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
        configure(setup_engine="host")
        ref = compute_lagrange_basis_from_secret(SEED, EXP_EVAL, device=dev)
        configure(setup_engine="auto")
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
        # verified on the device engine in phase 24
        eval12 = (lag, commitment, witness, index, evals[index], bw, tampered)
        report.update(lagrange_g1_s=group_s["G1"], lagrange_g2_s=group_s["G2"],
                      eval_commit_s=ecommit_s, eval_witness_s=ewitness_s,
                      eval_verify_s=everify_s, eval_verify_poly_s=vpoly_s,
                      eval_verify_all_s=vall_s)

    # ---- 14. launch counts of the evaluation-form path ---------------------------------------
    with phase("launch counts 11-13"):
        counts_eval, modes_eval = kernels.launch_counts(), kernels.mode_counts()
        log(f"  {counts_eval}")
        log(f"  K2 and K7 by mode: {modes_eval}")
        for k, n_launch in counts_eval.items():
            # a 2^12-point G1 MSM takes the bucket loop on K7, so this run
            # gives the G1 instantiation of K3 nothing; K8 and K9 belong to
            # the probe and the matmul-DFT NTT (phases 15-16); K6's madd
            # runs inside the ladder kernel; the evaluation form divides in
            # evaluation form, without fr_horner; its transforms take ntt_block,
            # never the per-stage K5; its verifiers pair on the host engine
            # (the pairing kernels run under pairing_engine="device", phase 24);
            # the comb runs only FK20's MSM (kzg/das.py)
            check(n_launch > 0 or k in ("g1_bucket_accumulate", "mul_chain", "mxu_reduce",
                                        "g1_madd", "g2_madd", "fr_horner", "ntt_stage",
                                        "miller_loop", "final_exp", "g1_fk20_comb"),
                  f"{k} launched {n_launch} times on the G2 MSM and evaluation-form path")
        check(counts_eval["ntt_stage"] == 0,
              "the evaluation-form path transforms on ntt_block, no per-stage K5 launch")
        check(counts_eval["g1_madd"] == 0 and counts_eval["g2_madd"] == 0,
              "no stand-alone madd launch on the evaluation-form path (the ladder has them)")
        for k, m in (("g1_madd_multi", k7_mode12), ("g2_madd_multi", k7_mode12_g2)):
            check(modes_eval[k][m] > 0, f"{k} took the mode its rule picks at a 2^12-point "
                  f"MSM's shape, {m}, {modes_eval[k][m]} times on the G2 MSM and "
                  "evaluation-form path")

    # ---- 15-17. the probe, the matmul-DFT NTT, device setup and the 2^20 path, counted -----------
    kernels.reset_launches()

    with phase("mul peaks 2^19"):
        for F, mads in ((FR, FR_MUL_MADS), (FP, FP_MUL_MADS)):
            pk = mul_peak(F, 1 << 19, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(SEED + 15))
            assumed = INT_MADS_PER_S / mads
            log(f"  {F.name} mul: k = 65 rate {pk.rate:.4e} /s, marginal rate "
                f"{pk.marginal_rate:.4e} /s, k = 1 launch {pk.launch_ms:.4f} ms, k = 65 launch "
                f"{pk.long_ms:.4f} ms; the bound assumes {assumed:.4e} /s "
                f"({mads} multiply-adds each): measured / assumed "
                f"{pk.marginal_rate / assumed:.3f} [{card}]")
            check(pk.marginal_rate > 0 and pk.long_ms > pk.launch_ms,
                  f"{F.name} multiply chain: 65 products take longer than 1")
            report[f"{F.name.lower()}_mul_per_s"] = pk.marginal_rate
            report[f"{F.name.lower()}_mul_launch_ms"] = pk.launch_ms

    with phase("matmul-DFT NTT 2^14, 2^15, 2^20"):
        gen = torch.Generator(device=dev).manual_seed(SEED + 16)
        for exp in (14, 15, EXP_COSET):
            dom = Domain(exp)
            x = random_fr_words(gen, (dom.d,), dev)
            configure(ntt_mxu="off")
            want = (dom.ntt(x), dom.intt(x))
            off_ms = cuda_ms(lambda: dom.ntt(x), 5)
            configure(ntt_mxu="auto")
            before = kernels.launch_counts()
            got = (dom.ntt(x), dom.intt(x))
            after = kernels.launch_counts()
            check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                  f"Domain({exp}) ntt and intt under ntt_mxu=auto equal ntt_mxu=off, split "
                  f"{dom._fs_split(dev)}")
            check(after["mxu_reduce"] > before["mxu_reduce"]
                  and after["ntt_stage"] == before["ntt_stage"]
                  and after["ntt_block"] == before["ntt_block"],
                  f"the transforms launched K9 {after['mxu_reduce'] - before['mxu_reduce']} times "
                  "and neither K5 entry")
            on_ms = cuda_ms(lambda: dom.ntt(x), 5)
            configure(ntt_mxu="off")
            log(f"  NTT 2^{exp}: ntt_mxu=auto {on_ms:.4f} ms, off {off_ms:.4f} ms "
                f"({on_ms / off_ms:.2f}x) [{card}]")
            report[f"ntt_mxu_2e{exp}_ms"] = on_ms
            report[f"ntt_off_2e{exp}_ms"] = off_ms
        configure(ntt_mxu="auto")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        q_mxu = KZGProver._exact_div(coset_case[0], coset_case[1], xs_int=coset_case[2])
        torch.cuda.synchronize()
        div_mxu_s = time.perf_counter() - t0
        configure(ntt_mxu="off")
        check(q_mxu == coset_case[3] and q_mxu.num_coeffs() == coset_case[3].num_coeffs(),
              f"coset division 2^{EXP_COSET} under ntt_mxu=auto gives the same quotient")
        log(f"  coset division 2^{EXP_COSET}: ntt_mxu=auto {div_mxu_s:.4f} s, off {div_s:.4f} s "
            f"[{card}]")
        report.update(coset_div_mxu_2e20_s=div_mxu_s)

    with phase("device setup 2^15"):
        check(get_config().setup_engine == "auto", "the default engine on a card is the device route")
        dparams, dsetup_s, dtimes = median3(lambda: setup(SEED, N_MAIN, device=dev))
        check(all(torch.equal(a, b) for a, b in zip(dparams.gs + dparams.hs,
                                                    params.gs + params.hs)),
              "setup_device(s, 2^15) equals the host engine's SRS in every coordinate of gs, hs")
        log(f"  setup 2^15 by the device route: {dsetup_s:.4f} s (runs "
            f"{', '.join(f'{t:.4f}' for t in dtimes)}); the first device setup of the run, 2^10 "
            f"with the table load and validation, {first_setup_s:.4f} s; host engine "
            f"{setup_s:.2f} s ({how}) [{card}]")
        report.update(setup_device_2e15_s=dsetup_s)
        del dparams

    with phase("main path 2^20"):
        n20 = 1 << 20
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        big = setup_device(SEED, n20, g2_count=2, device=dev)
        torch.cuda.synchronize()
        setup20_s = time.perf_counter() - t0
        check(big.gs[0].shape[-1] == n20 and big.hs[0].shape[-1] == 2,
              "setup_device(s, 2^20, g2_count=2): 2^20 G1 powers, 2 G2 powers")
        spots = [0, 1, n20 // 2, n20 - 1]
        check(g1_from_device(tuple(t[..., spots] for t in big.gs))
              == [native.g1_mul(g1_generator(), pow(SEED, i, R)) for i in spots],
              "powers 0, 1, 2^19 and 2^20 - 1 equal native.g1_mul(g, s^i)")
        gen = torch.Generator(device=dev).manual_seed(SEED + 17)
        poly = Polynomial(random_fr_words(gen, (n20,), dev))
        coeffs = poly.to_ints()
        prover = KZGProver(big)
        commitment, commit20_s, ctimes = median3(lambda: prover.commit(poly))
        c_host = g1_from_device(tuple(t[..., None] for t in commitment))[0]
        check(c_host == native.g1_mul(g1_generator(), horner(coeffs, SEED, R)),
              "2^20 commitment equals f(s) G")
        t0 = time.perf_counter()
        big_host = g1_from_device(big.gs)
        want_pt = native.g1_msm(big_host, coeffs)
        native_s = time.perf_counter() - t0
        check(c_host == want_pt, "2^20 commitment equals native.g1_msm (affine)")
        del big_host
        x = rng.randrange(R)
        y = horner(coeffs, x, R)
        witness, witness20_s, wtimes = median3(
            lambda: prover.create_witness(poly, (x, y), check=False))
        # the device memory the witness and its division take above what is
        # resident (the SRS, f): peak less allocated before, one call each
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        prover.create_witness(poly, (x, y), check=False)
        torch.cuda.synchronize()
        witness_peak = torch.cuda.max_memory_allocated() - resident
        pt20 = torch.from_numpy(FR.encode([x])).to(dev)
        torch.cuda.reset_peak_memory_stats()
        (_, _), div20_s, dtimes = median3(lambda: poly_mod._div_by_linear(poly.trimmed(), pt20))
        div_peak = torch.cuda.max_memory_allocated() - resident
        log(f"  2^20 witness: peak device memory above the resident {resident / 2**20:.1f} MiB "
            f"(SRS, f) {witness_peak / 2**20:.1f} MiB; the division alone {div20_s:.6f} s (runs "
            f"{', '.join(f'{t:.6f}' for t in dtimes)}), peak above resident "
            f"{div_peak / 2**20:.1f} MiB (q alone {8 * 4 * (n20 - 1) / 2**20:.1f} MiB) [{card}]")
        report.update(witness_2e20_peak_mib=witness_peak / 2**20,
                      division_2e20_s=div20_s, division_2e20_peak_mib=div_peak / 2**20)
        verifier = KZGVerifier(big)
        t0 = time.perf_counter()
        ok = verifier.verify_eval((x, y), commitment, witness)
        verify20_s = time.perf_counter() - t0
        check(ok, "2^20 verify_eval accepts")
        check(not verifier.verify_eval((x, (y + 1) % R), commitment, witness),
              "2^20 verify_eval rejects a tampered y")
        log(f"  2^20: setup_device {setup20_s:.4f} s; commit {commit20_s:.4f} s "
            f"(runs {', '.join(f'{t:.4f}' for t in ctimes)}), {n20 / commit20_s:.0f} points/s; "
            f"witness {witness20_s:.4f} s (runs {', '.join(f'{t:.4f}' for t in wtimes)}); "
            f"verify {verify20_s:.4f} s; points to the host and native g1_msm {native_s:.2f} s "
            f"[{card}]")
        report.update(setup_device_2e20_s=setup20_s, commit_2e20_s=commit20_s,
                      points_per_s_2e20=n20 / commit20_s, witness_2e20_s=witness20_s,
                      verify_2e20_s=verify20_s)
        big_gs = big.gs  # K3 is timed at the witness's shape after the count (phase 19)
        witness20 = (prover, poly, x, y)  # profiled by phase with --profile
        del big, verifier

    with phase(f"Lagrange SRS from the secret, device route 2^{EXP_EVAL}"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref_dev = compute_lagrange_basis_from_secret(SEED, EXP_EVAL, device=dev)
        torch.cuda.synchronize()
        secret_dev_s = time.perf_counter() - t0
        check(all(torch.equal(a, b) for a, b in zip(ref_dev.lg + ref_dev.lh, lag.lg + lag.lh)),
              f"from-secret basis by the device ladders equals the trusted basis, lg and lh, "
              f"all {d} points")
        log(f"  Lagrange SRS 2^{EXP_EVAL} from the secret: device route {secret_dev_s:.4f} s, host "
            f"engine {secret_s:.4f} s [{card}]")
        report.update(lagrange_secret_device_s=secret_dev_s)

    # ---- 18. launch counts of the probe, matmul-DFT and 2^20 paths -----------------------------
    with phase("launch counts 15-17"):
        counts_big, modes_big = kernels.launch_counts(), kernels.mode_counts()
        log(f"  {counts_big}")
        log(f"  K2 and K7 by mode: {modes_big}")
        for k in ("mul_chain", "mxu_reduce", "field_elementwise", "field_scan", "fr_horner",
                  "ntt_block", "g1_add", "g1_dbl", "g2_add", "g1_bucket_accumulate",
                  "g1_horner_join"):
            check(counts_big[k] > 0, f"{k} launched {counts_big[k]} times on the probe, "
                  "matmul-DFT, device-setup and 2^20 path")
        check(counts_big["ntt_stage"] == 0,
              "the 2^20 path transforms on ntt_block, no per-stage K5 launch")
        check(modes_big["g1_add"]["wide"] > 0 and modes_big["g1_add"]["narrow"] > 0,
              f"g1_add took both modes on the 2^20 path ({modes_big['g1_add']}: setup's "
              "rounds at 2^20 points wide, the reductions' last levels narrow)")

    # ---- 19. K3 alone at the 2^20 witness's shape, outside the counted run ---------------------
    with phase("K3 at the 2^20 witness shape"):
        n19 = n20 - 1
        c14 = pippenger.effective_window(n19)
        std = FR.from_mont(random_fr_words(torch.Generator(device=dev).manual_seed(SEED + 19),
                                           (n19,), dev))
        inputs = pippenger.bucket_inputs(*(t[..., :n19] for t in big_gs), std, c14)
        rows, order = inputs[:2]
        runs = pippenger.split_runs(inputs[2], inputs[3], n19)
        # the twin walks the top window: its 3-bit digits give the long runs
        top = pippenger.split_runs(inputs[2][-1:], inputs[3][-1:], n19, runs.run_length)
        order_top = order[-1:].contiguous()
        got = cuda_ops.bucket_runs(rows, order_top, top.pos, top.length)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = cuda_ops.bucket_runs_plain(rows, order_top, top.pos, top.length)
        torch.cuda.synchronize()
        top_plain_ms = (time.perf_counter() - t0) * 1e3
        check(max_abs_diff(got, want) == 0,
              f"K3 on the top window's {top.pos.numel()} sub-runs at 2^20 - 1, c = {c14} equals "
              "plain")
        k3_20_ms = cuda_ms(lambda: cuda_ops.bucket_runs(rows, order, runs.pos, runs.length), 5)
        route_20_ms = cuda_ms(lambda: cuda_ops.bucket_accumulate(*inputs), 5)
        b20 = runs_bound(0, rows, order, runs, 3 * 12 * runs.pos.numel())
        log(f"  K3 2^20 - 1, c = {c14}: buckets {tuple(inputs[2].shape)}, fullest bucket "
            f"{int(inputs[3].max())}; L {runs.run_length}, {runs.pos.numel()} sub-runs, longest "
            f"{runs.longest}, most sub-runs of a bucket {runs.max_split}; kernel {k3_20_ms:.4f} ms, "
            f"route (split + K3 + combine) {route_20_ms:.4f} ms, bound {b20[0]:.6f} ms "
            f"({b20[1]}); the twin on the top window {top_plain_ms:.2f} ms [{card}]")
        report.update(k3_witness_2e20_ms=k3_20_ms, k3_route_witness_2e20_ms=route_20_ms,
                      k3_witness_2e20_bound_ms=b20[0])
        del big_gs, inputs, rows, order, got, want

    # ---- 20-21. the trusted Lagrange SRS at 2^15, counted ------------------------------------
    kernels.reset_launches()

    with phase(f"trusted Lagrange SRS 2^{EXP_LAGRANGE}"):
        dom15 = Domain(EXP_LAGRANGE)
        lag15 = {}
        for curve, src in ((G1, params.gs), (G2, params.hs)):
            torch.cuda.synchronize()
            before = kernels.launch_counts()
            t0 = time.perf_counter()
            lag15[curve.name] = curve.to_affine(
                eval_form._group_intt(curve, tuple(t[..., :dom15.d] for t in src), dom15))
            torch.cuda.synchronize()
            report[f"lagrange_2e{EXP_LAGRANGE}_{curve.name.lower()}_s"] = time.perf_counter() - t0
            check_group_launches(curve.name.lower(), before, EXP_LAGRANGE)
        counts_lag, modes_lag = kernels.launch_counts(), kernels.mode_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref15 = compute_lagrange_basis_from_secret(SEED, EXP_LAGRANGE, device=dev)
        torch.cuda.synchronize()
        secret15_s = time.perf_counter() - t0
        check(all(torch.equal(a, b) for a, b in zip(lag15["G1"], ref15.lg)),
              f"trusted Lagrange G1 basis 2^{EXP_LAGRANGE} equals the from-secret basis "
              f"(device route), all {dom15.d} points")
        check(all(torch.equal(a, b) for a, b in zip(lag15["G2"], ref15.lh)),
              f"trusted Lagrange G2 basis 2^{EXP_LAGRANGE} equals the from-secret basis "
              f"(device route), all {dom15.d} points")
        report[f"lagrange_secret_device_2e{EXP_LAGRANGE}_s"] = secret15_s
        log(f"  Lagrange SRS 2^{EXP_LAGRANGE} by the group iNTT: G1 "
            f"{report[f'lagrange_2e{EXP_LAGRANGE}_g1_s']:.4f} s, G2 "
            f"{report[f'lagrange_2e{EXP_LAGRANGE}_g2_s']:.4f} s; from the secret by the device "
            f"route {secret15_s:.4f} s [{card}]")
        del lag15, ref15

    with phase(f"launch counts 20"):
        log(f"  {counts_lag}")
        log(f"  K2 and K7 by mode: {modes_lag}")
        for k in ("g1_ladder", "g2_ladder", "field_pow", "field_elementwise", "field_scan",
                  "g1_add", "g2_add"):
            check(counts_lag[k] > 0, f"{k} launched {counts_lag[k]} times on the trusted "
                  f"Lagrange SRS at 2^{EXP_LAGRANGE}")
        check(counts_lag["ntt_stage"] == 0, "no per-stage K5 launch on the Lagrange SRS")

    # ---- 22. ntt_block at every shape the paths launched it, against its twin ------------------
    cuda_field.ntt_block = launch_block

    def replay_blocks(calls, gen_r, path):
        """Each recorded ntt_block shape on random words (0, 1 and r - 1
        planted) against its twin word for word, timed with its bound: the
        report's rows, smallest first."""
        edges = torch.from_numpy(FR.encode([0, 1, R - 1])).to(dev)
        rows = []
        for (shape, out_bt, direction, *kinds), (tw, pre, post) in sorted(
                calls.items(), key=lambda kv: (kv[0][0][1] * kv[0][0][2] * kv[0][0][3],
                                               str(kv[0]))):
            x = random_fr_words(gen_r, shape[1:], dev)
            x.view(FR.W, -1)[:, :3] = edges
            args_b = (x, tw, pre, post, out_bt)
            want, plain_ms = once_ms(lambda: cuda_field.ntt_block_plain(*args_b))
            err = max_abs_diff(launch_block(*args_b), want)
            check(err == 0, f"ntt_block {shape} out_bt {out_bt} {direction} scales {kinds} "
                            f"({path}) equals its twin")
            b = block_bound(shape, out_bt, pre, post)
            products = block_products(shape, pre, post)
            rows.append({"shape": list(shape), "out_bt": out_bt, "direction": direction,
                         "path": path, "products": products,
                         "throughput_ms": products / report["fr_mul_per_s"] * 1e3,
                         "pre": kinds[0] and kinds[0][0], "post": kinds[1] and kinds[1][0],
                         "ms": peaks.held_ms(lambda: launch_block(*args_b), 5),
                         "plain_ms": plain_ms, "bound_ms": b[0], "bound_by": b[1],
                         "max_abs_err": err})
            log(f"  ntt_block {shape} out_bt {out_bt} {direction} scales {kinds}: "
                f"{rows[-1]['ms']:.4f} ms, twin {plain_ms:.2f} ms, bound {b[0]:.6f} ms ({b[1]}), "
                f"{products} products, {rows[-1]['throughput_ms']:.4f} ms at the measured Fr "
                f"rate [{card}]")
            del x, want
        return rows

    with phase("ntt_block at the paths' shapes"):
        shapes = replay_blocks(block_calls, torch.Generator(device=dev).manual_seed(SEED + 41),
                               "phases 3-21")
        # the report's row: the 2^20 transform's first pass (the largest
        # launch with the twiddle after it)
        ref = max((r for r in shapes if r["post"] == "product"), default=shapes[-1],
                  key=lambda r: r["shape"][1] * r["shape"][2] * r["shape"][3])
        kinfo["ntt_block"].update(
            max_abs_err=max([kinfo["ntt_block"]["max_abs_err"]] + [r["max_abs_err"] for r in shapes]),
            ms=ref["ms"], plain_ms=ref["plain_ms"], bound=(ref["bound_ms"], ref["bound_by"]),
            shapes=shapes)

    # ---- 23. setup -> commit -> witness -> verify at 2^24, counted ---------------------------
    kernels.reset_launches()
    # the K3, K4 and fr_horner calls of the default commit and witness,
    # recorded by shape (fr_horner: the first and the latest call of a
    # shape, so a carry of 0 and a carry from the chunk above) and replayed
    # against their twins after the count
    big_calls = {"g1_bucket_accumulate": {}, "g1_horner_join": {}, "fr_horner": {}}
    launch_runs, launch_join, launch_horner = (cuda_ops.bucket_runs, cuda_ops.horner_join,
                                               poly_mod.fr_horner)

    def record_runs(rows, order, pos, length):
        big_calls["g1_bucket_accumulate"].setdefault(
            (tuple(order.shape), pos.numel()), (rows, order, pos, length))
        return launch_runs(rows, order, pos, length)

    def record_join(s_all, c):
        big_calls["g1_horner_join"].setdefault((tuple(s_all[0].shape), c), (s_all, c))
        return launch_join(s_all, c)

    def horner_recorder(calls):
        """fr_horner, recording into `calls` the first and the latest call
        of each shape (a later call on the first call's own tensors, which
        the record keeps alive, is not recorded again)."""
        def record(f, x, carry=None, rem_only=False):
            seen = calls.setdefault((tuple(f.shape), x.shape[-1], carry is not None, rem_only), [])
            if not seen or any(
                    (a is None) != (b is None) or (a is not None and a.data_ptr() != b.data_ptr())
                    for a, b in zip(seen[0], (f, x, carry))):
                seen[min(len(seen), 1):] = [(f, x, carry, rem_only)]
            return launch_horner(f, x, carry, rem_only)
        return record

    def replay_horner(calls, describe):
        """Each recorded fr_horner call against its twin word for word,
        timed with its bound, into fr_horner's `shapes` under
        describe(n, k, rem_only, which, carry)."""
        for (fshape, k, has_carry, _), seen in sorted(calls.items()):
            n = fshape[-1]
            for which, (f, x, carry, rem_only) in zip(("first", "latest"), seen):
                got = launch_horner(f, x, carry, rem_only)
                # the twin's remainder alone is the reference's chunked power
                # method, a host loop over n / 4096 chunks (63-100 s at 2^24):
                # above 2^20 coefficients the remainder is held against the
                # twin's division, whose remainder is the same field element
                twin_rem_only = rem_only and n <= 1 << 20
                want, plain_ms = once_ms(
                    lambda: horner_mod.fr_horner_plain(f, x, carry, twin_rem_only))
                err = max(max_abs_diff(g, w) for g, w in zip(got, want) if g is not None)
                what = describe(n, k, rem_only, which, carry)
                check(err == 0, f"fr_horner {what} equals its twin"
                      + ("" if twin_rem_only == rem_only else "'s remainder in division mode"))
                b = bound(32 * (n + (0 if rem_only else k * (n - 1)) + 2 * k),
                          k * n * (FR_MUL_MADS + 16))
                kinfo["fr_horner"]["shapes"][what] = {
                    "ms": cuda_ms(lambda: launch_horner(f, x, carry, rem_only), 5),
                    "plain_ms": plain_ms, "bound_ms": b[0], "bound_by": b[1],
                    "max_abs_err": err,
                    "twin": "remainder only" if twin_rem_only else "division"}
                kinfo["fr_horner"]["max_abs_err"] = max(kinfo["fr_horner"]["max_abs_err"], err)
                log(f"  fr_horner {what}: kernel {kinfo['fr_horner']['shapes'][what]['ms']:.4f} "
                    f"ms, twin {plain_ms:.2f} ms, bound {b[0]:.6f} ms ({b[1]}) [{card}]")
                del got, want

    with phase(f"main path 2^{EXP_BIG}"):
        n24 = 1 << EXP_BIG
        cfg0 = get_config()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        big24 = setup_device(SEED, n24, g2_count=2, device=dev)
        torch.cuda.synchronize()
        setup24_s = time.perf_counter() - t0
        check(big24.gs[0].shape[-1] == n24 and big24.hs[0].shape[-1] == 2,
              f"setup_device(s, 2^{EXP_BIG}, g2_count=2): 2^{EXP_BIG} G1 powers, 2 G2 powers")
        spots24 = [0, 1, n24 // 2, n24 - 1]
        check(g1_from_device(tuple(t[..., spots24] for t in big24.gs))
              == [native.g1_mul(g1_generator(), pow(SEED, i, R)) for i in spots24],
              f"powers 0, 1, 2^{EXP_BIG - 1} and 2^{EXP_BIG} - 1 equal native.g1_mul(g, s^i)")
        gen24 = torch.Generator(device=dev).manual_seed(SEED + 24)
        poly24 = Polynomial(random_fr_words(gen24, (n24,), dev))
        x24 = rng.randrange(R)
        # f(s) and y = f(x) on the host, one pass of Horner over Python ints
        t0 = time.perf_counter()
        coeffs = poly24.to_ints()
        to_ints_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        fs = y24 = 0
        for k in reversed(coeffs):
            fs = (fs * SEED + k) % R
            y24 = (y24 * x24 + k) % R
        host_horner_s = time.perf_counter() - t0
        del coeffs
        prover24 = KZGProver(big24)
        cuda_ops.bucket_runs, cuda_ops.horner_join = record_runs, record_join
        poly_mod.fr_horner = horner_recorder(big_calls["fr_horner"])
        c24, commit24_s, ctimes = median3(lambda: prover24.commit(poly24))
        w24, witness24_s, wtimes = median3(
            lambda: prover24.create_witness(poly24, (x24, y24), check=False))
        cuda_ops.bucket_runs, cuda_ops.horner_join = launch_runs, launch_join
        poly_mod.fr_horner = launch_horner
        check(g1_from_device(tuple(t[..., None] for t in c24))[0]
              == native.g1_mul(g1_generator(), fs), f"2^{EXP_BIG} commitment equals f(s) G")
        configure(**STREAM_CHUNKS)
        streamed = prover24.create_witness(poly24, (x24, y24), check=False)
        configure(msm_chunk_log=EXP_BIG, div_chunk_log=EXP_BIG)
        one_shot = prover24.create_witness(poly24, (x24, y24), check=False)
        set_config(cfg0)
        check(bool(G1.eq(streamed, one_shot)) and bool(G1.eq(w24, one_shot)),
              f"the 2^{EXP_BIG} witness streamed in chunks of "
              f"2^{min(STREAM_CHUNKS.values())} ({STREAM_CHUNKS}) equals the one-shot witness "
              f"(both chunk logs {EXP_BIG}) and the default one (msm_chunk_log "
              f"{cfg0.msm_chunk_log}, div_chunk_log {cfg0.div_chunk_log})")
        del streamed, one_shot
        verify24 = {}
        for engine in ("host", "device"):
            v24 = KZGVerifier(big24, engine=engine)
            ok, verify24[engine], vtimes = median3(
                lambda: v24.verify_eval((x24, y24), c24, w24))
            check(ok, f"2^{EXP_BIG} verify_eval accepts on the {engine} engine")
            check(not v24.verify_eval((x24, (y24 + 1) % R), c24, w24),
                  f"2^{EXP_BIG} verify_eval rejects a tampered y on the {engine} engine")
        log(f"  2^{EXP_BIG}: setup_device {setup24_s:.4f} s; commit {commit24_s:.4f} s (runs "
            f"{', '.join(f'{t:.4f}' for t in ctimes)}), {n24 / commit24_s:.0f} points/s; witness "
            f"{witness24_s:.4f} s (runs {', '.join(f'{t:.4f}' for t in wtimes)}); verify host "
            f"{verify24['host']:.4f} s, device {verify24['device']:.4f} s; host to_ints "
            f"{to_ints_s:.2f} s, Horner at two points {host_horner_s:.2f} s [{card}]")
        report.update(setup_device_2e24_s=setup24_s, commit_2e24_s=commit24_s,
                      points_per_s_2e24=n24 / commit24_s, witness_2e24_s=witness24_s,
                      verify_2e24_host_s=verify24["host"],
                      verify_2e24_device_s=verify24["device"])
        counts_big24, modes_big24 = kernels.launch_counts(), kernels.mode_counts()

    # K3, K4 and fr_horner as the default 2^24 commit and witness launched
    # them, each against its twin word for word (launches not counted)
    with phase(f"K3, K4 and fr_horner at the 2^{EXP_BIG} shapes"):
        gen_s = torch.Generator(device=dev).manual_seed(SEED + 23)
        for (oshape, m), (rows, order, pos, length) in sorted(
                big_calls["g1_bucket_accumulate"].items()):
            windows, n = oshape
            got = launch_runs(rows, order, pos, length)
            # the twin on a sample of the sub-runs (it advances all its lanes
            # one point a step, a chain of launches whatever the width): each
            # window's first and last sub-run by position, the longest, and
            # 2,048 drawn from all of them
            pos64 = pos.to(torch.int64)
            win = pos64 // n
            ends = [i for w in range(windows) for i in (
                torch.where(win == w, pos64, 1 << 62).argmin(),
                torch.where(win == w, pos64, -1).argmax())]
            idx = torch.unique(torch.cat([
                torch.stack(ends), torch.zeros(1, dtype=torch.int64, device=dev),
                torch.randint(0, m, (2048,), generator=gen_s, device=dev)]))
            want, plain_ms = once_ms(lambda: cuda_ops.bucket_runs_plain(
                rows, order, pos[idx], length[idx]))
            err = max_abs_diff(tuple(t[..., idx] for t in got), want)
            last = int((pos64[idx] + length[idx]).max()) - 1
            check(err == 0, f"K3 at the 2^{EXP_BIG} MSM's shape (order {oshape}, {m} sub-runs): "
                  f"{idx.numel()} sub-runs, every window's first and last (positions up to "
                  f"{last}), equal their twin")
            b = runs_bound(0, rows, order, types.SimpleNamespace(pos=pos, length=length),
                           3 * 12 * m)
            row = {"shape": [windows, n], "sub_runs": m, "longest": int(length.max()),
                   "checked": idx.numel(), "last_position": last,
                   "ms": cuda_ms(lambda: launch_runs(rows, order, pos, length), 3),
                   "plain_ms_sample": plain_ms, "bound_ms": b[0], "bound_by": b[1],
                   "max_abs_err": err}
            kinfo["g1_bucket_accumulate"].setdefault("shapes", []).append(row)
            kinfo["g1_bucket_accumulate"]["max_abs_err"] = max(
                kinfo["g1_bucket_accumulate"]["max_abs_err"], err)
            log(f"  K3 W = {windows}, n = {n}: {m} sub-runs, longest {row['longest']}; kernel "
                f"{row['ms']:.4f} ms, bound {b[0]:.6f} ms ({b[1]}); the twin on {idx.numel()} "
                f"sub-runs {plain_ms:.2f} ms [{card}]")
            del got, want
        for (sshape, _), (s_all, c) in sorted(big_calls["g1_horner_join"].items()):
            want, plain_ms = once_ms(lambda: cuda_ops.horner_join_plain(s_all, c))
            err = max_abs_diff(launch_join(s_all, c), want)
            check(err == 0, f"K4 at the 2^{EXP_BIG} MSM's shape (W = {sshape[-1]}, c = {c}) "
                  "equals its twin")
            b = horner_bound(0, sshape[-1], c)
            row = {"windows": sshape[-1], "c": c, "ms": cuda_ms(lambda: launch_join(s_all, c), 5),
                   "plain_ms": plain_ms, "bound_ms": b[0], "bound_by": b[1], "max_abs_err": err}
            kinfo["g1_horner_join"].setdefault("shapes", []).append(row)
            kinfo["g1_horner_join"]["max_abs_err"] = max(kinfo["g1_horner_join"]["max_abs_err"],
                                                          err)
            log(f"  K4 W = {sshape[-1]}, c = {c}: kernel {row['ms']:.4f} ms, twin "
                f"{plain_ms:.2f} ms, bound {b[0]:.6f} ms ({b[1]}) [{card}]")
        replay_horner(big_calls["fr_horner"], lambda n, k, rem_only, which, carry: (
            f"division 2^{EXP_BIG}, {which} chunk of {n} (carry "
            f"{'none' if carry is None else '0' if not bool(carry.any()) else 'in'})"))
        check(all(big_calls.values()), f"the default 2^{EXP_BIG} commit and witness launched "
              f"K3, K4 and fr_horner ({ {k: len(v) for k, v in big_calls.items()} } shapes)")
        del big_calls, rows, order, pos, length, pos64, win, idx, s_all

    # the chunk settings at 2^24, not counted: setup, commit and witness
    # seconds (median of 3) and peak device memory (setup: above what was
    # allocated before it, the SRS it returns included; commit and
    # witness: above the resident SRS and f)
    with phase(f"chunk settings at 2^{EXP_BIG}"):
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        sweep, setup_sweep = [], []

        def peak_mib(fn, base):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            fn()
            torch.cuda.synchronize()
            return (torch.cuda.max_memory_allocated() - base) / 2**20

        for msm_log in CHUNK_SWEEP["msm_chunk_log"]:
            configure(msm_chunk_log=msm_log)

            def setup24():
                return setup_device(SEED, n24, g2_count=2, device=dev)

            srs, s_s, s_t = median3(setup24)
            check(all(torch.equal(a, b) for a, b in zip(srs.gs + srs.hs, big24.gs + big24.hs)),
                  f"setup_device at msm_chunk_log {msm_log} equals the default's SRS")
            del srs
            s_peak = peak_mib(setup24, resident)
            setup_sweep.append({"msm_chunk_log": msm_log, "setup_s": s_s, "setup_runs": s_t,
                                "setup_peak_mib": s_peak})
            log(f"  setup_device 2^{EXP_BIG} at msm_chunk_log {msm_log}: {s_s:.4f} s (runs "
                f"{', '.join(f'{t:.4f}' for t in s_t)}), peak {s_peak:.1f} MiB above the "
                f"{resident / 2**20:.1f} MiB allocated before it [{card}]")
            _, c_s, c_t = median3(lambda: prover24.commit(poly24))
            c_peak = peak_mib(lambda: prover24.commit(poly24), resident)
            for div_log in CHUNK_SWEEP["div_chunk_log"]:
                configure(div_chunk_log=div_log)

                def witness24():
                    return prover24.create_witness(poly24, (x24, y24), check=False)

                _, w_s, w_t = median3(witness24)
                w_peak = peak_mib(witness24, resident)
                sweep.append({"msm_chunk_log": msm_log, "div_chunk_log": div_log,
                              "commit_s": c_s, "commit_runs": c_t,
                              "points_per_s": n24 / c_s, "commit_peak_mib": c_peak,
                              "witness_s": w_s, "witness_runs": w_t, "witness_peak_mib": w_peak})
                log(f"  chunks msm 2^{msm_log}, div 2^{div_log}: commit {c_s:.4f} s (runs "
                    f"{', '.join(f'{t:.4f}' for t in c_t)}), {n24 / c_s:.0f} points/s, peak "
                    f"{c_peak:.1f} MiB; witness {w_s:.4f} s (runs "
                    f"{', '.join(f'{t:.4f}' for t in w_t)}), peak {w_peak:.1f} MiB above the "
                    f"resident {resident / 2**20:.1f} MiB [{card}]")
            set_config(cfg0)
        report.update(chunk_sweep_2e24=sweep, setup_sweep_2e24=setup_sweep,
                      resident_2e24_mib=resident / 2**20)

    # ---- 23b. the pairing kernels against their plain versions and the oracle, not counted ----
    with phase("pairing kernels vs plain"):
        from kzg_tpu_torch.oracle.curve import final_exponentiation
        from kzg_tpu_torch.oracle.curve import miller_loop as oracle_miller
        from kzg_tpu_torch.oracle.field import Fp12

        mk, fk = pair_schedule.miller_kernel(), pair_schedule.final_kernel()
        cols = pair_schedule.hard_columns()

        def crit(k, name):
            return pair_schedule.critical_products(k.programs[name])

        def prods(k, name):
            return pair_schedule.products(k.programs[name])

        bits = pair_schedule.LOOP_BITS
        # one lane's products and critical path: the Miller loop; the final
        # exponentiation after its product (easy part, table, the ladder)
        m_prod = (prods(mk, "init") + len(bits) * prods(mk, "tangent")
                  + sum(bits) * prods(mk, "chord"))
        m_crit = (crit(mk, "init") + len(bits) * crit(mk, "tangent")
                  + sum(bits) * crit(mk, "chord") + crit(mk, "conj"))
        ladder = [("cyc_mul" if c else "cyc") for c in cols[1:]]
        e_prod = prods(fk, "easy") + prods(fk, "table") + sum(prods(fk, g) for g in ladder)
        e_crit = crit(fk, "easy") + crit(fk, "table") + sum(crit(fk, g) for g in ladder)
        lat_ms = latency_us[("Fp", True)] * 1e-3
        for kname in ("miller_loop", "final_exp"):
            kinfo[kname].update(max_abs_err=0, shapes={})
        for n_pair, inf_lane in ((1, None), (1, 0), (2, 1), (5, 3)):
            ps = [native.g1_mul(g1_generator(), rng.randrange(1, R)) for _ in range(n_pair)]
            qs = [native.g2_mul(g2_generator(), rng.randrange(1, R)) for _ in range(n_pair)]
            if inf_lane is not None:  # P at infinity in odd widths, Q in even ones
                (ps if n_pair % 2 else qs)[inf_lane] = None
            xp, yp, zp = g1_to_device(ps, dev)
            xq, yq, zq = g2_to_device(qs, dev)
            skip = (zp == 0).all(dim=0) | (zq == 0).all(dim=0).all(dim=0)
            live = n_pair - int(skip.sum())
            what = f"{n_pair} lanes" + ("" if inf_lane is None else f", lane {inf_lane} infinite")
            f = pairing_mod.miller_loop_device((xp, yp), (xq, yq), skip)
            want, m_plain_ms = once_ms(lambda: tower.f12_select(
                ~skip, pairing_mod.miller_loop_plain((xp, yp), (xq, yq)),
                tower.f12_one((n_pair,), dev)))
            m_err = max_abs_diff(f, want)
            check(m_err == 0, f"miller_loop at {what} equals its plain version")
            millers = [Fp12.one() if p is None or q is None else oracle_miller(p, q)
                       for p, q in zip(ps, qs)]
            # the projective loop's value is the oracle's times an Fp2 factor
            check(all((tower.f12_to_oracle(f[..., i]) * m.inv()).c1.is_zero()
                      for i, m in enumerate(millers)),
                  f"miller_loop at {what} over the oracle's Miller loop lies in Fp6")
            lanes = pairing_mod.final_exp_device(f)
            want, l_plain_ms = once_ms(lambda: pairing_mod.final_exp_plain(f))
            l_err = max_abs_diff(lanes, want)
            check(l_err == 0, f"final_exp (lane mode) at {what} equals its plain version")
            check([tower.f12_to_oracle(lanes[..., i]) for i in range(n_pair)]
                  == [final_exponentiation(m) for m in millers],
                  f"final_exp (lane mode) at {what} equals the oracle's")
            prod = pairing_mod.final_exp_product(f, skip)
            want, p_plain_ms = once_ms(lambda: pairing_mod.final_exp_plain(
                pairing_mod._product_plain(f, skip)))
            p_err = max_abs_diff(prod, want)
            check(p_err == 0, f"final_exp (product mode) at {what} equals its plain version")
            whole = Fp12.one()
            for m in millers:
                whole = whole * m
            check(tower.f12_to_oracle(prod) == final_exponentiation(whole),
                  f"final_exp (product mode) at {what} equals the oracle's")
            f12_bytes = 4 * FP.W * 12
            rows = {
                ("miller_loop", "lane"): (
                    lambda: pairing_mod.miller_loop_device((xp, yp), (xq, yq), skip), m_plain_ms,
                    m_err, bound(n_pair * (4 * FP.W * 6 + 1 + f12_bytes),
                                 live * m_prod * FP_MUL_MADS), m_crit),
                ("final_exp", "lane"): (
                    lambda: pairing_mod.final_exp_device(f), l_plain_ms, l_err,
                    bound(2 * n_pair * f12_bytes, n_pair * e_prod * FP_MUL_MADS), e_crit),
                ("final_exp", "product"): (
                    lambda: pairing_mod.final_exp_product(f, skip), p_plain_ms, p_err,
                    bound((n_pair + 1) * f12_bytes + n_pair,
                          (max(live - 1, 0) * prods(fk, "mul") + e_prod) * FP_MUL_MADS),
                    max(live - 1, 0) * crit(fk, "mul") + e_crit),
            }
            for (kname, mode), (fn, plain_ms, err, b, chain) in rows.items():
                ms = cuda_ms(fn, 3)
                key = what if kname == "miller_loop" else f"{mode} mode, {what}"
                kinfo[kname]["shapes"][key] = {
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": b[0], "bound_by": b[1],
                    "chain_ms": chain * lat_ms, "max_abs_err": err}
                kinfo[kname]["max_abs_err"] = max(kinfo[kname]["max_abs_err"], err)
                log(f"  {kname} {key}: kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, chain "
                    f"{chain * lat_ms:.4f} ms ({chain} dependent 16-lane products), bound "
                    f"{b[0]:.6f} ms ({b[1]}) [{card}]")
        # the report's rows: the check's shape, two lanes, product mode
        for kname, key in (("miller_loop", "2 lanes, lane 1 infinite"),
                           ("final_exp", "product mode, 2 lanes, lane 1 infinite")):
            ref = kinfo[kname]["shapes"][key]
            kinfo[kname].update(ms=ref["ms"], plain_ms=ref["plain_ms"], chain_ms=ref["chain_ms"],
                                bound=(ref["bound_ms"], ref["bound_by"]))
        report.update(miller_loop_ms=kinfo["miller_loop"]["ms"],
                      final_exp_ms=kinfo["final_exp"]["ms"])

    # ---- 24. the device pairing engine against the host engine, counted ------------------------
    kernels.reset_launches()

    with phase("device pairing"):
        # pairing_device on two random pairs against the oracle's pairing
        ps = [native.g1_mul(g1_generator(), rng.randrange(1, R)) for _ in range(2)]
        qs = [native.g2_mul(g2_generator(), rng.randrange(1, R)) for _ in range(2)]
        gt, pairing_s, _ = median3(lambda: pairing_device(g1_to_device(ps, dev)[:2],
                                                          g2_to_device(qs, dev)[:2]))
        check([tower.f12_to_oracle(gt[..., i]) for i in range(2)]
              == [oracle_pairing(p, q) for p, q in zip(ps, qs)],
              "pairing_device on two random pairs equals the oracle's pairing")
        log(f"  pairing_device, two pairs in lanes: {pairing_s:.4f} s [{card}]")
        p15, c15, w15, x15, y15 = single15
        bc15, bw15, bxs15 = batched15
        lag12, ec12, ew12, i12, ey12, ebw12, etampered12 = eval12
        other = [(bxs15[0] + 1) % R] + bxs15[1:]
        claims = [
            ("single 2^15", lambda e: KZGVerifier(p15, engine=e),
             lambda v, good: v.verify_eval((x15, y15 if good else (y15 + 1) % R), c15, w15)),
            (f"batched 2^15, k = {K_BATCH}", lambda e: KZGVerifier(p15, engine=e),
             lambda v, good: v.verify_eval_batched(bc15, bw15, bxs15 if good else other)),
            (f"evaluation form 2^{EXP_EVAL}",
             lambda e: KZGVerifierEvalForm(sub_params, lag12, engine=e),
             lambda v, good: v.verify_eval((i12, ey12 if good else (ey12 + 1) % R), ec12, ew12)),
            # the identity witness: both G1 points of a true claim are at
            # infinity, so no lane of the pairing product is finite
            (f"evaluation form 2^{EXP_EVAL}, all points",
             lambda e: KZGVerifierEvalForm(sub_params, lag12, engine=e),
             lambda v, good: v.verify_eval_all(ec12, ebw12 if good else KZGBatchWitnessEvalForm(
                 r=etampered12, w=ebw12.w))),
        ]
        pairing_rows = []
        for name, make, claim in claims:
            row = {"proof": name}
            for engine in ("host", "device"):
                v = make(engine)
                before = kernels.launch_counts()
                ok, row[f"{engine}_s"], row[f"{engine}_runs"] = median3(lambda: claim(v, True))
                after = kernels.launch_counts()
                row[f"{engine}_launches"] = {k: (after[k] - before[k]) // 3 for k in after
                                             if after[k] != before[k]}
                bad = claim(v, False)
                row[f"{engine}_verdicts"] = [ok, bad]
            check(row["device_verdicts"] == row["host_verdicts"] == [True, False],
                  f"{name}: the device engine's verdicts {row['device_verdicts']} equal the host "
                  f"engine's {row['host_verdicts']} (true claim, tampered claim)")
            dl = row["device_launches"]
            check(dl.get("miller_loop") == 1 and dl.get("final_exp") == 1,
                  f"{name}: one miller_loop and one final_exp launch a device verify")
            row["device_launches_total"] = sum(dl.values())
            if name.startswith(("single", "evaluation form 2^")) and "all points" not in name:
                check(row["device_launches_total"] <= 100,
                      f"{name}: {row['device_launches_total']} counted launches a device "
                      "verify (at most 100)")
            if name.startswith("batched"):  # h^Z and g^r: 17 and 16 points, the digit ladder
                for engine in ("host", "device"):
                    el = row[f"{engine}_launches"]
                    k2 = sum(el.get(k, 0) for k in ("g1_add", "g1_dbl", "g2_add", "g2_dbl"))
                    check(el.get("g1_ladder", 0) > 0 and el.get("g2_ladder", 0) > 0 and k2 <= 60,
                          f"{name}, {engine} engine: h^Z and g^r on the ladder kernel, {k2} K2 "
                          "launches (at most 60)")
            row["device_busy_ms"], top = device_ms(lambda: claim(v, True))
            row["device_ms_by_kernel"] = dict(top)
            row["device_idle_share"] = max(0.0, 1.0 - row["device_busy_ms"]
                                           / (row["device_s"] * 1e3))
            log(f"  {name}: host {row['host_s']:.4f} s (runs "
                f"{', '.join(f'{t:.4f}' for t in row['host_runs'])}), launches "
                f"{row['host_launches']}; device {row['device_s']:.4f} s (runs "
                f"{', '.join(f'{t:.4f}' for t in row['device_runs'])}), device busy "
                f"{row['device_busy_ms']:.2f} ms, idle share {row['device_idle_share']:.3f}, "
                f"launches {row['device_launches']} [{card}]")
            for k, ms in top:
                log(f"    {ms:10.3f} ms  {k[:100]}")
            pairing_rows.append(row)
        report.update(pairing_device_2_s=pairing_s, device_verify=pairing_rows)
        counts_pair, modes_pair = kernels.launch_counts(), kernels.mode_counts()

    # ---- 25. launch counts of phases 23 and 24 -------------------------------------------------
    with phase("launch counts 23, 24"):
        for what, run, must in (
                (f"the 2^{EXP_BIG} path", counts_big24,
                 ("field_elementwise", "field_pow", "field_scan", "fr_horner", "g1_add", "g1_dbl",
                  "g2_add", "g1_bucket_accumulate", "g1_horner_join", "g1_ladder", "g2_ladder",
                  "miller_loop", "final_exp")),
                ("the device verifies", counts_pair,
                 ("miller_loop", "final_exp", "g1_ladder", "g2_ladder"))):
            log(f"  {what}: {run}")
            for k in must:
                check(run[k] > 0, f"{k} launched {run[k]} times on {what}")
            check(run["ntt_stage"] == 0, f"no per-stage K5 launch on {what}")
        for row in pairing_rows:
            log(f"  {row['proof']}: {row['device_launches_total']} counted launches a device "
                f"verify: {row['device_launches']}")
        log(f"  K2 and K7 by mode: 2^{EXP_BIG} {modes_big24}; device verifies {modes_pair}")
        runs = (counts_single, counts_batched, counts_eval, counts_big, counts_lag, counts_big24,
                counts_pair)
        counts = {k: sum(run[k] for run in runs) for k in counts_eval}
        mode_totals = {k: {m: sum(run[k][m] for run in (modes_single, modes_batched, modes_eval,
                                                         modes_big, modes_lag, modes_big24,
                                                         modes_pair))
                           for m in cuda_ops.MODES} for k in modes_eval}

    # ---- 26. the sharded layer (parallel/) at world 1 on NCCL, counted ------------------------
    # (a) the sharded transforms at 2^20 and (b) the sharded MSMs against the
    # one-device path; (c)-(e) the three steps, counted from a reset just
    # before (c) to just after (e); (f) the other new entry points
    import torch.distributed as dist

    from kzg_tpu_torch import parallel
    from kzg_tpu_torch.bench import harness as hbench_mod, scaling as scaling_mod
    from kzg_tpu_torch.kzg.coeff_form import KZGBatchWitness
    from kzg_tpu_torch.parallel import msm as pmsm, ntt as pntt, pipeline as ppipe
    from kzg_tpu_torch import smoke as smoke_mod

    def affine1(jac):
        return g1_from_device(tuple(t[..., None] for t in jac))[0]

    with phase("sharded"):
        store = os.path.join(ROOT, "build", "dist_store_world1")
        if os.path.exists(store):
            os.remove(store)
        parallel.initialize_distributed(backend="nccl", init_method=f"file://{store}",
                                        world_size=1, rank=0)
        mesh = parallel.make_mesh()
        check(dist.get_backend() == "nccl" and dist.get_world_size() == 1
              and mesh.mesh_dim_names == ("shard",),
              "an NCCL process group of one rank and a 1-D mesh named shard")
        gen26 = torch.Generator(device=dev).manual_seed(SEED + 26)
        # (a) transforms
        sd = parallel.ShardedDomain(mesh, "shard", EXP_COSET)
        dom20 = Domain(EXP_COSET)
        x20 = random_fr_words(gen26, (1 << EXP_COSET,), dev)
        x20[:, :3] = torch.from_numpy(FR.encode([0, 1, R - 1])).to(dev)
        for name in ("ntt", "intt", "coset_ntt", "coset_intt"):
            check(torch.equal(getattr(sd, name)(sd.shard(x20)), getattr(dom20, name)(x20)),
                  f"ShardedDomain(2^{EXP_COSET}).{name} equals Domain(2^{EXP_COSET}).{name} "
                  "word for word")
        tr = sd.ntt_t(sd.shard(x20))
        check(torch.equal(tr, dom20.ntt(x20)) and torch.equal(sd.intt_t(tr), x20),
              f"ntt_t at world 1 is the standard order, and intt_t(ntt_t(x)) == x")
        del sd, x20, tr
        # (b) sharded MSMs
        msm26 = {}
        for curve, pts, n, what in ((G1, big24.gs, 1 << EXP_COSET, "G1 2^20"),
                                    (G2, params.hs, N_POINT, "G2 2^12")):
            pts = tuple(t[..., :n] for t in pts)
            s = random_fr_words(gen26, (n,), dev)
            run = parallel.make_sharded_msm(mesh, "shard", curve)
            got = run(tuple(run.shard(t) for t in pts), run.shard(s))
            conv = g1_from_device if curve is G1 else g2_from_device
            msm26[what] = conv(tuple(t[..., None] for t in got))
            check(msm26[what]
                  == conv(tuple(t[..., None] for t in pippenger.msm(curve, pts, s))),
                  f"sharded MSM {what} equals msm in affine form")
        del pts, s, got
        x24_mont = torch.from_numpy(FR.encode([x24])).to(dev)
        step24 = parallel.make_commit_witness_step(mesh, "shard", EXP_BIG)
        g24 = tuple(step24.shard(t) for t in big24.gs)
        f24 = step24.shard(poly24.coeffs)
        # (d) and (e): their inputs and one-device references, before the count
        exp_b, k_b = 16, 64
        p16 = setup_device(SEED, 1 << exp_b, g2_count=k_b + 1, device=dev)
        poly16 = Polynomial(random_fr_words(gen26, (1 << exp_b,), dev))
        xs16 = [rng.randrange(R) for _ in range(k_b)]
        ys16 = FR.decode(poly16.eval_many(torch.from_numpy(FR.encode(xs16)).to(dev)))
        prover16 = KZGProver(p16)
        # the one-device commit and batched witness, timed beside the step
        (commit16, want16), one16_s, _ = median3(
            lambda: (prover16.commit(poly16), prover16.create_witness_batched(
                poly16, xs16, ys16, check=False)))
        exp_e = 14
        p14 = setup_device(SEED, 1 << exp_e, g2_count=2, device=dev)
        lag14 = compute_lagrange_basis_from_secret(SEED, exp_e, device=dev)
        evals14 = random_fr_words(gen26, (1 << exp_e,), dev)
        eprover14 = KZGProverEvalForm(p14, lag14)
        ms14 = (5, (1 << exp_e) - 3)
        want14, one14_s = {"commit": eprover14.commit(evals14)}, {}
        for m in ms14:
            (_, want14[m]), one14_s[m], _ = median3(
                lambda: (eprover14.commit(evals14), eprover14.create_witness(evals14, m)))
        step16 = parallel.make_batched_witness_step(mesh, "shard", exp_b, k_b)
        steps14 = {m: parallel.make_eval_form_step(mesh, "shard", exp_e, m) for m in ms14}
        torch.cuda.synchronize()

        # (c)-(e), counted; their ntt_block, field_scan and fr_horner calls
        # recorded by shape (ntt_block: its tables, as from phase 3 on;
        # field_scan: the first call of a shape; fr_horner: the first and
        # the latest) and replayed against the twins after the count
        block_calls, scan_calls, horner_calls = {}, {}, {}
        launch_scan = cuda_field.field_scan

        def record_scan(field, op, x, reverse=False, mode="array", n=None):
            scan_calls.setdefault((field.name, op, reverse, mode, tuple(x.shape), n),
                                  (field, op, x, reverse, mode, n))
            return launch_scan(field, op, x, reverse, mode, n)

        cuda_field.ntt_block, cuda_field.field_scan = record_block, record_scan
        poly_mod.fr_horner = horner_recorder(horner_calls)
        kernels.reset_launches()
        out24, step24_s, step24_t = median3(lambda: step24(*g24, f24, x24_mont))
        out16, step16_s, step16_t = median3(lambda: step16(
            *(step16.shard(t) for t in p16.gs), step16.shard(poly16.coeffs),
            torch.from_numpy(FR.encode(xs16)).to(dev)))
        out14, step14_s = {}, {}
        for m, st in steps14.items():
            out14[m], step14_s[m], _ = median3(
                lambda: st(*(st.shard(t) for t in lag14.lg), st.shard(evals14)))
        torch.cuda.synchronize()
        counts_sharded, modes_sharded = kernels.launch_counts(), kernels.mode_counts()
        cuda_field.ntt_block, cuda_field.field_scan = launch_block, launch_scan
        poly_mod.fr_horner = launch_horner

        # (c) the 2^24 commit-witness step against phase 23
        commit, y, wit = out24
        check(affine1(commit) == affine1(c24),
              f"the sharded 2^{EXP_BIG} commitment equals phase 23's commitment (affine)")
        check(FR.decode(y) == [y24], f"the sharded 2^{EXP_BIG} y equals f(x) by Horner")
        check(affine1(wit) == affine1(w24),
              f"the sharded 2^{EXP_BIG} witness equals phase 23's witness (affine; phase 23 "
              "held it to the streamed one)")
        v24 = KZGVerifier(big24, engine="host")
        check(v24.verify_eval((x24, y24), commit, wit)
              and not v24.verify_eval((x24, (y24 + 1) % R), commit, wit),
              f"the host engine accepts the sharded 2^{EXP_BIG} opening and rejects a "
              "tampered y")
        # one more call with its launches, one with CUDA events around its
        # parts (the transforms include their exchanges, the MSMs their
        # all_gather), one for its peak memory
        before = kernels.launch_counts()
        step24(*g24, f24, x24_mont)
        torch.cuda.synchronize()
        after = kernels.launch_counts()
        launches24 = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        spans = {}

        def timed(name, fn):
            def wrap(*a, **kw):
                ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                ev[0].record()
                out = fn(*a, **kw)
                ev[1].record()
                spans.setdefault(name, []).append(ev)
                return out
            return wrap

        patched = [(ppipe, "local_msm_join", "MSMs (with their all_gather)"),
                   (ppipe, "_coset_evals_t", "coset transforms (with their all_to_all)"),
                   (ppipe, "_coset_interp", "coset transforms (with their all_to_all)"),
                   (ppipe, "_eval_many_local", "y = f(x) (Horner, x^(d blk), all_gather)"),
                   (pntt, "exchange", "all_to_all"),
                   (pmsm, "_all_gather", "all_gather")]
        saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in patched]
        for mod, attr, name in patched:
            setattr(mod, attr, timed(name, getattr(mod, attr)))
        FR.batch_inv = timed("batch_inv", FR.batch_inv)
        _, wall = once_ms(lambda: step24(*g24, f24, x24_mont))
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
        del FR.batch_inv
        span_ms = {k: sum(a.elapsed_time(b) for a, b in v) for k, v in spans.items()}
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        step24(*g24, f24, x24_mont)
        torch.cuda.synchronize()
        peak24 = (torch.cuda.max_memory_allocated() - resident) / 2**20
        log(f"  sharded commit-witness step 2^{EXP_BIG}, world 1: {step24_s:.4f} s (runs "
            f"{', '.join(f'{t:.4f}' for t in step24_t)}); phase 23's commit + witness "
            f"{commit24_s + witness24_s:.4f} s; one call's parts (CUDA events, {wall:.1f} ms): "
            + ", ".join(f"{k} {v:.2f} ms" for k, v in span_ms.items())
            + f"; peak {peak24:.1f} MiB above the {resident / 2**20:.1f} MiB allocated before "
            f"it (the resident SRS and f among it) [{card}]")
        log(f"  its launches: {launches24}")
        for k in ("field_elementwise", "field_scan", "field_pow", "fr_horner", "ntt_block",
                  "g1_add", "g1_dbl", "g1_bucket_accumulate", "g1_horner_join"):
            check(launches24.get(k, 0) > 0, f"the 2^{EXP_BIG} step launched {k} "
                  f"{launches24.get(k, 0)} times")
        check(launches24.get("ntt_stage", 0) == 0, "no per-stage K5 launch")
        report.update(sharded_step_2e24_s=step24_s, sharded_step_2e24_runs=step24_t,
                      sharded_step_2e24_parts_ms=span_ms, sharded_step_2e24_peak_mib=peak24,
                      sharded_step_2e24_launches=launches24)
        del out24, commit, wit

        # (d) the batched step against the one-device prover
        commit, ys, r, wit = out16
        check(FR.decode(ys) == ys16 and torch.equal(r, want16.r.trimmed()),
              f"the sharded batched step 2^{exp_b}, k = {k_b}: ys and r equal the one-device "
              "path's")
        check(affine1(wit) == affine1(want16.w) and affine1(commit) == affine1(commit16),
              f"the sharded batched step 2^{exp_b}, k = {k_b}: witness and commitment equal "
              "the one-device prover's (affine)")
        check(KZGVerifier(p16).verify_eval_batched(commit, KZGBatchWitness(
            r=Polynomial(r, k_b - 1), w=wit), xs16),
            f"verify_eval_batched accepts the sharded batched opening at k = {k_b}")
        log(f"  sharded batched step 2^{exp_b}, k = {k_b}, world 1: {step16_s:.4f} s (runs "
            f"{', '.join(f'{t:.4f}' for t in step16_t)}); the one-device commit and "
            f"create_witness_batched (ys given) {one16_s:.4f} s; the evaluation-form step "
            f"2^{exp_e}: "
            + ", ".join(f"index {m} {step14_s[m]:.4f} s (one-device commit and witness "
                        f"{one14_s[m]:.4f} s)" for m in ms14) + f" (medians of 3) [{card}]")
        report.update(sharded_batched_2e16_s=step16_s, batched_2e16_s=one16_s,
                      sharded_eval_2e14_s=step14_s, eval_2e14_s=one14_s)
        # (e) the evaluation-form step against the one-device prover
        everifier14 = KZGVerifierEvalForm(p14, lag14)
        for m, (commit, y, wit) in out14.items():
            check(affine1(commit) == affine1(want14["commit"])
                  and affine1(wit) == affine1(want14[m])
                  and torch.equal(y, evals14[:, m:m + 1])
                  and everifier14.verify_eval((m, FR.decode(y)[0]), commit, wit),
                  f"the sharded evaluation-form step 2^{exp_e} at index {m}: commitment, y "
                  "and witness equal the one-device prover's; verify_eval accepts")
        del out16, out14, p16, poly16, lag14, evals14, p14, prover16, commit16, want16, want14
        dist.destroy_process_group()
        os.remove(store)

        # (f) the other new entry points
        check(smoke_mod.main([]) == 0, "kzg_tpu_torch.smoke.main() returns 0 on the card")
        hjson = os.path.join(ROOT, "build", "harness_16_64.json")
        check(hbench_mod.main(["--sizes", "16,64", "--json", hjson]) == 0,
              "bench.harness --sizes 16,64 returns 0")
        with open(hjson) as f:
            hres = json.load(f)["results"]
        missing = [k for g in hbench_mod.GROUPS for n in (16, 64)
                   for k in hbench_mod.expected_keys(g, n) if k not in hres]
        check(not missing, f"bench.harness wrote every group's keys at 16 and 64 ({len(hres)})")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = scaling_mod.main(["--devices", "1", "--timeout", "300"])
        sweep = json.loads(buf.getvalue().strip().splitlines()[-1])
        check(rc == 0 and [r["devices"] for r in sweep["sweep"]] == [1],
              f"bench.scaling --devices 1 ran one card: {sweep['sweep']}")
        report.update(harness_16_64=hres, scaling_1=sweep["sweep"])

        # more than one card: (b) and (c) on a world of every card (the
        # largest power of two), one NCCL process a card, equal to world 1
        cards = torch.cuda.device_count()
        world = 1 << (cards.bit_length() - 1)
        if world < 2:
            log(f"  not run: the sharded MSMs and the 2^{EXP_BIG} step across cards need at "
                f"least two cards; this machine has {cards}")
        else:
            del g24, f24
            wdir = os.path.join(ROOT, "build", f"sharded_world{world}")
            os.makedirs(wdir, exist_ok=True)
            for fn in os.listdir(wdir):
                os.remove(os.path.join(wdir, fn))
            from kzg_tpu_torch.parallel.runtime import launch
            launch([sys.executable, os.path.abspath(__file__), "--sharded-rank", wdir,
                    "--x", str(x24)], world, 600)
            res = dict(torch.load(os.path.join(wdir, "rank0.pt")))
            check(g1_from_device(tuple(t[..., None] for t in res["G1 2^20"])) == msm26["G1 2^20"]
                  and g2_from_device(tuple(t[..., None] for t in res["G2 2^12"]))
                  == msm26["G2 2^12"],
                  f"the sharded G1 2^20 and G2 2^12 MSMs on {world} cards equal world 1's")
            check(affine1(res["commit"]) == affine1(c24) and FR.decode(res["y"]) == [y24]
                  and affine1(res["wit"]) == affine1(w24),
                  f"the 2^{EXP_BIG} step on {world} cards equals world 1 ({res['seconds']:.4f} "
                  "s a call)")
            log(f"  {world} cards: the 2^{EXP_BIG} step {res['seconds']:.4f} s a call (median "
                f"of 3) against world 1's {step24_s:.4f} s [{card}]")
        del big24, prover24, poly24, c24, w24

    # ---- 27. ntt_block, field_scan and fr_horner at the shapes of phase 26's steps -----------
    # each call recorded in the counted window, against its twin word for
    # word (launches not counted)
    with phase("ntt_block, field_scan and fr_horner at the sharded steps' shapes"):
        rows = replay_blocks(block_calls, torch.Generator(device=dev).manual_seed(SEED + 27),
                             "sharded steps")
        kinfo["ntt_block"]["shapes"] += rows
        kinfo["ntt_block"]["max_abs_err"] = max(
            [kinfo["ntt_block"]["max_abs_err"]] + [r["max_abs_err"] for r in rows])
        op_names = {cuda_field.ADD: "add", cuda_field.MUL: "mul"}
        for F, op, x, reverse, mode, n in scan_calls.values():
            got = launch_scan(F, op, x, reverse, mode, n)
            want, plain_ms = once_ms(
                lambda: cuda_field.field_scan_plain(F, op, x, reverse, mode, n))
            err = max_abs_diff(got, want)
            rows_n = x[0].numel() if mode == "column" else x[0].numel() // x.shape[-1]
            length = n if mode == "column" else x.shape[-1]
            what = (f"{F.name} {op_names[op]} {mode}{' reverse' if reverse else ''}, {rows_n} x "
                    f"{length} (sharded steps)")
            check(err == 0, f"field_scan {what} equals its twin")
            b = scan_bound(F, op == cuda_field.MUL, mode, rows_n, length)
            kinfo["field_scan"]["shapes"][what] = {
                "ms": cuda_ms(lambda: launch_scan(F, op, x, reverse, mode, n), 5),
                "plain_ms": plain_ms, "bound_ms": b[0], "bound_by": b[1], "max_abs_err": err}
            kinfo["field_scan"]["max_abs_err"] = max(kinfo["field_scan"]["max_abs_err"], err)
            log(f"  field_scan {what}: kernel {kinfo['field_scan']['shapes'][what]['ms']:.4f} ms, "
                f"twin {plain_ms:.2f} ms, bound {b[0]:.6f} ms ({b[1]}) [{card}]")
            del got, want
        replay_horner(horner_calls, lambda n, k, rem_only, which, carry: (
            f"{'evaluation' if rem_only else 'division'} of {n} coefficients at {k} point"
            f"{'s' * (k > 1)}, {which} call (sharded steps)"))
        check(block_calls and scan_calls and horner_calls,
              f"the sharded steps' ntt_block, field_scan and fr_horner calls were recorded "
              f"({len(block_calls)}, {len(scan_calls)} and {len(horner_calls)} shapes) and each "
              "equals its twin")
        del block_calls, scan_calls, horner_calls, rows, x

    counts = {k: counts[k] + counts_sharded[k] for k in counts}
    mode_totals = {k: {m: mode_totals[k][m] + modes_sharded[k][m] for m in cuda_ops.MODES}
                   for k in mode_totals}
    with phase("launch counts 26"):
        log(f"  the sharded steps: {counts_sharded}")
        for k in ("field_elementwise", "field_pow", "field_scan", "fr_horner", "ntt_block",
                  "g1_add", "g1_dbl", "g1_bucket_accumulate", "g1_horner_join", "g1_madd_multi"):
            check(counts_sharded[k] > 0, f"{k} launched {counts_sharded[k]} times on the "
                  "sharded steps")
        check(counts_sharded["ntt_stage"] == 0, "no per-stage K5 launch on the sharded steps")
        log(f"  K2 and K7 by mode: {modes_sharded}")

    if args.profile:
        with phase(f"profile of the evaluation-form path 2^{EXP_EVAL} and the batched verify"):
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
                (f"verify_eval_batched 2^15, k = {K_BATCH}", batched_verify),
                ("create_witness 2^15 (coefficient form)",
                 lambda: witness15[0].create_witness(witness15[1], witness15[2:])),
                ("create_witness 2^20 (coefficient form, check=False)",
                 lambda: witness20[0].create_witness(witness20[1], witness20[2:], check=False)),
            ], card, args.profile)

    # K4's critical path in dependent products at the timed shape (26
    # windows of c = 10) times one 16-lane Fp product's latency
    for kname, ncomp in (("g1_horner_join", 1), ("g2_horner_join", 2)):
        prog = horner_schedule.expand(ncomp)
        products = (26 * C_MAIN * horner_schedule.critical_products(prog, "dbl")
                    + 26 * horner_schedule.critical_products(prog, "add"))
        kinfo[kname]["chain_ms"] = products * latency_us[("Fp", True)] * 1e-3
        log(f"  {kname}: critical path {products} dependent products at W = 26, c = {C_MAIN}, "
            f"chain {kinfo[kname]['chain_ms']:.4f} ms against the kernel's "
            f"{kinfo[kname]['ms']:.4f} ms [{card}]")
    # the ladder: a lane's critical path, W (c dbl + 1 madd) at the timed
    # shape, times one 16-lane Fp product's latency (the latency bound), and
    # all the lanes' Fp products at the rate phase 15 measured (the
    # throughput bound); field_pow: its chain of products at that latency
    for kname, ncomp in (("g1_ladder", 1), ("g2_ladder", 2)):
        prog = horner_schedule.expand(ncomp)
        products = w_lad * (c_lad * horner_schedule.critical_products(prog, "dbl")
                            + horner_schedule.critical_products(prog, "madd"))
        kinfo[kname]["chain_ms"] = products * latency_us[("Fp", True)] * 1e-3
        kinfo[kname]["throughput_ms"] = kinfo[kname]["muls"] / report["fp_mul_per_s"] * 1e3
        log(f"  {kname}: critical path {products} dependent products at c = {c_lad}, W = "
            f"{w_lad}, chain {kinfo[kname]['chain_ms']:.4f} ms; {kinfo[kname]['muls']} Fp "
            f"products at the measured rate {kinfo[kname]['throughput_ms']:.4f} ms; kernel "
            f"{kinfo[kname]['ms']:.4f} ms [{card}]")
    log(f"  field_pow: chain {kinfo['field_pow']['chain_ms']:.4f} ms (Fp, {(P - 2).bit_length()} "
        f"products), {report['field_pow_fr_chain_ms']:.4f} ms (Fr, {(R - 2).bit_length()}), "
        f"against the kernel's {kinfo['field_pow']['ms']:.4f} / "
        f"{report['field_pow_fr_1_ms']:.4f} ms [{card}]")
    # K2 by mode: the narrow mode's critical path of 16-lane products and
    # the wide mode's one-thread chain of serial products, each at the
    # latency phase 3 measured; all the points' products at the rate phase
    # 15 measured
    for kname in ("g1_add", "g1_dbl", "g2_add", "g2_dbl"):
        g2, op = int(kname.startswith("g2")), kname.split("_")[1]
        prog = horner_schedule.expand(1 + g2)
        for m, row in kinfo[kname]["modes"].items():
            row["chain_ms"] = (horner_schedule.critical_products(prog, op)
                               * latency_us[("Fp", True)] * 1e-3 if m == "narrow"
                               else POINT_MULS[op][g2] * latency_us[("Fp", False)] * 1e-3)
            row["throughput_ms"] = (row["points"] * POINT_MULS[op][g2]
                                    / report["fp_mul_per_s"] * 1e3)
    # K7 by mode, at every timed shape: a lane's S steps, each the madd
    # program's critical path of 16-lane products (narrow) or the madd's
    # serial one-thread chain (wide), at the latencies phase 3 measured; the
    # live steps' products at the rate phase 15 measured. The report's row
    # of a mode takes the 2^12 shape's numbers, the first it timed.
    for kname in ("g1_madd_multi", "g2_madd_multi"):
        g2 = int(kname.startswith("g2"))
        prog = horner_schedule.expand(1 + g2)
        for m, row in kinfo[kname]["modes"].items():
            for sh in row["shapes"]:
                sh["chain_ms"] = sh["steps"] * (
                    horner_schedule.critical_products(prog, "madd") * latency_us[("Fp", True)]
                    if m == "narrow" else POINT_MULS["madd"][g2] * latency_us[("Fp", False)]
                ) * 1e-3
                sh["throughput_ms"] = sh["muls"] / report["fp_mul_per_s"] * 1e3
                log(f"  {kname} {m} at the {sh['shape']} shape: {sh['ms']:.4f} ms, chain "
                    f"{sh['chain_ms']:.4f} ms, throughput {sh['throughput_ms']:.4f} ms, bound "
                    f"{sh['bound_ms']:.6f} ms ({sh['bound_by']}; bytes {sh['bytes_ms']:.6f}, "
                    f"operations {sh['ops_ms']:.6f}) [{card}]")
            ref = row["shapes"][0]
            row.update(ms=ref["ms"], plain_ms=ref["plain_ms"], lanes=ref["lanes"],
                       bound=(ref["bound_ms"], ref["bound_by"]), chain_ms=ref["chain_ms"],
                       throughput_ms=ref["throughput_ms"])

    def report_rows(k):
        """The kernel's rows of the report: one, or one a mode for K2 and K7."""
        if not k.modes:
            info, name, source, launches = kinfo[k.name], k.name, k.source, counts[k.name]
            rows = [(name, source, launches, info,
                     ("chain_ms", "throughput_ms", "k1_chain_ms", "shapes", "transforms", "lanes",
                      "widths"))]
        else:
            rows = [(f"{k.name}_{m}", k.modes[m], mode_totals[k.name][m],
                     kinfo[k.name]["modes"][m],
                     ("points", "lanes", "chain_ms", "throughput_ms", "widths", "shapes"))
                    for m in cuda_ops.MODES]
        return [{
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": k.replaces,
            "launches": launches,
            "max_abs_err": info["max_abs_err"],
            "ms": info["ms"],
            "plain_ms": info["plain_ms"],
            "bound_ms": info["bound"][0],
            "bound_by": info["bound"][1],
            "library_ms": None,
            **{key: info[key] for key in extra if key in info},
        } for name, source, launches, info, extra in rows]

    kreport = {"kernels": [row for k in kernels.REGISTRY.values() for row in report_rows(k)]}
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
