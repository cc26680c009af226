// Kernels K2-K4 and K7 over Fp: the G1 point kernels (K6, the mixed add,
// runs on K7's narrow entry at S = 1: curve/cuda_ops.py).
//
// The arithmetic, kernel templates and layouts are in point.cuh; this file
// instantiates them for G1 (coordinates (12, n) words).
//
// K2  kzg_g1_add / kzg_g1_dbl     replaces _PointKernels.add / .dbl
//     (kzg_tpu/curve/pallas_ops.py:712,707; ncomp=1) in two modes, which
//     cuda_ops picks by the width. Wide: one thread per point (point.cuh),
//     bound by the card's multiply throughput once the points fill it
//     (add: 11M + 5S); the rare doubling inside add is a per-thread branch
//     instead of the TPU's whole-tile `lax.cond`. Narrow
//     (kzg_g1_add_narrow / kzg_g1_dbl_narrow, pointwise.cuh): two points a
//     block, each level's products side by side over 16 lanes each, bound
//     by one point's chain of dependent products.
// K7  kzg_g1_madd_multi / kzg_g1_madd_multi_narrow  replace
//     _PointKernels.madd_multi (pallas_ops.py:275): S skip-masked,
//     optionally negated madds per bucket lane in one launch, the fused
//     step of the bucket loop that serves windows of fewer than 1024
//     buckets. Two modes, which cuda_ops picks by the width. Narrow
//     (madd_multi.cuh): two lanes a block on the ladder's engine, the
//     accumulator in shared slots, each level's products side by side over
//     16 lanes each, the next step's point copied in by cp.async while a
//     step runs; bound by a lane's chain of S madds of 5 dependent 16-lane
//     products each. Wide (point.cuh): one thread a lane, the
//     accumulator in registers; bound by the card's multiply throughput
//     once the lanes fill it (11 Fp multiplications a step).
// K3  kzg_g1_bucket_accumulate    replaces _PointKernels.bucket_accumulate
//     (pallas_ops.py:388). One launch for all windows, one thread per
//     SUB-RUN: msm.pippenger.split_runs cuts each bucket's run of the
//     window's stable sort order into pieces of at most L points, L from
//     n and B alone, longest first, and the thread madds each affine point
//     of its piece into its accumulator, then writes the partial once; a
//     segmented tree of K2 adds (msm.pippenger.combine_runs) sums the
//     pieces of a bucket. The TPU kernel's sequential grid of 1024-lane
//     blocks, its double-buffered DMA of 8-point chunks, its misalignment
//     masks, its trip cap and the segmented-scan fallback disappear.
//     Bound: the madd chain (<= L madds of 11 Fp multiplications each) and
//     the total madds at the measured multiply rate (K8: 1.54e10 Fp
//     multiplications a second). Not memory: a madd reads one 96-byte row
//     (six 16-byte loads, through the sort order) for tens of microseconds
//     of dependent arithmetic, even at 2^20 where the 96 MB table exceeds
//     the 50 MB L2, so no TMA or cp.async stage. Tensor cores do not apply
//     to CIOS on 32-bit words. Registers: 168 under __launch_bounds__(128,
//     3), 92 B spilled, three blocks an SM (point.cuh, K3MinBlocks).
// K4  kzg_g1_horner_join          replaces _PointKernels.horner_join
//     (pallas_ops.py:590). sum_w 2^(c w) S_w, MSB window first: c
//     doublings (infinity kept fixed) then one add per window. Bound by
//     the latency of the chain; one block of four warps runs it, the
//     products of each level side by side and each product over 16
//     lanes (horner.cuh, coop.cuh).
//
// C interface (ctypes): each entry launches on the caller's stream,
// allocates nothing, and returns cudaGetLastError() of the launch.

#include "point.cuh"
#include "madd_multi.cuh"
#include "pointwise.cuh"

extern "C" {

int kzg_g1_add(void* ox, void* oy, void* oz, const void* x1, const void* y1,
               const void* z1, const void* x2, const void* y2, const void* z2,
               long long n, void* stream) {
  return launch_add<FpE>(ox, oy, oz, x1, y1, z1, x2, y2, z2, n, stream);
}

int kzg_g1_dbl(void* ox, void* oy, void* oz, const void* x, const void* y,
               const void* z, long long n, void* stream) {
  return launch_dbl<FpE>(ox, oy, oz, x, y, z, n, stream);
}

int kzg_g1_add_narrow(void* ox, void* oy, void* oz, const void* x1, const void* y1,
                      const void* z1, const void* x2, const void* y2, const void* z2,
                      long long n, void* stream) {
  return launch_pointwise_add<HornerProgG1>(ox, oy, oz, x1, y1, z1, x2, y2, z2, n, stream);
}

int kzg_g1_dbl_narrow(void* ox, void* oy, void* oz, const void* x, const void* y,
                      const void* z, long long n, void* stream) {
  return launch_pointwise_dbl<HornerProgG1>(ox, oy, oz, x, y, z, n, stream);
}

// acc (12, n); qx / qy (12, steps, n); skip / neg (steps, n) bytes (neg may be null)
int kzg_g1_madd_multi(void* ox, void* oy, void* oz, const void* ax, const void* ay,
                      const void* az, const void* qx, const void* qy, const void* skip,
                      const void* neg, int steps, long long n, void* stream) {
  return launch_madd_multi_wide<FpE>(ox, oy, oz, ax, ay, az, qx, qy, skip, neg, steps, n,
                                     stream);
}

int kzg_g1_madd_multi_narrow(void* ox, void* oy, void* oz, const void* ax, const void* ay,
                             const void* az, const void* qx, const void* qy, const void* skip,
                             const void* neg, int steps, long long n, void* stream) {
  return launch_madd_multi_narrow<HornerProgG1>(ox, oy, oz, ax, ay, az, qx, qy, skip, neg,
                                                steps, n, stream);
}

// rows (n, 24); order (W * n) int32; pos / len (m) int32 sub-runs; out (12, m)
int kzg_g1_bucket_accumulate(void* ox, void* oy, void* oz, const void* rows,
                             const void* order, const void* pos, const void* len, long long m,
                             void* stream) {
  return launch_bucket_accumulate<FpE>(ox, oy, oz, rows, order, pos, len, m, stream);
}

int kzg_g1_horner_join(void* ox, void* oy, void* oz, const void* sx, const void* sy,
                       const void* sz, int windows, int c, void* stream) {
  return launch_horner_join<HornerProgG1>(ox, oy, oz, sx, sy, sz, windows, c, stream);
}

}  // extern "C"
