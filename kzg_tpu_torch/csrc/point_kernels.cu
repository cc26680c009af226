// Kernels K2-K4, K6 and K7 over Fp: the G1 point kernels.
//
// The arithmetic, kernel templates and layouts are in point.cuh; this file
// instantiates them for G1 (coordinates (12, n) words).
//
// K2  kzg_g1_add / kzg_g1_dbl     replaces _PointKernels.add / .dbl
//     (kzg_tpu/curve/pallas_ops.py:712,707; ncomp=1). One thread per point.
//     Bound by field multiplications (add: 11M + 5S) and registers (two
//     input points and the formula's temporaries); the rare doubling inside
//     add is a per-thread branch instead of the TPU's whole-tile `lax.cond`.
// K6  kzg_g1_madd                 replaces _PointKernels.madd
//     (pallas_ops.py:270, `_madd_vals` :122-156). One thread per lane:
//     Jacobian + affine madd-2007-bl (7M + 4S) under a skip mask, with the
//     p-infinite / same / opposite cases. It serves the digit ladder
//     (CurveOps.scalar_mul_digits), where the plain tensor formula was ~25
//     field-kernel launches and a host read per madd. Bound as K2.
// K7  kzg_g1_madd_multi           replaces _PointKernels.madd_multi
//     (pallas_ops.py:275). S skip-masked, optionally negated madds per
//     bucket lane in one launch, the fused step of the bucket loop that
//     serves windows of fewer than 1024 buckets. The TPU kernel kept the
//     accumulator block in VMEM across the minor grid axis; here a thread
//     keeps its lane's accumulator in registers and reads step s's point
//     from the step-major (12, S, B) batch, coalesced over lanes. Bound:
//     the thread's chain of up to S madds (11 Fp multiplications each).
// K3  kzg_g1_bucket_accumulate    replaces _PointKernels.bucket_accumulate
//     (pallas_ops.py:388). One launch for all windows, one thread per
//     (window, bucket): the thread walks its run of the window's stable
//     sort order and madds each affine point into its accumulator, then
//     writes the bucket sum once. The TPU kernel's sequential grid of
//     1024-lane blocks, its double-buffered DMA of 8-point chunks and its
//     misalignment masks disappear: a thread reads each point (96
//     contiguous bytes of x || y words, six 16-byte loads) through the
//     sort order from a table small enough to stay in L2. Bound: the
//     madd chain of the fullest bucket of each warp and register pressure
//     (36-word accumulator, 24-word point, madd temporaries), hence
//     __launch_bounds__(128).
// K4  kzg_g1_horner_join          replaces _PointKernels.horner_join
//     (pallas_ops.py:590). sum_w 2^(c w) S_w, MSB window first: c
//     doublings (infinity kept fixed) then one add per window. A
//     sequential chain of W (c + 1) point ops; one thread holds it in
//     registers (the TPU computed the same value in all 1024 lanes).
//     Bound by the latency of dependent Fp multiplications.
//
// C interface (ctypes): each entry launches on the caller's stream,
// allocates nothing, and returns cudaGetLastError() of the launch.

#include "point.cuh"

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

// (x2, y2) affine, skip (n) bytes: non-zero keeps p
int kzg_g1_madd(void* ox, void* oy, void* oz, const void* x1, const void* y1,
                const void* z1, const void* x2, const void* y2, const void* skip,
                long long n, void* stream) {
  return launch_madd<FpE>(ox, oy, oz, x1, y1, z1, x2, y2, skip, n, stream);
}

// acc (12, n); qx / qy (12, steps, n); skip / neg (steps, n) bytes
int kzg_g1_madd_multi(void* ox, void* oy, void* oz, const void* ax, const void* ay,
                      const void* az, const void* qx, const void* qy, const void* skip,
                      const void* neg, int steps, long long n, void* stream) {
  return launch_madd_multi<FpE>(ox, oy, oz, ax, ay, az, qx, qy, skip, neg, steps, n, stream);
}

int kzg_g1_bucket_accumulate(void* ox, void* oy, void* oz, const void* rows,
                             const void* order, const void* start, const void* count,
                             int windows, int buckets, long long n, void* stream) {
  return launch_bucket_accumulate<FpE>(ox, oy, oz, rows, order, start, count, windows,
                                       buckets, n, stream);
}

int kzg_g1_horner_join(void* ox, void* oy, void* oz, const void* sx, const void* sy,
                       const void* sz, int windows, int c, void* stream) {
  return launch_horner_join<FpE>(ox, oy, oz, sx, sy, sz, windows, c, stream);
}

}  // extern "C"
