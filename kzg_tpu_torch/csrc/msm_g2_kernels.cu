// Kernel K3 over Fp2: the bucket accumulation of the G2 Pippenger MSM.
//
// The arithmetic and kernel templates are in point.cuh; this file
// instantiates bucket_accumulate for G2 in a translation unit of its own
// (see point_g2_kernels.cu); K4 over Fp2 is in horner_g2_kernels.cu.
//
// K3  kzg_g2_bucket_accumulate    replaces _PointKernels.bucket_accumulate
//     with ncomp=2 (kzg_tpu/curve/pallas_ops.py:388). As the G1 kernel: one
//     launch for all windows, one thread per (window, bucket) walking its
//     run of the window's sort order. A point row is 48 words (x.c0, x.c1,
//     y.c0, y.c1; 192 contiguous bytes, twelve 16-byte loads); outputs
//     3 x (12, 2, W, B). An empty bucket yields infinity. Bound: the
//     madd chain of the fullest bucket of each warp (29 Fp multiplications
//     a madd) and registers: the accumulator is 72 words, the point 48, so
//     the loop body spills; accepted for a first version.
//
// C interface (ctypes): the entry launches on the caller's stream,
// allocates nothing, and returns cudaGetLastError() of the launch.

#include "point.cuh"

extern "C" {

int kzg_g2_bucket_accumulate(void* ox, void* oy, void* oz, const void* rows,
                             const void* order, const void* start, const void* count,
                             int windows, int buckets, long long n, void* stream) {
  return launch_bucket_accumulate<Fp2E>(ox, oy, oz, rows, order, start, count, windows,
                                        buckets, n, stream);
}

}  // extern "C"
