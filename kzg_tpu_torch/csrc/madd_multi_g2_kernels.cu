// Kernel K7 over Fp2: the fused bucket-loop step for G2.
//
// The arithmetic and kernel templates are in point.cuh; this file
// instantiates madd_multi for G2 (coordinates (12, 2, n) words, c0 then c1
// on axis 1) in a translation unit of its own (see point_g2_kernels.cu).
//
// K7  kzg_g2_madd_multi           replaces _PointKernels.madd_multi with
//     ncomp=2 (kzg_tpu/curve/pallas_ops.py:275): S skip-masked, optionally
//     negated mixed adds per bucket lane in one launch, the accumulator in
//     the thread's registers across the steps. It serves the bucket loop of
//     G2 MSMs whose windows have fewer than 1024 buckets (the all-points
//     check over 2^12 Lagrange G2 points). Bound: the thread's chain of up
//     to S madds (29 Fp multiplications each) and registers (72-word
//     accumulator, 48-word point: it spills).
//
// C interface (ctypes): the entry launches on the caller's stream,
// allocates nothing, and returns cudaGetLastError() of the launch.

#include "point.cuh"

extern "C" {

// acc (12, 2, n); qx / qy (12, 2, steps, n); skip / neg (steps, n) bytes
int kzg_g2_madd_multi(void* ox, void* oy, void* oz, const void* ax, const void* ay,
                      const void* az, const void* qx, const void* qy, const void* skip,
                      const void* neg, int steps, long long n, void* stream) {
  return launch_madd_multi<Fp2E>(ox, oy, oz, ax, ay, az, qx, qy, skip, neg, steps, n, stream);
}

}  // extern "C"
