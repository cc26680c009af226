// Kernel K7 over Fp2: the fused bucket-loop step for G2, in both modes.
//
// The wide mode's template is in point.cuh, the narrow mode's in
// madd_multi.cuh; this file instantiates both for G2 (coordinates
// (12, 2, n) words, c0 then c1 on axis 1) in a translation unit of its own
// (see point_g2_kernels.cu).
//
// K7  kzg_g2_madd_multi / kzg_g2_madd_multi_narrow  replace
//     _PointKernels.madd_multi with ncomp=2 (kzg_tpu/curve/pallas_ops.py:275):
//     S skip-masked, optionally negated mixed adds per bucket lane in one
//     launch. It serves the bucket loop of G2 MSMs whose windows have fewer
//     than 1024 buckets (the all-points check over 2^12 Lagrange G2 points).
//     Narrow: two lanes a block, eight warps, each level's Fp2 products as
//     their Karatsuba Fp products side by side over 16 lanes each (a step's
//     critical path 7 products), the next step's point copied in by
//     cp.async. Wide: one thread a lane (29 Fp multiplications a step), its
//     72-word accumulator and 48-word point in registers: it spills.
//
// C interface (ctypes): each entry launches on the caller's stream,
// allocates nothing, and returns cudaGetLastError() of the launch.

#include "point.cuh"
#include "madd_multi.cuh"

extern "C" {

// acc (12, 2, n); qx / qy (12, 2, steps, n); skip / neg (steps, n) bytes (neg may be null)
int kzg_g2_madd_multi(void* ox, void* oy, void* oz, const void* ax, const void* ay,
                      const void* az, const void* qx, const void* qy, const void* skip,
                      const void* neg, int steps, long long n, void* stream) {
  return launch_madd_multi_wide<Fp2E>(ox, oy, oz, ax, ay, az, qx, qy, skip, neg, steps, n,
                                      stream);
}

int kzg_g2_madd_multi_narrow(void* ox, void* oy, void* oz, const void* ax, const void* ay,
                             const void* az, const void* qx, const void* qy, const void* skip,
                             const void* neg, int steps, long long n, void* stream) {
  return launch_madd_multi_narrow<HornerProgG2>(ox, oy, oz, ax, ay, az, qx, qy, skip, neg,
                                                steps, n, stream);
}

}  // extern "C"
