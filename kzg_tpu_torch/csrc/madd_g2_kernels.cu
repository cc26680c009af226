// Kernel K6 over Fp2: the G2 mixed add.
//
// The arithmetic and kernel templates are in point.cuh; this file
// instantiates madd for G2 (coordinates (12, 2, n) words, c0 then c1 on
// axis 1) in a translation unit of its own (see point_g2_kernels.cu).
//
// K6  kzg_g2_madd                 replaces _PointKernels.madd with ncomp=2
//     (kzg_tpu/curve/pallas_ops.py:270, `_madd_vals` :122-156): Jacobian +
//     affine under a skip mask, the body of the G2 digit ladder of the
//     Lagrange-SRS group iNTT. One thread per lane; 29 Fp multiplications;
//     bound by that chain and by registers (72-word point, 48-word affine
//     operand: it spills).
//
// C interface (ctypes): the entry launches on the caller's stream,
// allocates nothing, and returns cudaGetLastError() of the launch.

#include "point.cuh"

extern "C" {

// (x2, y2) affine, skip (n) bytes: non-zero keeps p
int kzg_g2_madd(void* ox, void* oy, void* oz, const void* x1, const void* y1,
                const void* z1, const void* x2, const void* y2, const void* skip,
                long long n, void* stream) {
  return launch_madd<Fp2E>(ox, oy, oz, x1, y1, z1, x2, y2, skip, n, stream);
}

}  // extern "C"
