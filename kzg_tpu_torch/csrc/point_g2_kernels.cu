// Kernel K2 over Fp2: G2 add and dbl.
//
// The arithmetic and kernel templates are in point.cuh; this file
// instantiates them for G2 (coordinates (12, 2, n) words, c0 then c1 on
// axis 1).
//
// K2  kzg_g2_add / kzg_g2_dbl     replace _PointKernels.add / .dbl with
//     ncomp=2 (kzg_tpu/curve/pallas_ops.py:712,707).
// One thread per point. Bound by field multiplications (an Fp2 M is 3 Fp M,
// an Fp2 S 2: add 43, dbl 16 Fp multiplications) and registers: a G2
// Jacobian point is 72 words, so these entries spill to local memory.
// Every Fp2 kernel has a translation unit of its own (this one,
// madd_multi_g2_kernels.cu, msm_g2_kernels.cu, horner_g2_kernels.cu): ptxas takes
// a minute or more for each, and the build runs one nvcc per source.
//
// C interface (ctypes): each entry launches on the caller's stream,
// allocates nothing, and returns cudaGetLastError() of the launch.

#include "point.cuh"

extern "C" {

int kzg_g2_add(void* ox, void* oy, void* oz, const void* x1, const void* y1,
               const void* z1, const void* x2, const void* y2, const void* z2,
               long long n, void* stream) {
  return launch_add<Fp2E>(ox, oy, oz, x1, y1, z1, x2, y2, z2, n, stream);
}

int kzg_g2_dbl(void* ox, void* oy, void* oz, const void* x, const void* y,
               const void* z, long long n, void* stream) {
  return launch_dbl<Fp2E>(ox, oy, oz, x, y, z, n, stream);
}

}  // extern "C"
