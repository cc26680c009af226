// Kernel K4 over Fp2: the window join of the G2 Pippenger MSM.
//
// The arithmetic and kernel templates are in point.cuh; this file
// instantiates horner_join for G2 in a translation unit of its own (see
// point_g2_kernels.cu).
//
// K4  kzg_g2_horner_join          replaces _PointKernels.horner_join with
//     ncomp=2 (kzg_tpu/curve/pallas_ops.py:590): sum_w 2^(c w) S_w over
//     (12, 2, W) window sums, MSB window first; W (c + 1) dependent G2
//     point ops in one thread, infinity kept fixed through the doublings.
//     Latency bound.
//
// C interface (ctypes): the entry launches on the caller's stream,
// allocates nothing, and returns cudaGetLastError() of the launch.

#include "point.cuh"

extern "C" {

int kzg_g2_horner_join(void* ox, void* oy, void* oz, const void* sx, const void* sy,
                       const void* sz, int windows, int c, void* stream) {
  return launch_horner_join<Fp2E>(ox, oy, oz, sx, sy, sz, windows, c, stream);
}

}  // extern "C"
