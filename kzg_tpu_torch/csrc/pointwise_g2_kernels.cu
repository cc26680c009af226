// Kernel K2's narrow mode over Fp2: G2 add and dbl, two points a block.
//
// The kernel templates are in pointwise.cuh; this file instantiates them
// for G2 (coordinates (12, 2, n) words) in a translation unit of its own,
// as every Fp2 kernel has one.
//
// K2  kzg_g2_add_narrow / kzg_g2_dbl_narrow  replace _PointKernels.add /
//     .dbl with ncomp=2 (kzg_tpu/curve/pallas_ops.py:712,707) on the
//     launches too narrow to fill the card; the wide ones stay one thread a
//     point (point_g2_kernels.cu). Eight warps a block, each level's Fp2
//     products as their Karatsuba Fp products side by side, each Fp product
//     over 16 lanes (horner.cuh, coop.cuh). Bound by one point's chain of
//     dependent products (8 of the addition, 3 of the doubling).
//
// C interface (ctypes): each entry launches on the caller's stream,
// allocates nothing, and returns cudaGetLastError() of the launch.

#include "pointwise.cuh"

extern "C" {

int kzg_g2_add_narrow(void* ox, void* oy, void* oz, const void* x1, const void* y1,
                      const void* z1, const void* x2, const void* y2, const void* z2,
                      long long n, void* stream) {
  return launch_pointwise_add<HornerProgG2>(ox, oy, oz, x1, y1, z1, x2, y2, z2, n, stream);
}

int kzg_g2_dbl_narrow(void* ox, void* oy, void* oz, const void* x, const void* y,
                      const void* z, long long n, void* stream) {
  return launch_pointwise_dbl<HornerProgG2>(ox, oy, oz, x, y, z, n, stream);
}

}  // extern "C"
