// Kernel K4 over Fp2: the window join of the G2 Pippenger MSM.
//
// The kernel template is in horner.cuh; this file instantiates it for G2
// in a translation unit of its own.
//
// K4  kzg_g2_horner_join          replaces _PointKernels.horner_join with
//     ncomp=2 (kzg_tpu/curve/pallas_ops.py:590): sum_w 2^(c w) S_w over
//     (12, 2, W) window sums, MSB window first, infinity kept fixed through
//     the doublings. Latency bound; one block of eight warps runs the
//     chain, each level's Fp2 products as their Karatsuba Fp products side
//     by side, each Fp product over 16 lanes (horner.cuh, coop.cuh).
//
// C interface (ctypes): the entry launches on the caller's stream,
// allocates nothing, and returns cudaGetLastError() of the launch.

#include "horner.cuh"

extern "C" {

int kzg_g2_horner_join(void* ox, void* oy, void* oz, const void* sx, const void* sy,
                       const void* sz, int windows, int c, void* stream) {
  return launch_horner_join<HornerProgG2>(ox, oy, oz, sx, sy, sz, windows, c, stream);
}

}  // extern "C"
