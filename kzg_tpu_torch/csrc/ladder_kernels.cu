// The digit ladder over G1 and G2 in one launch each (ladder.cuh).
//
// kzg_g1_ladder / kzg_g2_ladder  replace, on the digit ladder's path, the
//     rounds of _PointKernels.dbl and .madd (kzg_tpu/curve/pallas_ops.py:707,
//     :270, ncomp = 1 and 2) that kzg_tpu/curve/ops.py:316-374 runs: W
//     windows of c doublings and one skip-masked mixed addition a lane. Two
//     lanes a block (one a half-warp), four warps over Fp and eight over
//     Fp2, each level's products side by side and each product over 16
//     lanes (K4's engine, horner.cuh, coop.cuh). Bound by each lane's chain
//     of products and, once the lanes fill the card, by the instruction
//     throughput of those products.
//
// C interface (ctypes): each entry launches on the caller's stream,
// allocates nothing, and returns cudaGetLastError() of the launch.

#include "ladder.cuh"

extern "C" {

// out (12[, 2], lanes); tx / ty (12[, 2], entries, lanes) affine multiples
// 1 .. 2^c - 1 of each lane's point; digits (windows, lanes) int32, MSB
// window first; p_inf (lanes) bytes, non-zero where the point is infinite
int kzg_g1_ladder(void* ox, void* oy, void* oz, const void* tx, const void* ty,
                  const void* digits, const void* p_inf, int windows, int c, int entries,
                  long long lanes, void* stream) {
  return launch_ladder<HornerProgG1>(ox, oy, oz, tx, ty, digits, p_inf, windows, c, entries,
                                     lanes, stream);
}

int kzg_g2_ladder(void* ox, void* oy, void* oz, const void* tx, const void* ty,
                  const void* digits, const void* p_inf, int windows, int c, int entries,
                  long long lanes, void* stream) {
  return launch_ladder<HornerProgG2>(ox, oy, oz, tx, ty, digits, p_inf, windows, c, entries,
                                     lanes, stream);
}

}  // extern "C"
