// Kernel K3 over Fp2: the bucket accumulation of the G2 Pippenger MSM.
//
// The arithmetic and kernel templates are in point.cuh; this file
// instantiates bucket_accumulate for G2 in a translation unit of its own
// (see point_g2_kernels.cu); K4 over Fp2 is in horner_g2_kernels.cu.
//
// K3  kzg_g2_bucket_accumulate    replaces _PointKernels.bucket_accumulate
//     with ncomp=2 (kzg_tpu/curve/pallas_ops.py:388). As the G1 kernel: one
//     launch for all windows, one thread per sub-run of at most L points
//     of a bucket's run (msm.pippenger.split_runs), the partials summed by
//     a segmented tree of G2 adds. A point row is 48 words (x.c0, x.c1,
//     y.c0, y.c1; 192 contiguous bytes, twelve 16-byte loads); outputs
//     3 x (12, 2, m). Bound: the madd chain (<= L madds of 29 Fp
//     multiplications each) and the total madds at the multiply rate; not
//     memory (one 192-byte row a madd), so no TMA or cp.async, and no
//     tensor cores for CIOS on 32-bit words. Registers: the accumulator is
//     72 words, the point 48: 255 registers and 580 B spilled, two blocks
//     an SM; three (168 registers) spill 1.8 KB and run slower (point.cuh,
//     K3MinBlocks).
//
// C interface (ctypes): the entry launches on the caller's stream,
// allocates nothing, and returns cudaGetLastError() of the launch.

#include "point.cuh"

extern "C" {

// rows (n, 48); order (W * n) int32; pos / len (m) int32 sub-runs; out (12, 2, m)
int kzg_g2_bucket_accumulate(void* ox, void* oy, void* oz, const void* rows,
                             const void* order, const void* pos, const void* len, long long m,
                             void* stream) {
  return launch_bucket_accumulate<Fp2E>(ox, oy, oz, rows, order, pos, len, m, stream);
}

}  // extern "C"
