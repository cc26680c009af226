// Kernel K5 over Montgomery Fr, in two entries: `kzg_ntt_block`, whole
// sub-transforms in one launch (csrc/ntt_block.cuh: the Domain's route on
// the card), and `kzg_ntt_stage`, one decimation-in-frequency butterfly
// stage of the radix-2 NTT: the route as it was, kept as the reference the
// block kernel is timed beside and for the plain Domain's stage loop.
//
// The stage kernel:
//
// Replaces `make_ntt_stage` (kzg_tpu/fields/pallas_field.py:346-364), which
// every stage of the JAX package's Pease loop (kzg_tpu/ntt/domain.py:387-410)
// and of its row-batched four-step loop (`_ntt_axis2`, :324-341) launches.
// It computes the same function, (u, v) = (a + b, (a - b) * w), but not the
// same data movement. The TPU kernel took three (16, B) operands the caller
// had laid out: the two halves of the array and a per-stage twiddle tensor
// broadcast to full width, and returned u and v, which the caller then
// interleaved with `jnp.stack` + reshape (Mosaic could not lower the lane
// interleave, pallas_field.py:350-354). Here one thread does one butterfly
// and does the layout work itself:
//
//   * x is (8, nb, m, bt) words, viewed as nb independent m-point
//     transforms along axis 2, each element a contiguous row of bt lanes
//     (bt = 1 for the Pease loop over (8, *batch, n); bt = the other
//     four-step factor for `_ntt_axis2`, where whole rows move);
//   * butterfly (b, j, c), j < h = m / 2, reads rows j and j + h;
//   * its twiddle is read from the domain's half table omega^k, k < h, at
//     k = j with the low s bits cleared (stage s): no broadcast twiddle
//     tensor is built or read;
//   * u and v are written straight to rows 2j and 2j + 1, the interleaved
//     order the next stage reads, so no stack / reshape pass follows.
//
// Out of place (the caller allocates `out`). Bound on the H100: the Fr
// Montgomery multiply (8-word CIOS, 128 32x32->64 multiply-adds) against
// 3 x 32 B read + 2 x 32 B written per butterfly. At bt = 1 the stores to
// rows 2j / 2j + 1 are 2-way strided, so a warp writes each 128-byte line
// in two halves. ntt_block.cuh runs every stage of a sub-transform, the
// bit reversal and the scales in one launch instead.
//
// C interface (ctypes): launches on the caller's stream, allocates nothing,
// returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>

#include "field.cuh"
#include "ntt_block.cuh"

using namespace kzg;

namespace {

constexpr int kThreads = 256;

// x, out: (8, nb * m * bt) words; tw: (8, tlen) words, tlen >= m / 2
__global__ void __launch_bounds__(kThreads)
ntt_stage_kernel(uint32_t* __restrict__ out, const uint32_t* __restrict__ x,
                 const uint32_t* __restrict__ tw, long long nb, long long m, long long bt,
                 long long tlen, int s) {
  const long long h = m >> 1;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= nb * h * bt) return;
  const long long n = nb * m * bt;  // elements per word plane
  const long long c = t % bt;
  const long long r = t / bt;
  const long long j = r % h;
  const long long b = r / h;
  const long long ia = (b * m + j) * bt + c;
  const long long iu = (b * m + 2 * j) * bt + c;
  const long long k = j & ~((1LL << s) - 1);
  const Fe<Fr> a = fe_load<Fr>(x, n, ia);
  const Fe<Fr> bb = fe_load<Fr>(x, n, ia + h * bt);
  const Fe<Fr> w = fe_load<Fr>(tw, tlen, k);
  fe_store<Fr>(out, n, iu, fe_add<Fr>(a, bb));
  fe_store<Fr>(out, n, iu + bt, fe_mul<Fr>(fe_sub<Fr>(a, bb), w));
}

}  // namespace

extern "C" {

int kzg_ntt_stage(void* out, const void* x, const void* tw, long long nb, long long m,
                  long long bt, long long tlen, int s, void* stream) {
  const long long butterflies = nb * (m >> 1) * bt;
  if (butterflies <= 0 || (m & 1) || tlen < (m >> 1) || s < 0 || s >= 62)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((butterflies + kThreads - 1) / kThreads);
  ntt_stage_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(out), static_cast<const uint32_t*>(x),
      static_cast<const uint32_t*>(tw), nb, m, bt, tlen, s);
  return (int)cudaGetLastError();
}

// (out, x, stage table (m, 8), columns nb * bt, log2 m, bt, out_bt, log2 cols,
//  threads, then per scale (pre, post): hi or null, lo, mode, s, div; stream)
int kzg_ntt_block(void* out, const void* x, const void* tw, long long ncol, int log_m,
                  long long bt, long long out_bt, int log_cols, int threads,
                  const void* pre_hi, const void* pre_lo, int pre_mode, int pre_s,
                  long long pre_div, const void* post_hi, const void* post_lo, int post_mode,
                  int post_s, long long post_div, void* stream) {
  const NttScale pre{static_cast<const uint32_t*>(pre_hi), static_cast<const uint32_t*>(pre_lo),
                     pre_mode, pre_s, pre_div};
  const NttScale post{static_cast<const uint32_t*>(post_hi),
                      static_cast<const uint32_t*>(post_lo), post_mode, post_s, post_div};
  return launch_ntt_block<kNttTw>(out, x, tw, ncol, log_m, bt, out_bt, log_cols, threads, pre,
                                  post, stream);
}

}  // extern "C"
