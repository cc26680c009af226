// The fixed-base comb over G1: FK20's products of fixed points by scalars
// that change every call (kzg_tpu_torch/kzg/das.py).
//
// kzg_g1_fk20_comb  takes, on that path, the place of the digit ladder's
//     rounds (ladder_kernels.cu), which redo W c doublings a lane for
//     points that never change. The doublings move into a table made once
//     for the points (msm.pippenger.comb_table): entry (w, p, d - 1) is the
//     affine point d 2^(4 w) P_p, for the 64 windows w of a 256-bit scalar
//     and the digits d = 1 .. 15, its x words then its y words, 96
//     contiguous bytes. Lane i multiplies point i mod P by its scalar: from
//     infinity, MSB window first, one mixed addition of the entry its digit
//     selects a window, skipped where the digit is 0 or the point is
//     infinite. No doubling runs here; the one-thread madd of K3 and K7's
//     wide mode (point.cuh, the PTX carry chains of field.cuh), with its
//     exceptional cases (acc infinite -> the entry; P == Q -> dbl; P == -Q
//     -> infinity), so every product is exact and equals the plain twin
//     (curve/cuda_ops.py, fk20_comb_plain) word for word.
//
//     Layout of the table, (64, P, 15, 24) words: window-major, so the
//     entries one window reads (P x 15 x 96 bytes, 11.8 MB at FK20's 8,192
//     points) stay in the 50 MB L2 while the lanes of every blob walk the
//     windows together. Bound: the lanes' madds (11 Fp products each, ~60
//     of 64 digits non-zero) at the one-thread product rate; each madd
//     reads one 96-byte entry, which its arithmetic hides.
//
// C interface (ctypes): the entry launches on the caller's stream,
// allocates nothing, and returns cudaGetLastError() of the launch.

#include "point.cuh"

namespace {

constexpr int kCombWindow = 4;                        // bits a digit
constexpr int kCombEntries = (1 << kCombWindow) - 1;  // the digits 1 .. 15
constexpr int kDigitsPerWord = 32 / kCombWindow;      // 64 windows over Fr's 8 words
constexpr int kRowWords = 2 * kW;                     // x then y

// One thread a lane, K3's block shape and its three resident blocks an SM
// (168 registers): the loop is K3's, one madd of a 96-byte affine row into
// a Jacobian accumulator a step.
__global__ void __launch_bounds__(kPointThreads, K3MinBlocks<FpE>::value)
fk20_comb_kernel(uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                 uint32_t* __restrict__ oz, const uint32_t* __restrict__ table,
                 const uint8_t* __restrict__ p_inf, const uint32_t* __restrict__ scalars,
                 long long points, long long lanes) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= lanes) return;
  const long long p = i % points;
  Jac<FpE> acc = infinity<FpE>();
  if (!p_inf[p]) {
#pragma unroll 1
    for (int k = Fr::N - 1; k >= 0; k--) {
      const uint32_t word = scalars[(long long)k * lanes + i];
#pragma unroll 1
      for (int s = kDigitsPerWord - 1; s >= 0; s--) {
        const uint32_t d = (word >> (kCombWindow * s)) & kCombEntries;
        if (d == 0u) continue;
        const long long w = (long long)k * kDigitsPerWord + s;
        const uint32_t* row = table + ((w * points + p) * kCombEntries + (d - 1u)) * kRowWords;
        acc = madd(acc, fe_load_row(row), fe_load_row(row + kW));
      }
    }
  }
  store_point<FpE>(ox, oy, oz, lanes, i, acc);
}

}  // namespace

extern "C" {

// out (12, lanes); table (64, points, 15, 24) words; p_inf (points) bytes,
// non-zero where the point is infinite; scalars (8, lanes) standard-form
// words, lane i's point i mod points
int kzg_g1_fk20_comb(void* ox, void* oy, void* oz, const void* table, const void* p_inf,
                     const void* scalars, long long points, long long lanes, void* stream) {
  if (points <= 0 || lanes <= 0) return (int)cudaErrorInvalidValue;
  fk20_comb_kernel<<<blocks_for(lanes), kPointThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(ox), static_cast<uint32_t*>(oy), static_cast<uint32_t*>(oz),
      static_cast<const uint32_t*>(table), static_cast<const uint8_t*>(p_inf),
      static_cast<const uint32_t*>(scalars), points, lanes);
  return (int)cudaGetLastError();
}

}  // extern "C"
