// Kernel K9: the reduce epilogue of the matmul-DFT NTT.
//
// Replaces `_make_reduce_kernel` (kzg_tpu/ntt/mxu.py:135, body `_reduce_body`
// :103-132). The DFT block product leaves, for every output element, 64
// base-256 digit sums y_0 .. y_63 (int32, each below 2^29; y_63 is the
// padding row) whose value sum_d y_d 256^d is (sum_j w_j x_j) R^2, below
// 2^519. The kernel turns them into the canonical Montgomery element:
//
//   1. ripple the digit sums with a 32-bit carry into bytes d_0 .. d_63;
//   2. b = d_63 + 256 * carry_out (< 2^16): the part at and above 2^504;
//   3. T = (d_0 .. d_62 as 16 words) + b * (2^504 mod r), below 2^504 + 2^271;
//   4. Montgomery reduction of the 512-bit T (`fe_redc`, field.cuh): below
//      2^248 + 2^15 + r < 2 r before its one conditional subtraction, so the
//      result is the canonical T R^-1 mod r, as 8 packed words.
//
// The TPU kernel worked on (64, 8, 128) tiles of 16-bit limb planes in VMEM;
// here one thread owns one element: it reads its 64 digit sums (row d of the
// (64, B) array at d * B + i, so a warp's loads coalesce over B), keeps the
// 16 words of T in registers, and writes 8 words. Bound on the H100: bytes,
// 64 * 4 in and 32 out an element over 3.35 TB/s; the arithmetic is 8 + 64
// multiply-adds and ~200 shifts and adds an element.
//
// C interface (ctypes): launches on the caller's stream, allocates nothing,
// returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>

#include "field.cuh"

using namespace kzg;

namespace {

constexpr int kThreads = 256;
constexpr int kDigits = 64;     // OUT_DIGITS of ntt/mxu.py
constexpr int kFoldDigit = 63;  // digits from here up fold back by 2^504 mod r

// 2^504 mod r, little-endian words
__constant__ uint32_t K_FOLD[8] = {
    0xfdf3f29du, 0x90c999e8u, 0x8486a12fu, 0x9e41521bu,
    0x33fa4344u, 0x86700a21u, 0x9a84c8efu, 0x4298bfeeu};

__global__ void __launch_bounds__(kThreads)
mxu_reduce_kernel(uint32_t* __restrict__ out, const int32_t* __restrict__ y, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t t[16];
  uint32_t carry = 0u;
#pragma unroll
  for (int w = 0; w < 16; w++) {
    uint32_t word = 0u;
#pragma unroll
    for (int k = 0; k < 4; k++) {
      const int d = 4 * w + k;
      const uint32_t s = (uint32_t)y[(long long)d * n + i] + carry;
      if (d < kFoldDigit) {
        word |= (s & 0xffu) << (8 * k);
        carry = s >> 8;
      } else {
        carry = s;  // b = d_63 + 256 * carry_out
      }
    }
    t[w] = word;
  }
  const uint32_t b = carry;
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < 8; j++) {
    const uint64_t s = (uint64_t)b * K_FOLD[j] + t[j] + c;
    t[j] = (uint32_t)s;
    c = s >> 32;
  }
#pragma unroll
  for (int j = 8; j < 16; j++) {
    const uint64_t s = (uint64_t)t[j] + c;
    t[j] = (uint32_t)s;
    c = s >> 32;
  }
  fe_store<Fr>(out, n, i, fe_redc<Fr>(t));
}

}  // namespace

extern "C" {

// out (8, n) Montgomery Fr words from y (64, n) int32 digit sums.
int kzg_mxu_reduce(void* out, const void* y, long long n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  static_assert(kDigits == 64 && kFoldDigit == kDigits - 1, "digit layout");
  mxu_reduce_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(out), static_cast<const int32_t*>(y), n);
  return (int)cudaGetLastError();
}

}  // extern "C"
