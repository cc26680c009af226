// The pairing check's two kernels (pairing.cuh).
//
// kzg_miller_loop  replaces the K1 chain of the reference's Miller loop
//     (kzg_tpu/pairing/pairing.py:109-160): one block a pair runs the
//     untwist, the 63 tangent and 5 chord steps of |x| and the final
//     conjugation.
// kzg_final_exp    replaces the K1 chain of its final exponentiation
//     (:163-170) and, in product mode, the f12_mul tree of
//     `_pairing_product_jit` (:177-193) before it.
// miller_loop runs 32 warps a block and final_exp 16 (schedule.MILLER_WARPS,
// FINAL_WARPS), each stage's chains of 16-lane Fp operations on the
// half-warps, each inverse on warp 0; bound by the chain of dependent
// products (the Miller loop's 68 Fermat inverses first).
//
// C interface (ctypes): each entry launches on the caller's stream,
// allocates nothing, and returns cudaGetLastError() of the launch.

#include "pairing.cuh"

extern "C" {

// out (12, 12, n); xp, yp (12, n) and xq, yq (12, 2, n) affine Montgomery
// words; skip (n) bytes or null, non-zero where P or Q is infinite; consts
// (12, MillerProg::kConsts) the schedule's constants, Montgomery words
int kzg_miller_loop(void* out, const void* xp, const void* yp, const void* xq, const void* yq,
                    const void* skip, const void* consts, long long n, void* stream) {
  if (n <= 0 || n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  miller_loop_kernel<MillerProg><<<(unsigned)n, 32 * MillerProg::kWarps, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(out), static_cast<const uint32_t*>(xp),
      static_cast<const uint32_t*>(yp), static_cast<const uint32_t*>(xq),
      static_cast<const uint32_t*>(yq), static_cast<const uint8_t*>(skip),
      static_cast<const uint32_t*>(consts), n);
  return (int)cudaGetLastError();
}

// out (12, 12, 1) with product != 0, else (12, 12, n); f (12, 12, n); skip
// (n) bytes or null (product mode: those lanes contribute 1); cols (ncols)
// bytes, cols[0] != 0; consts (12, FinalProg::kConsts)
int kzg_final_exp(void* out, const void* f, const void* skip, const void* cols, int ncols,
                  const void* consts, long long n, int product, void* stream) {
  if (n <= 0 || n > 0x7fffffffLL || ncols <= 0) return (int)cudaErrorInvalidValue;
  final_exp_kernel<FinalProg><<<product ? 1u : (unsigned)n, 32 * FinalProg::kWarps, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(out), static_cast<const uint32_t*>(f),
      static_cast<const uint8_t*>(skip), static_cast<const uint8_t*>(cols), ncols,
      static_cast<const uint32_t*>(consts), n, product);
  return (int)cudaGetLastError();
}

}  // extern "C"
