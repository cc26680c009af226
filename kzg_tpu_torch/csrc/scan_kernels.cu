// field_scan (Fr and Fp, mul and add) and fr_horner (scan.cuh).
//
// kzg_field_scan  replaces the rounds of K1 launches of `_prefix_scan` and
//     `sum_last` (kzg_tpu/fields/limb.py:337, :385 over
//     kzg_tpu/fields/pallas_field.py:295): one launch of a tile pass.
// kzg_fr_horner   replaces the K1 chain of `_div_by_linear` and
//     `_eval_many` (kzg_tpu/poly/polynomial.py:122, :94): one launch of a
//     tile pass of Horner's rule.
// The wrappers (fields/cuda_field.field_scan, poly/horner.fr_horner) chain
// one to three passes a call. Bound: see scan.cuh.
//
// C interface (ctypes): each entry launches on the caller's stream,
// allocates nothing, and returns cudaGetLastError() of the launch.

#include "scan.cuh"

using namespace kzg;

namespace {

// a tile of Fp words needs more than the 48 KB a block gets by default
template <class K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <class F, int OP>
int launch_scan(void* out, const void* in, long long ws, long long rs, long long es,
                void* totals, const void* carry, long long n, int rows, int flags,
                cudaStream_t s) {
  constexpr size_t smem = scan_smem_bytes<F>();
  static const cudaError_t attr = allow_smem(scan_kernel<F, OP>, smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((unsigned)((n + kScanTile - 1) / kScanTile), (unsigned)rows);
  scan_kernel<F, OP><<<grid, kScanThreads, smem, s>>>(
      static_cast<uint32_t*>(out), static_cast<const uint32_t*>(in), ws, rs, es,
      static_cast<uint32_t*>(totals), static_cast<const uint32_t*>(carry), n, flags);
  return (int)cudaGetLastError();
}

template <class F>
int launch_scan_op(int op, void* out, const void* in, long long ws, long long rs, long long es,
                   void* totals, const void* carry, long long n, int rows, int flags,
                   cudaStream_t s) {
  if (op == kScanOpMul)
    return launch_scan<F, kScanOpMul>(out, in, ws, rs, es, totals, carry, n, rows, flags, s);
  if (op == kScanOpAdd)
    return launch_scan<F, kScanOpAdd>(out, in, ws, rs, es, totals, carry, n, rows, flags, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// field: 0 = Fr, 1 = Fp; op: 0 = add, 2 = mul; flags: kScanReverse,
// kScanPair (rows even), kScanExclusive (scan.cuh). One tile pass over
// (N, rows, n): element (row, p) at in[l ws + row rs + p es]; with totals
// given, each tile's fold to totals (N, rows, tiles); else the scan to out
// (N, rows, n), tile g > 0 from carry[g - 1] when carry is given.
int kzg_field_scan(int field, int op, void* out, const void* in, long long ws, long long rs,
                   long long es, void* totals, const void* carry, long long n, int rows,
                   int flags, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || rows <= 0 || rows > 65535 || (out == nullptr && totals == nullptr) ||
      ((flags & kScanPair) && rows % 2))
    return (int)cudaErrorInvalidValue;
  if (field == 0) return launch_scan_op<Fr>(op, out, in, ws, rs, es, totals, carry, n, rows,
                                             flags, s);
  if (field == 1) return launch_scan_op<Fp>(op, out, in, ws, rs, es, totals, carry, n, rows,
                                             flags, s);
  return (int)cudaErrorInvalidValue;
}

// One tile pass of Horner's rule over Fr for k points x (8, k): f (8, ., n)
// at f[l fws + row frs + p], the carry in (8, k) at position n when given.
// With totals given, the tile values (8, k, tiles) and x^kScanTile to xpow;
// else q (8, k, n - 1) and rem (8, k), tile g from tile_carry (8, k, tiles - 1).
int kzg_fr_horner(void* q, void* rem, void* totals, void* xpow, const void* f, long long fws,
                  long long frs, const void* x, const void* cin, const void* tile_carry,
                  long long n, int k, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || k <= 0 || k > 65535) return (int)cudaErrorInvalidValue;
  const long long len = n + (cin != nullptr ? 1 : 0);
  const long long tiles = (len + kScanTile - 1) / kScanTile;
  if (totals == nullptr && tiles > 1 && tile_carry == nullptr) return (int)cudaErrorInvalidValue;
  constexpr size_t smem = scan_smem_bytes<Fr>();
  static const cudaError_t attr = allow_smem(horner_kernel, smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((unsigned)tiles, (unsigned)k);
  horner_kernel<<<grid, kScanThreads, smem, s>>>(
      static_cast<uint32_t*>(q), static_cast<uint32_t*>(rem), static_cast<uint32_t*>(totals),
      static_cast<uint32_t*>(xpow), static_cast<const uint32_t*>(f), fws, frs,
      static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(cin),
      static_cast<const uint32_t*>(tile_carry), n);
  return (int)cudaGetLastError();
}

}  // extern "C"
