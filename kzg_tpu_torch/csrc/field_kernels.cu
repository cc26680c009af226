// Kernel K1: elementwise Montgomery field arithmetic over Fr and Fp.
//
// Replaces the Pallas elementwise kernels behind LimbField add / sub / mul
// / sqr / mul_const / to_mont / from_mont: `FieldKernels.try_binary` and
// `try_mul_const` (kzg_tpu/fields/pallas_field.py:433,442, launched by
// `_run_elementwise`, :273-305). The TPU kernel tiled 1024-lane blocks of
// 16-bit limb planes through VMEM; here one thread owns one element and
// keeps its 8 or 12 words in registers.
//
// Bound on the H100: `mul` is integer-multiply bound (N^2 + N^2 32-bit
// multiply-adds per element for CIOS, 288 for Fp); `add`/`sub` move 3N
// words for ~4N integer ops and are device-memory bound. The limb-major
// (N, n) layout makes each word load a coalesced 128-byte warp access.
//
// Kernel K8, `mul_chain`, replaces `make_mul_chain` (pallas_field.py:323):
// acc = a, then k times acc = acc * b, in one launch. It is the probe that
// measures the card's dependent-multiply rate: the time of k = 65 less the
// time of k = 1 holds 64 products an element and no launch cost. Each
// thread loads a and b once and keeps acc in registers; k arrives as an
// argument and the loop stays rolled (`#pragma unroll 1`), so the compiler
// can neither hoist nor shorten the chain (acc depends on acc). Bound:
// k (2 N^2 + N) multiply-adds an element; three rows of bytes whatever k.
// Its cooperative mode (`kzg_field_mul_chain_coop`) runs the same chain
// with each product spread over 16 lanes of a warp (coop.cuh), one element
// a warp: the product K4 chains, so one element's marginal time is that
// product's latency beside the one-thread CIOS's.
//
// C interface (ctypes): each entry launches on the caller's stream,
// allocates nothing, and returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>

#include "coop.cuh"
#include "field.cuh"

using namespace kzg;

namespace {

constexpr int kThreads = 256;

template <class F, int OP>
__global__ void __launch_bounds__(kThreads)
binary_kernel(uint32_t* __restrict__ out, const uint32_t* __restrict__ a,
              const uint32_t* __restrict__ b, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Fe<F> x = fe_load<F>(a, n, i);
  const Fe<F> y = fe_load<F>(b, n, i);
  Fe<F> r;
  if (OP == 0) {
    r = fe_add<F>(x, y);
  } else if (OP == 1) {
    r = fe_sub<F>(x, y);
  } else {
    r = fe_mul<F>(x, y);
  }
  fe_store<F>(out, n, i, r);
}

template <class F>
__global__ void __launch_bounds__(kThreads)
mul_const_kernel(uint32_t* __restrict__ out, const uint32_t* __restrict__ a,
                 const Fe<F> c, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  fe_store<F>(out, n, i, fe_mul<F>(fe_load<F>(a, n, i), c));
}

template <class F>
__global__ void __launch_bounds__(kThreads)
mul_chain_kernel(uint32_t* __restrict__ out, const uint32_t* __restrict__ a,
                 const uint32_t* __restrict__ b, int k, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Fe<F> acc = fe_load<F>(a, n, i);
  const Fe<F> y = fe_load<F>(b, n, i);
#pragma unroll 1
  for (int s = 0; s < k; s++) acc = fe_mul<F>(acc, y);
  fe_store<F>(out, n, i, acc);
}

// one element a warp, its lanes 0-15 on the words (coop.cuh); acc and b
// in shared memory, acc written to the other buffer each step
constexpr int kCoopWarps = 4;

template <class F>
__global__ void __launch_bounds__(32 * kCoopWarps)
mul_chain_coop_kernel(uint32_t* __restrict__ out, const uint32_t* __restrict__ a,
                      const uint32_t* __restrict__ b, int k, long long n) {
  __shared__ uint32_t sm[kCoopWarps][3][kCoopLanes];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long i = (long long)blockIdx.x * kCoopWarps + warp;
  if (i >= n || lane >= kCoopLanes) return;
  const CoopLane<F> L(lane);
  uint32_t* acc = sm[warp][0];
  uint32_t* nxt = sm[warp][1];
  uint32_t* y = sm[warp][2];
  acc[lane] = lane < F::N ? a[lane * n + i] : 0u;
  y[lane] = lane < F::N ? b[lane * n + i] : 0u;
  __syncwarp(kCoopMask);
#pragma unroll 1
  for (int s = 0; s < k; s++) {
    nxt[lane] = coop_mul<F>(L, acc, y);
    __syncwarp(kCoopMask);
    uint32_t* t = acc;
    acc = nxt;
    nxt = t;
  }
  if (lane < F::N) out[lane * n + i] = acc[lane];
}

inline unsigned blocks_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

template <class F>
int launch_binary(int op, uint32_t* out, const uint32_t* a, const uint32_t* b,
                  long long n, cudaStream_t s) {
  const unsigned g = blocks_for(n);
  switch (op) {
    case 0: binary_kernel<F, 0><<<g, kThreads, 0, s>>>(out, a, b, n); break;
    case 1: binary_kernel<F, 1><<<g, kThreads, 0, s>>>(out, a, b, n); break;
    case 2: binary_kernel<F, 2><<<g, kThreads, 0, s>>>(out, a, b, n); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <class F>
int launch_mul_const(uint32_t* out, const uint32_t* a, const uint32_t* c_host,
                     long long n, cudaStream_t s) {
  Fe<F> c;
  for (int l = 0; l < F::N; l++) c.w[l] = c_host[l];
  mul_const_kernel<F><<<blocks_for(n), kThreads, 0, s>>>(out, a, c, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// field: 0 = Fr, 1 = Fp; op: 0 = add, 1 = sub, 2 = mul. Arrays are (N, n).
int kzg_field_binary(int field, int op, void* out, const void* a, const void* b,
                     long long n, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto o = static_cast<uint32_t*>(out);
  auto x = static_cast<const uint32_t*>(a);
  auto y = static_cast<const uint32_t*>(b);
  if (n <= 0) return (int)cudaErrorInvalidValue;
  if (field == 0) return launch_binary<Fr>(op, o, x, y, n, s);
  if (field == 1) return launch_binary<Fp>(op, o, x, y, n, s);
  return (int)cudaErrorInvalidValue;
}

// out = a * c * R^-1 with c an N-word constant read from host memory and
// passed to the kernel by value.
int kzg_field_mul_const(int field, void* out, const void* a, const void* c_host,
                        long long n, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto o = static_cast<uint32_t*>(out);
  auto x = static_cast<const uint32_t*>(a);
  auto c = static_cast<const uint32_t*>(c_host);
  if (n <= 0) return (int)cudaErrorInvalidValue;
  if (field == 0) return launch_mul_const<Fr>(o, x, c, n, s);
  if (field == 1) return launch_mul_const<Fp>(o, x, c, n, s);
  return (int)cudaErrorInvalidValue;
}

// out = a * b^k * R^-k: k dependent Montgomery products, one launch.
int kzg_field_mul_chain(int field, void* out, const void* a, const void* b, int k,
                        long long n, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto o = static_cast<uint32_t*>(out);
  auto x = static_cast<const uint32_t*>(a);
  auto y = static_cast<const uint32_t*>(b);
  if (n <= 0 || k < 0) return (int)cudaErrorInvalidValue;
  if (field == 0) {
    mul_chain_kernel<Fr><<<blocks_for(n), kThreads, 0, s>>>(o, x, y, k, n);
  } else if (field == 1) {
    mul_chain_kernel<Fp><<<blocks_for(n), kThreads, 0, s>>>(o, x, y, k, n);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// the same, each product over 16 lanes of a warp, one element a warp
int kzg_field_mul_chain_coop(int field, void* out, const void* a, const void* b, int k,
                             long long n, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto o = static_cast<uint32_t*>(out);
  auto x = static_cast<const uint32_t*>(a);
  auto y = static_cast<const uint32_t*>(b);
  if (n <= 0 || k < 0) return (int)cudaErrorInvalidValue;
  const unsigned g = (unsigned)((n + kCoopWarps - 1) / kCoopWarps);
  if (field == 0) {
    mul_chain_coop_kernel<Fr><<<g, 32 * kCoopWarps, 0, s>>>(o, x, y, k, n);
  } else if (field == 1) {
    mul_chain_coop_kernel<Fp><<<g, 32 * kCoopWarps, 0, s>>>(o, x, y, k, n);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
