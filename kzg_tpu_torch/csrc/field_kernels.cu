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
// C interface (ctypes): each entry launches on the caller's stream,
// allocates nothing, and returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>

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

}  // extern "C"
