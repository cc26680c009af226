// Kernels K2-K4: G1 point arithmetic of the Pippenger MSM.
//
// Group law over Fp (field.cuh), Jacobian (X, Y, Z) with Z == 0 for
// infinity, written (1, 1, 0) in Montgomery form. The formulas and the
// exceptional-case handling are those of the Pallas kernels
// (kzg_tpu/curve/pallas_ops.py:81-196) and of `CurveOps`
// (kzg_tpu/curve/ops.py:195-283): dbl-2009-l, add-2007-bl, madd-2007-bl
// with a = 0. Every field value is canonical, so outputs equal the plain
// PyTorch twin (kzg_tpu_torch/curve/ops.py) word for word.
//
// K2  kzg_g1_add / kzg_g1_dbl     replaces _PointKernels.add / .dbl
//     (pallas_ops.py:712,707). One thread per point. Bound by Fp
//     multiplications (add: 11M + 5S) and registers (two input points and
//     the formula's temporaries); the rare doubling inside add is a
//     per-thread branch instead of the TPU's whole-tile `lax.cond`.
// K3  kzg_g1_bucket_accumulate    replaces _PointKernels.bucket_accumulate
//     (pallas_ops.py:388). One launch for all windows, one thread per
//     (window, bucket): the thread walks its run of the window's stable
//     sort order and madds each affine point into its accumulator, then
//     writes the bucket sum once. The TPU kernel's sequential grid of
//     1024-lane blocks, its double-buffered DMA of 8-point chunks and its
//     misalignment masks disappear: a thread reads each point (96
//     contiguous bytes of x || y words, six 16-byte loads) through the
//     sort order from a table small enough to stay in L2. Bound: the
//     madd chain of the fullest bucket of each warp and register pressure
//     (36-word accumulator, 24-word point, madd temporaries), hence
//     __launch_bounds__(128).
// K4  kzg_g1_horner_join          replaces _PointKernels.horner_join
//     (pallas_ops.py:590). sum_w 2^(c w) S_w, MSB window first: c
//     doublings (infinity kept fixed) then one add per window. A
//     sequential chain of W (c + 1) point ops; one thread holds it in
//     registers (the TPU computed the same value in all 1024 lanes).
//     Bound by the latency of dependent Fp multiplications.
//
// C interface (ctypes): each entry launches on the caller's stream,
// allocates nothing, and returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>

#include "field.cuh"

using namespace kzg;

namespace {

using FpE = Fe<Fp>;
constexpr int kW = Fp::N;  // 12 words per coordinate

struct Jac {
  FpE x, y, z;
};

__device__ __forceinline__ FpE add(const FpE& a, const FpE& b) { return fe_add<Fp>(a, b); }
__device__ __forceinline__ FpE sub(const FpE& a, const FpE& b) { return fe_sub<Fp>(a, b); }
__device__ __forceinline__ FpE mul(const FpE& a, const FpE& b) { return fe_mul<Fp>(a, b); }
__device__ __forceinline__ FpE sqr(const FpE& a) { return fe_mul<Fp>(a, a); }
__device__ __forceinline__ bool is_zero(const FpE& a) { return fe_is_zero<Fp>(a); }

__device__ __forceinline__ Jac infinity() {
  return Jac{fe_one<Fp>(), fe_one<Fp>(), fe_zero<Fp>()};
}

__device__ __forceinline__ Jac load_point(const uint32_t* x, const uint32_t* y,
                                          const uint32_t* z, long long stride,
                                          long long i) {
  return Jac{fe_load<Fp>(x, stride, i), fe_load<Fp>(y, stride, i),
             fe_load<Fp>(z, stride, i)};
}

__device__ __forceinline__ void store_point(uint32_t* x, uint32_t* y, uint32_t* z,
                                            long long stride, long long i,
                                            const Jac& p) {
  fe_store<Fp>(x, stride, i, p.x);
  fe_store<Fp>(y, stride, i, p.y);
  fe_store<Fp>(z, stride, i, p.z);
}

// dbl-2009-l (a = 0): 2M + 5S. Out of line: it is the rare branch of add
// and madd, and inlining it there would double their code.
__device__ __noinline__ Jac dbl(const Jac& p) {
  const FpE a = sqr(p.x);
  const FpE b = sqr(p.y);
  const FpE c = sqr(b);
  const FpE t = sqr(add(p.x, b));
  FpE d = sub(sub(t, a), c);
  d = add(d, d);
  const FpE e = add(add(a, a), a);
  const FpE ff = sqr(e);
  Jac out;
  out.x = sub(ff, add(d, d));
  FpE c8 = add(c, c);
  c8 = add(c8, c8);
  c8 = add(c8, c8);
  out.y = sub(mul(e, sub(d, out.x)), c8);
  const FpE yz = mul(p.y, p.z);
  out.z = add(yz, yz);
  return out;
}

// add-2007-bl with the exceptional cases of pallas_ops.py:158-196:
// P == Q -> dbl(P); P == -Q -> infinity; an infinite operand passes the
// other one through.
__device__ __forceinline__ Jac add_pts(const Jac& p, const Jac& q) {
  const FpE z1z1 = sqr(p.z);
  const FpE z2z2 = sqr(q.z);
  const FpE u1 = mul(p.x, z2z2);
  const FpE u2 = mul(q.x, z1z1);
  const FpE s1 = mul(p.y, mul(q.z, z2z2));
  const FpE s2 = mul(q.y, mul(p.z, z1z1));
  const FpE h = sub(u2, u1);
  const FpE i = sqr(add(h, h));
  const FpE j = mul(h, i);
  FpE r = sub(s2, s1);
  r = add(r, r);
  const FpE v = mul(u1, i);
  Jac out;
  out.x = sub(sub(sqr(r), j), add(v, v));
  const FpE s1j = mul(s1, j);
  out.y = sub(mul(r, sub(v, out.x)), add(s1j, s1j));
  const FpE zz = sub(sub(sqr(add(p.z, q.z)), z1z1), z2z2);
  out.z = mul(zz, h);
  if (is_zero(p.z)) return q;
  if (is_zero(q.z)) return p;
  if (is_zero(h)) return is_zero(r) ? dbl(p) : infinity();
  return out;
}

// madd-2007-bl: Jacobian p + affine (x2, y2), with the exceptional cases
// of pallas_ops.py:122-156 for a live lane (p infinite -> (x2, y2, 1)).
__device__ __forceinline__ Jac madd(const Jac& p, const FpE& x2, const FpE& y2) {
  const FpE z1z1 = sqr(p.z);
  const FpE u2 = mul(x2, z1z1);
  const FpE s2 = mul(y2, mul(p.z, z1z1));
  const FpE h = sub(u2, p.x);
  const FpE hh = sqr(h);
  FpE i = add(hh, hh);
  i = add(i, i);
  const FpE j = mul(h, i);
  FpE r = sub(s2, p.y);
  r = add(r, r);
  const FpE v = mul(p.x, i);
  Jac out;
  out.x = sub(sub(sqr(r), j), add(v, v));
  const FpE y1j = mul(p.y, j);
  out.y = sub(mul(r, sub(v, out.x)), add(y1j, y1j));
  out.z = sub(sub(sqr(add(p.z, h)), z1z1), hh);
  if (is_zero(p.z)) return Jac{x2, y2, fe_one<Fp>()};
  if (is_zero(h)) return is_zero(r) ? dbl(p) : infinity();
  return out;
}

constexpr int kPointThreads = 128;

__global__ void __launch_bounds__(kPointThreads)
g1_add_kernel(uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
              uint32_t* __restrict__ oz, const uint32_t* __restrict__ x1,
              const uint32_t* __restrict__ y1, const uint32_t* __restrict__ z1,
              const uint32_t* __restrict__ x2, const uint32_t* __restrict__ y2,
              const uint32_t* __restrict__ z2, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Jac p = load_point(x1, y1, z1, n, i);
  const Jac q = load_point(x2, y2, z2, n, i);
  store_point(ox, oy, oz, n, i, add_pts(p, q));
}

__global__ void __launch_bounds__(kPointThreads)
g1_dbl_kernel(uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
              uint32_t* __restrict__ oz, const uint32_t* __restrict__ x,
              const uint32_t* __restrict__ y, const uint32_t* __restrict__ z,
              long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  store_point(ox, oy, oz, n, i, dbl(load_point(x, y, z, n, i)));
}

// rows: (n, 24) words, point k's x then y; order: (W, n) sort order per
// window; start / count: (W, B); outputs (12, W * B).
__global__ void __launch_bounds__(kPointThreads)
bucket_accumulate_kernel(uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                         uint32_t* __restrict__ oz, const uint32_t* __restrict__ rows,
                         const int32_t* __restrict__ order,
                         const int32_t* __restrict__ start,
                         const int32_t* __restrict__ count, int windows, int buckets,
                         long long n) {
  const long long total = (long long)windows * buckets;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int32_t* ord = order + (t / buckets) * n;
  const int s = start[t];
  const int c = count[t];
  Jac acc = infinity();
  for (int k = 0; k < c; k++) {
    const uint4* row = reinterpret_cast<const uint4*>(rows + (long long)ord[s + k] * (2 * kW));
    FpE q[2];
#pragma unroll
    for (int v = 0; v < 6; v++) {
      const uint4 u = __ldg(row + v);
      uint32_t* dst = &q[v / 3].w[(v % 3) * 4];
      dst[0] = u.x;
      dst[1] = u.y;
      dst[2] = u.z;
      dst[3] = u.w;
    }
    acc = madd(acc, q[0], q[1]);
  }
  store_point(ox, oy, oz, total, t, acc);
}

// s*: (12, W) window sums; out: (12,) one point
__global__ void horner_join_kernel(uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                                   uint32_t* __restrict__ oz,
                                   const uint32_t* __restrict__ sx,
                                   const uint32_t* __restrict__ sy,
                                   const uint32_t* __restrict__ sz, int windows, int c) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  Jac acc = infinity();
  for (int i = windows - 1; i >= 0; i--) {
    for (int k = 0; k < c; k++) {
      if (!is_zero(acc.z)) acc = dbl(acc);  // keep infinity fixed
    }
    acc = add_pts(acc, load_point(sx, sy, sz, windows, i));
  }
  store_point(ox, oy, oz, 1, 0, acc);
}

inline unsigned blocks_for(long long n) {
  return (unsigned)((n + kPointThreads - 1) / kPointThreads);
}

}  // namespace

extern "C" {

int kzg_g1_add(void* ox, void* oy, void* oz, const void* x1, const void* y1,
               const void* z1, const void* x2, const void* y2, const void* z2,
               long long n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  g1_add_kernel<<<blocks_for(n), kPointThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(ox), static_cast<uint32_t*>(oy), static_cast<uint32_t*>(oz),
      static_cast<const uint32_t*>(x1), static_cast<const uint32_t*>(y1),
      static_cast<const uint32_t*>(z1), static_cast<const uint32_t*>(x2),
      static_cast<const uint32_t*>(y2), static_cast<const uint32_t*>(z2), n);
  return (int)cudaGetLastError();
}

int kzg_g1_dbl(void* ox, void* oy, void* oz, const void* x, const void* y,
               const void* z, long long n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  g1_dbl_kernel<<<blocks_for(n), kPointThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(ox), static_cast<uint32_t*>(oy), static_cast<uint32_t*>(oz),
      static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(y),
      static_cast<const uint32_t*>(z), n);
  return (int)cudaGetLastError();
}

int kzg_g1_bucket_accumulate(void* ox, void* oy, void* oz, const void* rows,
                             const void* order, const void* start, const void* count,
                             int windows, int buckets, long long n, void* stream) {
  const long long total = (long long)windows * buckets;
  if (total <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  bucket_accumulate_kernel<<<blocks_for(total), kPointThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(ox), static_cast<uint32_t*>(oy), static_cast<uint32_t*>(oz),
      static_cast<const uint32_t*>(rows), static_cast<const int32_t*>(order),
      static_cast<const int32_t*>(start), static_cast<const int32_t*>(count), windows,
      buckets, n);
  return (int)cudaGetLastError();
}

int kzg_g1_horner_join(void* ox, void* oy, void* oz, const void* sx, const void* sy,
                       const void* sz, int windows, int c, void* stream) {
  if (windows <= 0 || c <= 0) return (int)cudaErrorInvalidValue;
  horner_join_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(ox), static_cast<uint32_t*>(oy), static_cast<uint32_t*>(oz),
      static_cast<const uint32_t*>(sx), static_cast<const uint32_t*>(sy),
      static_cast<const uint32_t*>(sz), windows, c);
  return (int)cudaGetLastError();
}

}  // extern "C"
