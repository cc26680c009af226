// The point arithmetic shared by the port's point kernels, G1 and G2.
//
// Group law over Fp (G1) and Fp2 (G2) (field.cuh), Jacobian (X, Y, Z) with
// Z == 0 for infinity, written (1, 1, 0) in Montgomery form. The formulas
// and the exceptional-case handling are those of the Pallas kernels
// (kzg_tpu/curve/pallas_ops.py:81-196) and of `CurveOps`
// (kzg_tpu/curve/ops.py:195-283): dbl-2009-l, add-2007-bl, madd-2007-bl
// with a = 0, which never reference the curve's b, so one template over the
// coordinate type serves both groups. Every field value is canonical, so
// outputs equal the plain PyTorch twin (kzg_tpu_torch/curve/ops.py) word
// for word.
//
// This header holds the device functions, the kernel templates and their
// launchers; the C entry points that instantiate them are split over
// point_kernels.cu (G1) and, for G2, point_g2_kernels.cu (add / dbl),
// madd_g2_kernels.cu, madd_multi_g2_kernels.cu, msm_g2_kernels.cu
// (bucket_accumulate) and horner_g2_kernels.cu, one nvcc process each, so
// the long Fp2 compilations run side by side.
//
// Layouts. A G1 coordinate batch is (12, n) words, a G2 one (12, 2, n), c0
// then c1 on axis 1. An affine point ROW (the bucket kernel's input) is
// point i's x words then its y words, contiguous: 24 words (96 bytes) for
// G1; for G2 x.c0, x.c1, y.c0, y.c1, 12 words each, 48 words (192 bytes).

#pragma once

#include <cuda_runtime.h>

#include "field.cuh"

using namespace kzg;

namespace {

using FpE = Fe<Fp>;
constexpr int kW = Fp::N;  // 12 words per Fp coordinate

// ---- coordinate arithmetic, overloaded for Fp (G1) and Fp2 (G2) ----------

__device__ __forceinline__ FpE add(const FpE& a, const FpE& b) { return fe_add<Fp>(a, b); }
__device__ __forceinline__ FpE sub(const FpE& a, const FpE& b) { return fe_sub<Fp>(a, b); }
__device__ __forceinline__ FpE mul(const FpE& a, const FpE& b) { return fe_mul<Fp>(a, b); }
__device__ __forceinline__ FpE sqr(const FpE& a) { return fe_mul<Fp>(a, a); }
__device__ __forceinline__ bool is_zero(const FpE& a) { return fe_is_zero<Fp>(a); }

__device__ __forceinline__ Fp2E add(const Fp2E& a, const Fp2E& b) { return fp2_add(a, b); }
__device__ __forceinline__ Fp2E sub(const Fp2E& a, const Fp2E& b) { return fp2_sub(a, b); }
__device__ __forceinline__ Fp2E mul(const Fp2E& a, const Fp2E& b) { return fp2_mul(a, b); }
__device__ __forceinline__ Fp2E sqr(const Fp2E& a) { return fp2_sqr(a); }
__device__ __forceinline__ bool is_zero(const Fp2E& a) { return fp2_is_zero(a); }

// 12 contiguous, 16-byte aligned words -> one Fp element
__device__ __forceinline__ FpE fe_load_row(const uint32_t* p) {
  const uint4* v = reinterpret_cast<const uint4*>(p);
  FpE r;
#pragma unroll
  for (int k = 0; k < kW / 4; k++) {
    const uint4 u = __ldg(v + k);
    r.w[4 * k + 0] = u.x;
    r.w[4 * k + 1] = u.y;
    r.w[4 * k + 2] = u.z;
    r.w[4 * k + 3] = u.w;
  }
  return r;
}

// constants and the (12, n) / (12, 2, n) device layouts of one coordinate
template <class E>
struct Coord;

template <>
struct Coord<FpE> {
  static constexpr int kWords = kW;
  // 12 contiguous words (three 16-byte loads) of a point row
  __device__ static __forceinline__ FpE load_row(const uint32_t* p) { return fe_load_row(p); }
  __device__ static __forceinline__ FpE one() { return fe_one<Fp>(); }
  __device__ static __forceinline__ FpE zero() { return fe_zero<Fp>(); }
  __device__ static __forceinline__ FpE load(const uint32_t* b, long long n, long long i) {
    return fe_load<Fp>(b, n, i);
  }
  __device__ static __forceinline__ void store(uint32_t* b, long long n, long long i,
                                               const FpE& x) {
    fe_store<Fp>(b, n, i, x);
  }
};

template <>
struct Coord<Fp2E> {
  static constexpr int kWords = 2 * kW;
  // c0 then c1, 24 contiguous words of a point row
  __device__ static __forceinline__ Fp2E load_row(const uint32_t* p) {
    return Fp2E{fe_load_row(p), fe_load_row(p + kW)};
  }
  __device__ static __forceinline__ Fp2E one() { return Fp2E{fe_one<Fp>(), fe_zero<Fp>()}; }
  __device__ static __forceinline__ Fp2E zero() { return Fp2E{fe_zero<Fp>(), fe_zero<Fp>()}; }
  __device__ static __forceinline__ Fp2E load(const uint32_t* b, long long n, long long i) {
    return fp2_load(b, n, i);
  }
  __device__ static __forceinline__ void store(uint32_t* b, long long n, long long i,
                                               const Fp2E& x) {
    fp2_store(b, n, i, x);
  }
};

template <class E>
struct Jac {
  E x, y, z;
};

template <class E>
__device__ __forceinline__ Jac<E> infinity() {
  return Jac<E>{Coord<E>::one(), Coord<E>::one(), Coord<E>::zero()};
}

template <class E>
__device__ __forceinline__ Jac<E> load_point(const uint32_t* x, const uint32_t* y,
                                             const uint32_t* z, long long n, long long i) {
  return Jac<E>{Coord<E>::load(x, n, i), Coord<E>::load(y, n, i), Coord<E>::load(z, n, i)};
}

template <class E>
__device__ __forceinline__ void store_point(uint32_t* x, uint32_t* y, uint32_t* z,
                                            long long n, long long i, const Jac<E>& p) {
  Coord<E>::store(x, n, i, p.x);
  Coord<E>::store(y, n, i, p.y);
  Coord<E>::store(z, n, i, p.z);
}

// dbl-2009-l (a = 0): 2M + 5S. Out of line: it is the rare branch of add
// and madd, and inlining it there would double their code.
template <class E>
__device__ __noinline__ Jac<E> dbl(const Jac<E>& p) {
  const E a = sqr(p.x);
  const E b = sqr(p.y);
  const E c = sqr(b);
  const E t = sqr(add(p.x, b));
  E d = sub(sub(t, a), c);
  d = add(d, d);
  const E e = add(add(a, a), a);
  const E ff = sqr(e);
  Jac<E> out;
  out.x = sub(ff, add(d, d));
  E c8 = add(c, c);
  c8 = add(c8, c8);
  c8 = add(c8, c8);
  out.y = sub(mul(e, sub(d, out.x)), c8);
  const E yz = mul(p.y, p.z);
  out.z = add(yz, yz);
  return out;
}

// add-2007-bl with the exceptional cases of pallas_ops.py:158-196:
// P == Q -> dbl(P); P == -Q -> infinity; an infinite operand passes the
// other one through.
template <class E>
__device__ __forceinline__ Jac<E> add_pts(const Jac<E>& p, const Jac<E>& q) {
  const E z1z1 = sqr(p.z);
  const E z2z2 = sqr(q.z);
  const E u1 = mul(p.x, z2z2);
  const E u2 = mul(q.x, z1z1);
  const E s1 = mul(p.y, mul(q.z, z2z2));
  const E s2 = mul(q.y, mul(p.z, z1z1));
  const E h = sub(u2, u1);
  const E i = sqr(add(h, h));
  const E j = mul(h, i);
  E r = sub(s2, s1);
  r = add(r, r);
  const E v = mul(u1, i);
  Jac<E> out;
  out.x = sub(sub(sqr(r), j), add(v, v));
  const E s1j = mul(s1, j);
  out.y = sub(mul(r, sub(v, out.x)), add(s1j, s1j));
  const E zz = sub(sub(sqr(add(p.z, q.z)), z1z1), z2z2);
  out.z = mul(zz, h);
  if (is_zero(p.z)) return q;
  if (is_zero(q.z)) return p;
  if (is_zero(h)) return is_zero(r) ? dbl(p) : infinity<E>();
  return out;
}

// madd-2007-bl: Jacobian p + affine (x2, y2), with the exceptional cases
// of pallas_ops.py:122-156 for a live lane (p infinite -> (x2, y2, 1)).
template <class E>
__device__ __forceinline__ Jac<E> madd(const Jac<E>& p, const E& x2, const E& y2) {
  const E z1z1 = sqr(p.z);
  const E u2 = mul(x2, z1z1);
  const E s2 = mul(y2, mul(p.z, z1z1));
  const E h = sub(u2, p.x);
  const E hh = sqr(h);
  E i = add(hh, hh);
  i = add(i, i);
  const E j = mul(h, i);
  E r = sub(s2, p.y);
  r = add(r, r);
  const E v = mul(p.x, i);
  Jac<E> out;
  out.x = sub(sub(sqr(r), j), add(v, v));
  const E y1j = mul(p.y, j);
  out.y = sub(mul(r, sub(v, out.x)), add(y1j, y1j));
  out.z = sub(sub(sqr(add(p.z, h)), z1z1), hh);
  if (is_zero(p.z)) return Jac<E>{x2, y2, Coord<E>::one()};
  if (is_zero(h)) return is_zero(r) ? dbl(p) : infinity<E>();
  return out;
}

constexpr int kPointThreads = 128;

template <class E>
__global__ void __launch_bounds__(kPointThreads)
add_kernel(uint32_t* __restrict__ ox, uint32_t* __restrict__ oy, uint32_t* __restrict__ oz,
           const uint32_t* __restrict__ x1, const uint32_t* __restrict__ y1,
           const uint32_t* __restrict__ z1, const uint32_t* __restrict__ x2,
           const uint32_t* __restrict__ y2, const uint32_t* __restrict__ z2, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Jac<E> p = load_point<E>(x1, y1, z1, n, i);
  const Jac<E> q = load_point<E>(x2, y2, z2, n, i);
  store_point<E>(ox, oy, oz, n, i, add_pts(p, q));
}

template <class E>
__global__ void __launch_bounds__(kPointThreads)
dbl_kernel(uint32_t* __restrict__ ox, uint32_t* __restrict__ oy, uint32_t* __restrict__ oz,
           const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
           const uint32_t* __restrict__ z, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  store_point<E>(ox, oy, oz, n, i, dbl(load_point<E>(x, y, z, n, i)));
}

// Jacobian p + affine q with a skip mask (1 = keep p): the standalone
// madd entry. Precedence as CurveOps.madd: skip -> p; p infinite ->
// (x2, y2, 1); same point -> dbl(p); opposite -> infinity.
template <class E>
__global__ void __launch_bounds__(kPointThreads)
madd_kernel(uint32_t* __restrict__ ox, uint32_t* __restrict__ oy, uint32_t* __restrict__ oz,
            const uint32_t* __restrict__ x1, const uint32_t* __restrict__ y1,
            const uint32_t* __restrict__ z1, const uint32_t* __restrict__ x2,
            const uint32_t* __restrict__ y2, const uint8_t* __restrict__ skip, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Jac<E> p = load_point<E>(x1, y1, z1, n, i);
  if (skip[i]) {
    store_point<E>(ox, oy, oz, n, i, p);
    return;
  }
  store_point<E>(ox, oy, oz, n, i,
                 madd(p, Coord<E>::load(x2, n, i), Coord<E>::load(y2, n, i)));
}

// S masked, optionally negated mixed adds per lane, the accumulator held in
// registers across the steps: the fused step of the bucket loop.
// a*: the accumulator batch of n lanes; qx / qy: one coordinate batch of
// steps * n affine points, step-major (point s of lane i at s * n + i);
// skip / neg: (steps, n) bytes, skip non-zero leaves the lane as it is,
// neg non-zero adds -q = (x, -y). Each live step as madd_kernel.
template <class E>
__global__ void __launch_bounds__(kPointThreads)
madd_multi_kernel(uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                  uint32_t* __restrict__ oz, const uint32_t* __restrict__ ax,
                  const uint32_t* __restrict__ ay, const uint32_t* __restrict__ az,
                  const uint32_t* __restrict__ qx, const uint32_t* __restrict__ qy,
                  const uint8_t* __restrict__ skip, const uint8_t* __restrict__ neg,
                  int steps, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long total = (long long)steps * n;
  Jac<E> acc = load_point<E>(ax, ay, az, n, i);
  for (int s = 0; s < steps; s++) {
    const long long k = (long long)s * n + i;
    if (skip[k]) continue;
    E y2 = Coord<E>::load(qy, total, k);
    if (neg[k]) y2 = sub(Coord<E>::zero(), y2);  // 0 stays 0
    acc = madd(acc, Coord<E>::load(qx, total, k), y2);
  }
  store_point<E>(ox, oy, oz, n, i, acc);
}

// rows: (n, 2 * Coord<E>::kWords) words, point k's x then y (see the
// layouts above); order: (W, n) sort order per window; start / count:
// (W, B); outputs one coordinate batch of W * B points each. A thread with
// count 0 writes infinity.
template <class E>
__global__ void __launch_bounds__(kPointThreads)
bucket_accumulate_kernel(uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                         uint32_t* __restrict__ oz, const uint32_t* __restrict__ rows,
                         const int32_t* __restrict__ order,
                         const int32_t* __restrict__ start,
                         const int32_t* __restrict__ count, int windows, int buckets,
                         long long n) {
  constexpr int kC = Coord<E>::kWords;
  const long long total = (long long)windows * buckets;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int32_t* ord = order + (t / buckets) * n;
  const int s = start[t];
  const int c = count[t];
  Jac<E> acc = infinity<E>();
  for (int k = 0; k < c; k++) {
    const uint32_t* row = rows + (long long)ord[s + k] * (2 * kC);
    const E qx = Coord<E>::load_row(row);
    const E qy = Coord<E>::load_row(row + kC);
    acc = madd(acc, qx, qy);
  }
  store_point<E>(ox, oy, oz, total, t, acc);
}

// s*: one coordinate batch of W window sums each; out: one point. MSB
// window first: c doublings (infinity kept fixed) then one full add.
template <class E>
__global__ void horner_join_kernel(uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                                   uint32_t* __restrict__ oz,
                                   const uint32_t* __restrict__ sx,
                                   const uint32_t* __restrict__ sy,
                                   const uint32_t* __restrict__ sz, int windows, int c) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  Jac<E> acc = infinity<E>();
  for (int i = windows - 1; i >= 0; i--) {
    for (int k = 0; k < c; k++) {
      if (!is_zero(acc.z)) acc = dbl(acc);  // keep infinity fixed
    }
    acc = add_pts(acc, load_point<E>(sx, sy, sz, windows, i));
  }
  store_point<E>(ox, oy, oz, 1, 0, acc);
}

inline unsigned blocks_for(long long n) {
  return (unsigned)((n + kPointThreads - 1) / kPointThreads);
}

template <class E>
int launch_add(void* ox, void* oy, void* oz, const void* x1, const void* y1, const void* z1,
               const void* x2, const void* y2, const void* z2, long long n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  add_kernel<E><<<blocks_for(n), kPointThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(ox), static_cast<uint32_t*>(oy), static_cast<uint32_t*>(oz),
      static_cast<const uint32_t*>(x1), static_cast<const uint32_t*>(y1),
      static_cast<const uint32_t*>(z1), static_cast<const uint32_t*>(x2),
      static_cast<const uint32_t*>(y2), static_cast<const uint32_t*>(z2), n);
  return (int)cudaGetLastError();
}

template <class E>
int launch_dbl(void* ox, void* oy, void* oz, const void* x, const void* y, const void* z,
               long long n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  dbl_kernel<E><<<blocks_for(n), kPointThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(ox), static_cast<uint32_t*>(oy), static_cast<uint32_t*>(oz),
      static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(y),
      static_cast<const uint32_t*>(z), n);
  return (int)cudaGetLastError();
}

template <class E>
int launch_madd(void* ox, void* oy, void* oz, const void* x1, const void* y1, const void* z1,
                const void* x2, const void* y2, const void* skip, long long n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  madd_kernel<E><<<blocks_for(n), kPointThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(ox), static_cast<uint32_t*>(oy), static_cast<uint32_t*>(oz),
      static_cast<const uint32_t*>(x1), static_cast<const uint32_t*>(y1),
      static_cast<const uint32_t*>(z1), static_cast<const uint32_t*>(x2),
      static_cast<const uint32_t*>(y2), static_cast<const uint8_t*>(skip), n);
  return (int)cudaGetLastError();
}

template <class E>
int launch_madd_multi(void* ox, void* oy, void* oz, const void* ax, const void* ay,
                      const void* az, const void* qx, const void* qy, const void* skip,
                      const void* neg, int steps, long long n, void* stream) {
  if (n <= 0 || steps <= 0) return (int)cudaErrorInvalidValue;
  madd_multi_kernel<E><<<blocks_for(n), kPointThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(ox), static_cast<uint32_t*>(oy), static_cast<uint32_t*>(oz),
      static_cast<const uint32_t*>(ax), static_cast<const uint32_t*>(ay),
      static_cast<const uint32_t*>(az), static_cast<const uint32_t*>(qx),
      static_cast<const uint32_t*>(qy), static_cast<const uint8_t*>(skip),
      static_cast<const uint8_t*>(neg), steps, n);
  return (int)cudaGetLastError();
}

template <class E>
int launch_bucket_accumulate(void* ox, void* oy, void* oz, const void* rows,
                             const void* order, const void* start, const void* count,
                             int windows, int buckets, long long n, void* stream) {
  const long long total = (long long)windows * buckets;
  if (total <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  bucket_accumulate_kernel<E><<<blocks_for(total), kPointThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(ox), static_cast<uint32_t*>(oy), static_cast<uint32_t*>(oz),
      static_cast<const uint32_t*>(rows), static_cast<const int32_t*>(order),
      static_cast<const int32_t*>(start), static_cast<const int32_t*>(count), windows,
      buckets, n);
  return (int)cudaGetLastError();
}

template <class E>
int launch_horner_join(void* ox, void* oy, void* oz, const void* sx, const void* sy,
                       const void* sz, int windows, int c, void* stream) {
  if (windows <= 0 || c <= 0) return (int)cudaErrorInvalidValue;
  horner_join_kernel<E><<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(ox), static_cast<uint32_t*>(oy), static_cast<uint32_t*>(oz),
      static_cast<const uint32_t*>(sx), static_cast<const uint32_t*>(sy),
      static_cast<const uint32_t*>(sz), windows, c);
  return (int)cudaGetLastError();
}

}  // namespace
