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
// madd_multi_g2_kernels.cu and msm_g2_kernels.cu
// (bucket_accumulate), one nvcc process each, so the long Fp2 compilations
// run side by side. K4, the window join, has a design of its own
// (horner.cuh), as have the narrow modes of K2 (pointwise.cuh) and K7
// (madd_multi.cuh).
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
__device__ __forceinline__ FpE sqr(const FpE& a) { return fe_sqr<Fp>(a); }
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

// dbl-2009-l (a = 0): 2M + 5S.
template <class E>
__device__ __forceinline__ Jac<E> dbl_inline(const Jac<E>& p) {
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

// The same out of line: the rare branch of madd, where inlining it would
// double the code.
template <class E>
__device__ __noinline__ Jac<E> dbl(const Jac<E>& p) {
  return dbl_inline(p);
}

// add-2007-bl with the exceptional cases of pallas_ops.py:158-196:
// P == Q -> dbl(P); P == -Q -> infinity; an infinite operand passes the
// other one through. kInlineDbl: the rare doubling inlined, else a call.
template <class E, bool kInlineDbl = false>
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
  if (is_zero(h)) return is_zero(r) ? (kInlineDbl ? dbl_inline(p) : dbl(p)) : infinity<E>();
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

// K2's wide mode, one thread a point: what cuda_ops launches once the
// points fill the card (the narrow mode, two points a block on 16-lane
// products, is pointwise.cuh). Minimum resident blocks an SM for each
// kernel's __launch_bounds__ and whether add inlines its rare doubling,
// from two runs of bench/pointwise.py on an H100 (700 W; PERF.md), each
// against the kernel as it was (no minimum, the doubling a call) at 2^16,
// 2^18 and 2^20 points. dbl inlines its body (the call's stack frame gone;
// G1 143 registers, G2 255 and 84 B spilled): 17-24 % faster at 2^20. G1
// add inlines the doubling (252 registers, none spilled; 1 or 2 blocks give
// the same code, 3 forces 168 registers and a spill): within the spread of
// two builds of one kernel (+-5 %). G2 add at 3 blocks (168 registers,
// 3,432 B spilled against 255 and 1,352 B): 25-34 % faster at 2^20, 18 %
// at 2^18, 8-9 % slower at 2^16 and slower still below, where the narrow
// mode runs; inlining changes nothing there.
template <class E>
struct K2Wide;

template <>
struct K2Wide<FpE> {
  static constexpr int kAddMinBlocks = 2, kDblMinBlocks = 1;
  static constexpr bool kAddInlineDbl = true;
};

template <>
struct K2Wide<Fp2E> {
  static constexpr int kAddMinBlocks = 3, kDblMinBlocks = 1;
  static constexpr bool kAddInlineDbl = false;
};

template <class E>
__global__ void __launch_bounds__(kPointThreads, K2Wide<E>::kAddMinBlocks)
add_kernel(uint32_t* __restrict__ ox, uint32_t* __restrict__ oy, uint32_t* __restrict__ oz,
           const uint32_t* __restrict__ x1, const uint32_t* __restrict__ y1,
           const uint32_t* __restrict__ z1, const uint32_t* __restrict__ x2,
           const uint32_t* __restrict__ y2, const uint32_t* __restrict__ z2, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Jac<E> p = load_point<E>(x1, y1, z1, n, i);
  const Jac<E> q = load_point<E>(x2, y2, z2, n, i);
  store_point<E>(ox, oy, oz, n, i, add_pts<E, K2Wide<E>::kAddInlineDbl>(p, q));
}

template <class E>
__global__ void __launch_bounds__(kPointThreads, K2Wide<E>::kDblMinBlocks)
dbl_kernel(uint32_t* __restrict__ ox, uint32_t* __restrict__ oy, uint32_t* __restrict__ oz,
           const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
           const uint32_t* __restrict__ z, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  store_point<E>(ox, oy, oz, n, i, dbl_inline(load_point<E>(x, y, z, n, i)));
}

// K7's wide mode, one thread a lane: S skip-masked, optionally negated
// mixed adds per lane, the accumulator held in registers across the steps,
// the fused step of the bucket loop on the launches whose lanes fill the
// card (the narrow mode, two lanes a block on 16-lane products, is
// madd_multi.cuh). a*: the accumulator batch of n lanes; qx / qy: one
// coordinate batch of steps * n affine points, step-major (point s of lane
// i at s * n + i); skip / neg: (steps, n) bytes, skip non-zero leaves the
// lane as it is, neg non-zero adds -q = (x, -y); neg may be null. Each live
// step is `madd` below: skip -> p; p infinite -> (x2, y2, 1); same point ->
// dbl(p); opposite -> infinity.
//
// The sweep of bench/madd_multi.py on an H100 (700 W; PERF.md) kept this
// shape for both groups, against 64-thread blocks, 1-4 resident blocks an
// SM and the next step's point and masks loaded ahead of the madd: the
// look-ahead cost registers and bought nothing (G1 within the spread, G2
// slower with twice the spill), the other shapes were within the spread of
// builds ptxas reports alike, and 3 blocks an SM (168 registers) slower.
template <class E>
__global__ void __launch_bounds__(kPointThreads)
madd_multi_wide_kernel(uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
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
    if (neg && neg[k]) y2 = sub(Coord<E>::zero(), y2);
    acc = madd(acc, Coord<E>::load(qx, total, k), y2);
  }
  store_point<E>(ox, oy, oz, n, i, acc);
}

// K3, one thread per sub-run. rows: (n, 2 * Coord<E>::kWords) words,
// point k's x then y (see the layouts above); order: the flattened (W * n)
// sort order of all windows; pos / len: (m) sub-runs, at most L points each
// (msm.pippenger.split_runs), longest first so a warp's threads run equal
// trip counts. Thread t folds the len[t] points order[pos[t] ...] into an
// accumulator that starts at infinity and writes partial sum t once.
//
// Minimum resident blocks of K3 an SM, for __launch_bounds__ (registers
// <= 65,536 / (128 * blocks) a thread). Timed on an H100 at 1, 2 and 3
// (bench/runs_sweep.py, PERF.md): over Fp, 3 (168 registers, no spill)
// runs the 2^24 commit's shape 2.9 % and the 2^20 witness's 1.5 % faster
// than ptxas's own 197 registers at 1 or 2, and 2-6 % slower at the 2^20
// commit's and at 2^15; over Fp2, 3 spills 1.2 KB and runs 1.8x slower,
// so it keeps 1 (255 registers, 460 B spilled). KZG_K3_MIN_BLOCKS, when
// defined, sets both (the sweep's variants).
template <class E>
struct K3MinBlocks {
#ifdef KZG_K3_MIN_BLOCKS
  static constexpr int value = KZG_K3_MIN_BLOCKS;
#else
  static constexpr int value = Coord<E>::kWords == kW ? 3 : 1;
#endif
};

template <class E>
__global__ void __launch_bounds__(kPointThreads, K3MinBlocks<E>::value)
bucket_accumulate_kernel(uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                         uint32_t* __restrict__ oz, const uint32_t* __restrict__ rows,
                         const int32_t* __restrict__ order, const int32_t* __restrict__ pos,
                         const int32_t* __restrict__ len, long long m) {
  constexpr int kC = Coord<E>::kWords;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= m) return;
  const int32_t* ord = order + pos[t];
  const int c = len[t];
  Jac<E> acc = infinity<E>();
  for (int k = 0; k < c; k++) {
    const uint32_t* row = rows + (long long)ord[k] * (2 * kC);
    const E qx = Coord<E>::load_row(row);
    const E qy = Coord<E>::load_row(row + kC);
    acc = madd(acc, qx, qy);
  }
  store_point<E>(ox, oy, oz, m, t, acc);
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
int launch_madd_multi_wide(void* ox, void* oy, void* oz, const void* ax, const void* ay,
                           const void* az, const void* qx, const void* qy, const void* skip,
                           const void* neg, int steps, long long n, void* stream) {
  if (n <= 0 || steps <= 0) return (int)cudaErrorInvalidValue;
  madd_multi_wide_kernel<E><<<blocks_for(n), kPointThreads, 0,
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
                             const void* order, const void* pos, const void* len, long long m,
                             void* stream) {
  if (m <= 0) return (int)cudaErrorInvalidValue;
  bucket_accumulate_kernel<E><<<blocks_for(m), kPointThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(ox), static_cast<uint32_t*>(oy), static_cast<uint32_t*>(oz),
      static_cast<const uint32_t*>(rows), static_cast<const int32_t*>(order),
      static_cast<const int32_t*>(pos), static_cast<const int32_t*>(len), m);
  return (int)cudaGetLastError();
}

}  // namespace
