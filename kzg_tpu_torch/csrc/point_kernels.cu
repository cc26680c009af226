// Kernels K2-K4: the point arithmetic of the Pippenger MSM, G1 and G2.
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
// K2  kzg_g1_add / kzg_g1_dbl     replaces _PointKernels.add / .dbl
//     kzg_g2_add / kzg_g2_dbl     (pallas_ops.py:712,707; ncomp=1 and 2).
//     One thread per point. Bound by field multiplications (add: 11M + 5S,
//     an Fp2 M being 3 Fp M) and registers (two input points and the
//     formula's temporaries: a G2 point is 72 words, so the G2 entries
//     spill to local memory); the rare doubling inside add is a per-thread
//     branch instead of the TPU's whole-tile `lax.cond`. G2 coordinates are
//     (12, 2, n) words, c0 then c1 on axis 1.
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

// constants and the (12, n) / (12, 2, n) device layouts of one coordinate
template <class E>
struct Coord;

template <>
struct Coord<FpE> {
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
  Jac<FpE> acc = infinity<FpE>();
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
  store_point<FpE>(ox, oy, oz, total, t, acc);
}

// s*: (12, W) window sums; out: (12,) one point
__global__ void horner_join_kernel(uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                                   uint32_t* __restrict__ oz,
                                   const uint32_t* __restrict__ sx,
                                   const uint32_t* __restrict__ sy,
                                   const uint32_t* __restrict__ sz, int windows, int c) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  Jac<FpE> acc = infinity<FpE>();
  for (int i = windows - 1; i >= 0; i--) {
    for (int k = 0; k < c; k++) {
      if (!is_zero(acc.z)) acc = dbl(acc);  // keep infinity fixed
    }
    acc = add_pts(acc, load_point<FpE>(sx, sy, sz, windows, i));
  }
  store_point<FpE>(ox, oy, oz, 1, 0, acc);
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

}  // namespace

extern "C" {

// G1: coordinates (12, n) words
int kzg_g1_add(void* ox, void* oy, void* oz, const void* x1, const void* y1,
               const void* z1, const void* x2, const void* y2, const void* z2,
               long long n, void* stream) {
  return launch_add<FpE>(ox, oy, oz, x1, y1, z1, x2, y2, z2, n, stream);
}

int kzg_g1_dbl(void* ox, void* oy, void* oz, const void* x, const void* y,
               const void* z, long long n, void* stream) {
  return launch_dbl<FpE>(ox, oy, oz, x, y, z, n, stream);
}

// G2: coordinates (12, 2, n) words
int kzg_g2_add(void* ox, void* oy, void* oz, const void* x1, const void* y1,
               const void* z1, const void* x2, const void* y2, const void* z2,
               long long n, void* stream) {
  return launch_add<Fp2E>(ox, oy, oz, x1, y1, z1, x2, y2, z2, n, stream);
}

int kzg_g2_dbl(void* ox, void* oy, void* oz, const void* x, const void* y,
               const void* z, long long n, void* stream) {
  return launch_dbl<Fp2E>(ox, oy, oz, x, y, z, n, stream);
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
