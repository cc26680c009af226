// Montgomery arithmetic over the BLS12-381 fields for the port's kernels.
//
// An element is F::N little-endian 32-bit words in Montgomery form with
// radix 2^(32 N): Fr (N = 8, radix 2^256) and Fp (N = 12, radix 2^384).
// These are the same integers the JAX package holds as 16-bit limbs
// (`kzg_tpu/fields/limb.py`), so results are bit-identical to
// `PallasFieldOps` / `LimbField`: every op returns the canonical value in
// [0, p).
//
// Device memory layout used by every kernel: limb-major (N, n) arrays, word
// l of element i at `l * n + i`, so a warp's loads of one word coalesce.
//
// Multiplication is CIOS (coarsely integrated operand scanning) with
// 32x32->64-bit products and one conditional subtraction. The operands are
// below p and R > 2p for both fields, so the CIOS result is below 2p (with
// at most one carry word) and one subtraction lands it in [0, p).

#pragma once

#include <cstdint>

namespace kzg {

// modulus, R^2 mod p and R mod p (Montgomery one), little-endian words
static __constant__ uint32_t FR_MOD[8] = {
    0x00000001u, 0xffffffffu, 0xfffe5bfeu, 0x53bda402u,
    0x09a1d805u, 0x3339d808u, 0x299d7d48u, 0x73eda753u};
static __constant__ uint32_t FR_R2[8] = {
    0xf3f29c6du, 0xc999e990u, 0x87925c23u, 0x2b6cedcbu,
    0x7254398fu, 0x05d31496u, 0x9f59ff11u, 0x0748d9d9u};
static __constant__ uint32_t FR_ONE[8] = {
    0xfffffffeu, 0x00000001u, 0x00034802u, 0x5884b7fau,
    0xecbc4ff5u, 0x998c4fefu, 0xacc5056fu, 0x1824b159u};

static __constant__ uint32_t FP_MOD[12] = {
    0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu,
    0xf6b0f624u, 0x6730d2a0u, 0xf38512bfu, 0x64774b84u,
    0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};
static __constant__ uint32_t FP_R2[12] = {
    0x1c341746u, 0xf4df1f34u, 0x09d104f1u, 0x0a76e6a6u,
    0x4c95b6d5u, 0x8de5476cu, 0x939d83c0u, 0x67eb88a9u,
    0xb519952du, 0x9a793e85u, 0x92cae3aau, 0x11988fe5u};
static __constant__ uint32_t FP_ONE[12] = {
    0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu,
    0x53c758bau, 0x5f489857u, 0x70525745u, 0x77ce5853u,
    0xa256ec6du, 0x5c071a97u, 0xfa80e493u, 0x15f65ec3u};

// Field tags: word count, n' = -p^-1 mod 2^32, constant accessors.
struct Fr {
  static constexpr int N = 8;
  static constexpr uint32_t NPRIME = 0xffffffffu;
  __device__ static __forceinline__ uint32_t mod(int i) { return FR_MOD[i]; }
  __device__ static __forceinline__ uint32_t one(int i) { return FR_ONE[i]; }
  __device__ static __forceinline__ uint32_t r2(int i) { return FR_R2[i]; }
};

struct Fp {
  static constexpr int N = 12;
  static constexpr uint32_t NPRIME = 0xfffcfffdu;
  __device__ static __forceinline__ uint32_t mod(int i) { return FP_MOD[i]; }
  __device__ static __forceinline__ uint32_t one(int i) { return FP_ONE[i]; }
  __device__ static __forceinline__ uint32_t r2(int i) { return FP_R2[i]; }
};

template <class F>
struct Fe {
  uint32_t w[F::N];
};

template <class F>
__device__ __forceinline__ Fe<F> fe_load(const uint32_t* __restrict__ base,
                                         long long stride, long long i) {
  Fe<F> r;
#pragma unroll
  for (int l = 0; l < F::N; l++) r.w[l] = base[l * stride + i];
  return r;
}

template <class F>
__device__ __forceinline__ void fe_store(uint32_t* __restrict__ base, long long stride,
                                         long long i, const Fe<F>& x) {
#pragma unroll
  for (int l = 0; l < F::N; l++) base[l * stride + i] = x.w[l];
}

template <class F>
__device__ __forceinline__ Fe<F> fe_zero() {
  Fe<F> r;
#pragma unroll
  for (int l = 0; l < F::N; l++) r.w[l] = 0u;
  return r;
}

template <class F>
__device__ __forceinline__ Fe<F> fe_one() {
  Fe<F> r;
#pragma unroll
  for (int l = 0; l < F::N; l++) r.w[l] = F::one(l);
  return r;
}

template <class F>
__device__ __forceinline__ bool fe_is_zero(const Fe<F>& a) {
  uint32_t acc = 0u;
#pragma unroll
  for (int l = 0; l < F::N; l++) acc |= a.w[l];
  return acc == 0u;
}

// t (value below 2p, with `hi` the carry word above t) -> t mod p
template <class F>
__device__ __forceinline__ Fe<F> fe_reduce_once(const uint32_t* t, uint32_t hi) {
  Fe<F> d;
  uint32_t borrow = 0u;
#pragma unroll
  for (int l = 0; l < F::N; l++) {
    uint64_t s = (uint64_t)t[l] - F::mod(l) - borrow;
    d.w[l] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  const bool ge = (hi != 0u) || (borrow == 0u);
  Fe<F> r;
#pragma unroll
  for (int l = 0; l < F::N; l++) r.w[l] = ge ? d.w[l] : t[l];
  return r;
}

template <class F>
__device__ __forceinline__ Fe<F> fe_add(const Fe<F>& a, const Fe<F>& b) {
  uint32_t s[F::N];
  uint32_t carry = 0u;
#pragma unroll
  for (int l = 0; l < F::N; l++) {
    uint64_t t = (uint64_t)a.w[l] + b.w[l] + carry;
    s[l] = (uint32_t)t;
    carry = (uint32_t)(t >> 32);
  }
  return fe_reduce_once<F>(s, carry);
}

template <class F>
__device__ __forceinline__ Fe<F> fe_sub(const Fe<F>& a, const Fe<F>& b) {
  Fe<F> d;
  uint32_t borrow = 0u;
#pragma unroll
  for (int l = 0; l < F::N; l++) {
    uint64_t t = (uint64_t)a.w[l] - b.w[l] - borrow;
    d.w[l] = (uint32_t)t;
    borrow = (uint32_t)(t >> 63);
  }
  const uint32_t mask = 0u - borrow;  // add p back when a < b
  uint32_t carry = 0u;
#pragma unroll
  for (int l = 0; l < F::N; l++) {
    uint64_t t = (uint64_t)d.w[l] + (F::mod(l) & mask) + carry;
    d.w[l] = (uint32_t)t;
    carry = (uint32_t)(t >> 32);
  }
  return d;
}

// a * b * 2^(-32N) mod p (CIOS)
template <class F>
__device__ __forceinline__ Fe<F> fe_mul(const Fe<F>& a, const Fe<F>& b) {
  constexpr int N = F::N;
  uint32_t t[N + 2];
#pragma unroll
  for (int l = 0; l < N + 2; l++) t[l] = 0u;
#pragma unroll
  for (int i = 0; i < N; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < N; j++) {
      uint64_t s = (uint64_t)a.w[j] * b.w[i] + t[j] + c;  // <= 2^64 - 1
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[N] + c;
    t[N] = (uint32_t)s;
    t[N + 1] = (uint32_t)(s >> 32);
    const uint32_t m = t[0] * F::NPRIME;
    s = (uint64_t)m * F::mod(0) + t[0];  // low word becomes 0
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < N; j++) {
      s = (uint64_t)m * F::mod(j) + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[N] + c;
    t[N - 1] = (uint32_t)s;
    t[N] = t[N + 1] + (uint32_t)(s >> 32);
  }
  return fe_reduce_once<F>(t, t[N]);
}

template <class F>
__device__ __forceinline__ Fe<F> fe_sqr(const Fe<F>& a) {
  return fe_mul<F>(a, a);
}

// Fp2 = Fp[u] / (u^2 + 1), c0 + c1 u, the algebra of `PallasFp2Ops`
// (kzg_tpu/fields/pallas_field.py:192-242) and `Fp2Adapter`
// (kzg_tpu/curve/ops.py:70-137): Karatsuba multiplication (3 Fp
// multiplications) and the (a + b)(a - b) square (2). Each component is
// canonical, so results equal the plain twin's word for word.
//
// Device layout (12, 2, n): word l of component c of element i at
// `(2 l + c) n + i`, i.e. one (12, n) plane per component with stride 2n.
struct Fp2E {
  Fe<Fp> c0, c1;
};

__device__ __forceinline__ Fp2E fp2_load(const uint32_t* __restrict__ base, long long n,
                                         long long i) {
  return Fp2E{fe_load<Fp>(base, 2 * n, i), fe_load<Fp>(base + n, 2 * n, i)};
}

__device__ __forceinline__ void fp2_store(uint32_t* __restrict__ base, long long n,
                                          long long i, const Fp2E& x) {
  fe_store<Fp>(base, 2 * n, i, x.c0);
  fe_store<Fp>(base + n, 2 * n, i, x.c1);
}

__device__ __forceinline__ Fp2E fp2_add(const Fp2E& a, const Fp2E& b) {
  return Fp2E{fe_add<Fp>(a.c0, b.c0), fe_add<Fp>(a.c1, b.c1)};
}

__device__ __forceinline__ Fp2E fp2_sub(const Fp2E& a, const Fp2E& b) {
  return Fp2E{fe_sub<Fp>(a.c0, b.c0), fe_sub<Fp>(a.c1, b.c1)};
}

__device__ __forceinline__ Fp2E fp2_mul(const Fp2E& x, const Fp2E& y) {
  const Fe<Fp> ac = fe_mul<Fp>(x.c0, y.c0);
  const Fe<Fp> bd = fe_mul<Fp>(x.c1, y.c1);
  const Fe<Fp> t = fe_mul<Fp>(fe_add<Fp>(x.c0, x.c1), fe_add<Fp>(y.c0, y.c1));
  return Fp2E{fe_sub<Fp>(ac, bd), fe_sub<Fp>(fe_sub<Fp>(t, ac), bd)};
}

__device__ __forceinline__ Fp2E fp2_sqr(const Fp2E& x) {
  const Fe<Fp> re = fe_mul<Fp>(fe_add<Fp>(x.c0, x.c1), fe_sub<Fp>(x.c0, x.c1));
  const Fe<Fp> ab = fe_mul<Fp>(x.c0, x.c1);
  return Fp2E{re, fe_add<Fp>(ab, ab)};
}

__device__ __forceinline__ bool fp2_is_zero(const Fp2E& a) {
  return fe_is_zero<Fp>(a.c0) && fe_is_zero<Fp>(a.c1);
}

}  // namespace kzg
