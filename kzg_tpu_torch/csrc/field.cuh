// Montgomery arithmetic over the BLS12-381 fields for the port's kernels.
//
// An element is F::N little-endian 32-bit words in Montgomery form with
// radix 2^(32 N): Fr (N = 8, radix 2^256) and Fp (N = 12, radix 2^384).
// These are the same integers the JAX package holds as 16-bit limbs
// (`kzg_tpu/fields/limb.py`), so results are bit-identical to
// `PallasFieldOps` / `LimbField`: every op takes canonical operands in
// [0, p) and returns the canonical value.
//
// Device memory layout used by every kernel: limb-major (N, n) arrays, word
// l of element i at `l * n + i`, so a warp's loads of one word coalesce.
//
// The one-thread body, which K1, K8's one-thread mode, the wide point
// kernels, K3, the NTT and scan kernels and K9 run. What bounds it is the
// integer multiply pipe: one product is 2 N^2 word products (N^2 for the
// product, N^2 for the reduction), and ptxas makes each (lo, hi) pair of
// a chain one IMAD.WIDE.U32(.X), which issues at half the IMAD rate. The
// design:
//   * every add, sub and multiply-add is a PTX carry chain (mad.lo.cc /
//     madc.hi.cc / addc / subc): the carry rides in the flag; the 64-bit
//     sums and shifts this replaced compiled an Fp product to 1,152
//     instructions, the chains to 416 (cuobjdump -sass, PERF.md);
//   * each row of products is split by the parity of the word index into
//     two chains that do not wait on each other (see `row_mad`), merged
//     once a row by the shift that CIOS's division by 2^32 needs anyway;
//   * the product is CIOS (coarsely integrated operand scanning): row i
//     adds a b_i, then m p with m = t_0 n', in N + 1 words (the full
//     product and then one reduction measured no faster and took more
//     registers and instructions);
//   * a square takes N (N + 1) / 2 word products, not N^2 (`fe_sqr`), then
//     the stand-alone reduction `fe_redc`;
//   * the operands are below p and R > 2p for both fields, so the result of
//     either is below 2p and one conditional subtraction, a borrow chain
//     and a select, lands it in [0, p).
// `tests/field_body_model.py` runs the same instructions on numpy words.

#pragma once

#include <cstdint>

namespace kzg {

// The modulus words, little-endian, one list a field: the one-thread body
// takes them as immediates (`F::p`, always at an index the unrolled loops
// make a constant), the 16-lane engine (coop.cuh) and the pairing kernels
// read them at a lane's index from __constant__ memory (`F::mod`). As
// immediates an add or a sub compiles to 8 instructions fewer and a
// product to as many (cuobjdump -sass, PERF.md).
#define KZG_FR_MOD \
  0x00000001u, 0xffffffffu, 0xfffe5bfeu, 0x53bda402u, 0x09a1d805u, 0x3339d808u, 0x299d7d48u, \
      0x73eda753u
#define KZG_FP_MOD                                                                           \
  0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu, 0xf6b0f624u, 0x6730d2a0u, 0xf38512bfu, \
      0x64774b84u, 0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau

// modulus, R^2 mod p and R mod p (Montgomery one), little-endian words
static __constant__ uint32_t FR_MOD[8] = {KZG_FR_MOD};
static __constant__ uint32_t FR_R2[8] = {
    0xf3f29c6du, 0xc999e990u, 0x87925c23u, 0x2b6cedcbu,
    0x7254398fu, 0x05d31496u, 0x9f59ff11u, 0x0748d9d9u};
static __constant__ uint32_t FR_ONE[8] = {
    0xfffffffeu, 0x00000001u, 0x00034802u, 0x5884b7fau,
    0xecbc4ff5u, 0x998c4fefu, 0xacc5056fu, 0x1824b159u};

static __constant__ uint32_t FP_MOD[12] = {KZG_FP_MOD};
static __constant__ uint32_t FP_R2[12] = {
    0x1c341746u, 0xf4df1f34u, 0x09d104f1u, 0x0a76e6a6u,
    0x4c95b6d5u, 0x8de5476cu, 0x939d83c0u, 0x67eb88a9u,
    0xb519952du, 0x9a793e85u, 0x92cae3aau, 0x11988fe5u};
static __constant__ uint32_t FP_ONE[12] = {
    0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu,
    0x53c758bau, 0x5f489857u, 0x70525745u, 0x77ce5853u,
    0xa256ec6du, 0x5c071a97u, 0xfa80e493u, 0x15f65ec3u};

// word i of the list W..., an immediate where i is a constant
template <uint32_t... W>
__device__ __forceinline__ uint32_t word_at(int i) {
  const uint32_t w[] = {W...};
  return w[i];
}

// Field tags: word count, n' = -p^-1 mod 2^32, constant accessors.
struct Fr {
  static constexpr int N = 8;
  static constexpr uint32_t NPRIME = 0xffffffffu;
  __device__ static __forceinline__ uint32_t p(int i) { return word_at<KZG_FR_MOD>(i); }
  __device__ static __forceinline__ uint32_t mod(int i) { return FR_MOD[i]; }
  __device__ static __forceinline__ uint32_t one(int i) { return FR_ONE[i]; }
  __device__ static __forceinline__ uint32_t r2(int i) { return FR_R2[i]; }
};

struct Fp {
  static constexpr int N = 12;
  static constexpr uint32_t NPRIME = 0xfffcfffdu;
  __device__ static __forceinline__ uint32_t p(int i) { return word_at<KZG_FP_MOD>(i); }
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

// ---- PTX carry chains -------------------------------------------------------
//
// One wrapper an instruction; CF is the carry flag (a borrow after sub.cc).
// `.cc` sets CF, the `c` forms (madc, addc, subc) read it. The statements
// are volatile so the compiler keeps them in program order and a flag
// passes from one to the next; no C code between two of a chain touches
// CF (a 32-bit multiply does not).
namespace ptx {

__device__ __forceinline__ uint32_t add_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t addc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t addc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t sub_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t subc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t subc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
// lo(a b) + c, carry out
__device__ __forceinline__ uint32_t mad_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("mad.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
// lo(a b) + c + CF, carry out
__device__ __forceinline__ uint32_t madc_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
// hi(a b) + c + CF, carry out
__device__ __forceinline__ uint32_t madc_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.hi.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
// hi(a b) + c + CF, the chain's last word: no carry out
__device__ __forceinline__ uint32_t madc_hi(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.hi.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}

}  // namespace ptx

// ---- rows of word products, split by the parity of the word index -----------
//
// A row x * b over N words is two sums: the even words' products x_0 b,
// x_2 b, ... whose (lo, hi) pairs tile positions 0 .. N-1 with no overlap,
// and the odd words' x_1 b, x_3 b, ... tiling positions 1 .. N. Each is one
// carry chain of N instructions; the two chains are independent, so the
// integer pipe overlaps them where one chain of 2N would wait on each
// carry. A row helper reads the words x[0], x[2], ... of `x`, a pointer
// or an accessor (`ModWords`): pass x for the even words and `Shifted`
// (x + 1) for the odd ones.

template <class F>
struct ModWords {
  __device__ __forceinline__ uint32_t operator[](int i) const { return F::p(i); }
};

template <class X>
struct Shifted {  // x + 1 for an accessor
  X x;
  __device__ __forceinline__ uint32_t operator[](int i) const { return x[i + 1]; }
};

// acc[0 .. N-1] = x_even * b: products into words known to be zero
template <int N, class X>
__device__ __forceinline__ void row_mul(uint32_t* acc, const X& x, uint32_t b) {
#pragma unroll
  for (int j = 0; j < N; j += 2) {
    acc[j] = x[j] * b;
    acc[j + 1] = __umulhi(x[j], b);
  }
}

// acc[0 .. N-1] += x_even * b; CF = the carry out of word N-1
template <int N, class X>
__device__ __forceinline__ void row_mad(uint32_t* acc, const X& x, uint32_t b) {
  acc[0] = ptx::mad_lo_cc(x[0], b, acc[0]);
  acc[1] = ptx::madc_hi_cc(x[0], b, acc[1]);
#pragma unroll
  for (int j = 2; j < N; j += 2) {
    acc[j] = ptx::madc_lo_cc(x[j], b, acc[j]);
    acc[j + 1] = ptx::madc_hi_cc(x[j], b, acc[j + 1]);
  }
}

// acc[0 .. N-1] = (acc[2 .. N-1], top, 0) + x_even * b + CF: the row that
// also shifts the other chain's words down by two (see fe_mul); the sum
// fits, so the last word has no carry out
template <int N, class X>
__device__ __forceinline__ void row_mad_shift(uint32_t* acc, const X& x, uint32_t b,
                                              uint32_t top) {
#pragma unroll
  for (int j = 0; j < N - 2; j += 2) {
    acc[j] = ptx::madc_lo_cc(x[j], b, acc[j + 2]);
    acc[j + 1] = ptx::madc_hi_cc(x[j], b, acc[j + 3]);
  }
  acc[N - 2] = ptx::madc_lo_cc(x[N - 2], b, top);
  acc[N - 1] = ptx::madc_hi(x[N - 2], b, 0u);
}

// t (value below 2p, with `hi` the carry word above t) -> t mod p: t - p by
// one borrow chain, and hi - borrow is 0 where t >= p and all ones where
// t < p: that mask picks the result with a select, no branch
template <class F>
__device__ __forceinline__ Fe<F> fe_reduce_once(const uint32_t* t, uint32_t hi) {
  Fe<F> d;
  d.w[0] = ptx::sub_cc(t[0], F::p(0));
#pragma unroll
  for (int l = 1; l < F::N; l++) d.w[l] = ptx::subc_cc(t[l], F::p(l));
  const uint32_t mask = ptx::subc(hi, 0u);
  Fe<F> r;
#pragma unroll
  for (int l = 0; l < F::N; l++) r.w[l] = mask ? t[l] : d.w[l];
  return r;
}

template <class F>
__device__ __forceinline__ Fe<F> fe_add(const Fe<F>& a, const Fe<F>& b) {
  uint32_t s[F::N];
  s[0] = ptx::add_cc(a.w[0], b.w[0]);
#pragma unroll
  for (int l = 1; l < F::N; l++) s[l] = ptx::addc_cc(a.w[l], b.w[l]);
  return fe_reduce_once<F>(s, ptx::addc(0u, 0u));
}

// a - b, and p added back under the borrow's mask
template <class F>
__device__ __forceinline__ Fe<F> fe_sub(const Fe<F>& a, const Fe<F>& b) {
  Fe<F> d;
  d.w[0] = ptx::sub_cc(a.w[0], b.w[0]);
#pragma unroll
  for (int l = 1; l < F::N; l++) d.w[l] = ptx::subc_cc(a.w[l], b.w[l]);
  const uint32_t mask = ptx::subc(0u, 0u);
  d.w[0] = ptx::add_cc(d.w[0], F::p(0) & mask);
#pragma unroll
  for (int l = 1; l < F::N - 1; l++) d.w[l] = ptx::addc_cc(d.w[l], F::p(l) & mask);
  d.w[F::N - 1] = ptx::addc(d.w[F::N - 1], F::p(F::N - 1) & mask);
  return d;
}

// One row of CIOS on the split accumulator. `ev` holds words 0 .. N-1 of
// the running value, `od` words 1 .. N. With `first`, both are empty and the
// row's products are written; else the previous row's division by 2^32 is
// done here: ev is the previous row's od (now words 0 .. N-1) and od the
// previous row's ev, whose words 1 .. N-1 now sit at 0 .. N-2: its word 1
// joins ev[0] and the rest move down two places inside the odd chain
// (row_mad_shift). Then m = ev[0] n' and m p is added the same way, which
// clears word 0. The value stays below 2^(32 (N + 1)) (p < 2^(32 N - 1)),
// so no chain carries out of word N.
template <class F, bool kFirst>
__device__ __forceinline__ void cios_row(uint32_t* ev, uint32_t* od, const Fe<F>& a,
                                         uint32_t b) {
  constexpr int N = F::N;
  const Shifted<const uint32_t*> a_odd{a.w};
  if (kFirst) {
    row_mul<N>(od, a_odd, b);
    row_mul<N>(ev, a.w, b);
  } else {
    ev[0] = ptx::add_cc(ev[0], od[1]);
    row_mad_shift<N>(od, a_odd, b, 0u);
    row_mad<N>(ev, a.w, b);
    od[N - 1] = ptx::addc(od[N - 1], 0u);
  }
  const uint32_t m = ev[0] * F::NPRIME;
  row_mad<N>(od, Shifted<ModWords<F>>{{}}, m);
  row_mad<N>(ev, ModWords<F>{}, m);
  od[N - 1] = ptx::addc(od[N - 1], 0u);
}

// a * b * 2^(-32N) mod p: CIOS, N rows, the even and odd accumulators
// trading places each row. Operands below p; the result below 2p goes
// through one conditional subtraction.
template <class F>
__device__ __forceinline__ Fe<F> fe_mul(const Fe<F>& a, const Fe<F>& b) {
  constexpr int N = F::N;
  static_assert(N % 2 == 0, "the split takes an even word count");
  uint32_t ev[N], od[N];
  cios_row<F, true>(ev, od, a, b.w[0]);
  cios_row<F, false>(od, ev, a, b.w[1]);
#pragma unroll
  for (int i = 2; i < N; i += 2) {
    cios_row<F, false>(ev, od, a, b.w[i]);
    cios_row<F, false>(od, ev, a, b.w[i + 1]);
  }
  // the last row's division: ev (words 1 .. N) and od[1 ..] merged
  ev[0] = ptx::add_cc(ev[0], od[1]);
#pragma unroll
  for (int l = 1; l < N - 1; l++) ev[l] = ptx::addc_cc(ev[l], od[l + 1]);
  ev[N - 1] = ptx::addc(ev[N - 1], 0u);
  return fe_reduce_once<F>(ev, 0u);
}

// One round of fe_redc: cios_row with the product left out. `top` is the
// word of T that enters at word N - 1 of the shifted chain.
template <class F>
__device__ __forceinline__ void redc_round(uint32_t* ev, uint32_t* od, uint32_t top) {
  constexpr int N = F::N;
  ev[0] = ptx::add_cc(ev[0], od[1]);
  const uint32_t m = ev[0] * F::NPRIME;
  row_mad_shift<N>(od, Shifted<ModWords<F>>{{}}, m, top);
  row_mad<N>(ev, ModWords<F>{}, m);
  od[N - 1] = ptx::addc(od[N - 1], 0u);
}

// Montgomery reduction of a double-width value: t holds 2N words, T below
// p 2^(32N); returns T 2^(-32N) mod p in [0, p). N rounds of m = ev[0] n'
// on the split accumulator of cios_row, which starts as T's low half; T's
// word N + r - 1 enters round r as the `top` of the shifted chain, and word
// 2N - 1 the last merge. Every partial value stays below 2^(32N) + p, the
// result below 2p.
template <class F>
__device__ __forceinline__ Fe<F> fe_redc(const uint32_t* t) {
  constexpr int N = F::N;
  uint32_t ev[N], od[N];
#pragma unroll
  for (int l = 0; l < N; l++) ev[l] = t[l];
  const uint32_t m = ev[0] * F::NPRIME;
  row_mul<N>(od, Shifted<ModWords<F>>{{}}, m);
  row_mad<N>(ev, ModWords<F>{}, m);
  od[N - 1] = ptx::addc(od[N - 1], 0u);
#pragma unroll
  for (int r = 1; r < N; r += 2) {
    redc_round<F>(od, ev, t[N + r - 1]);
    if (r + 1 < N) redc_round<F>(ev, od, t[N + r]);
  }
  // the last round's division, as in fe_mul, with T's top word
  ev[0] = ptx::add_cc(ev[0], od[1]);
#pragma unroll
  for (int l = 1; l < N - 1; l++) ev[l] = ptx::addc_cc(ev[l], od[l + 1]);
  ev[N - 1] = ptx::addc(ev[N - 1], t[2 * N - 1]);
  return fe_reduce_once<F>(ev, 0u);
}

// acc[s ..] += a_i (a_j, a_{j+2}, ... up to a_{N-1}) at words s = i + j,
// s + 2, ...; the carry into the word above the chain. Row 0 writes into
// zero words, with no chain.
template <int N>
__device__ __forceinline__ void sqr_row(uint32_t* acc, const uint32_t* a, int i, int j) {
  int s = i + j;
  if (i == 0) {
#pragma unroll
    for (; j < N; j += 2, s += 2) {
      acc[s] = a[i] * a[j];
      acc[s + 1] = __umulhi(a[i], a[j]);
    }
    return;
  }
  acc[s] = ptx::mad_lo_cc(a[i], a[j], acc[s]);
  acc[s + 1] = ptx::madc_hi_cc(a[i], a[j], acc[s + 1]);
#pragma unroll
  for (j += 2, s += 2; j < N; j += 2, s += 2) {
    acc[s] = ptx::madc_lo_cc(a[i], a[j], acc[s]);
    acc[s + 1] = ptx::madc_hi_cc(a[i], a[j], acc[s + 1]);
  }
  acc[s] = ptx::addc(acc[s], 0u);
}

// a^2 2^(-32N) mod p with N (N + 1) / 2 word products where fe_mul takes
// N^2. Row i of the off-diagonal part adds a_i a_j, j > i, at word i + j:
// the products with j - i odd start at odd words and go to `o`, the others
// to `e`, each row of each a carry chain whose carry lands in the word
// above it (which holds at most a carry of an earlier row). e + o is the
// sum S of a_i a_j over i < j, S < 2^(64N - 3); 2S by funnel shifts; the
// diagonal a_i^2 at words 2i, 2i + 1 by one chain; then fe_redc.
template <class F>
__device__ __forceinline__ Fe<F> fe_sqr(const Fe<F>& a) {
  constexpr int N = F::N;
  uint32_t e[2 * N], o[2 * N];
#pragma unroll
  for (int l = 0; l < 2 * N; l++) e[l] = o[l] = 0u;
#pragma unroll
  for (int i = 0; i < N - 1; i++) {
    sqr_row<N>(o, a.w, i, i + 1);
    if (i + 2 < N) sqr_row<N>(e, a.w, i, i + 2);
  }
  // S = e + o (o starts at word 1, e at word 2), then 2S
  uint32_t t[2 * N];
  t[0] = 0u;
  t[1] = o[1];
  t[2] = ptx::add_cc(e[2], o[2]);
#pragma unroll
  for (int l = 3; l < 2 * N - 1; l++) t[l] = ptx::addc_cc(e[l], o[l]);
  t[2 * N - 1] = ptx::addc(e[2 * N - 1], o[2 * N - 1]);
#pragma unroll
  for (int l = 2 * N - 1; l > 1; l--) t[l] = __funnelshift_l(t[l - 1], t[l], 1);
  t[1] <<= 1;
  // + the diagonal
  t[0] = ptx::mad_lo_cc(a.w[0], a.w[0], t[0]);
  t[1] = ptx::madc_hi_cc(a.w[0], a.w[0], t[1]);
#pragma unroll
  for (int i = 1; i < N - 1; i++) {
    t[2 * i] = ptx::madc_lo_cc(a.w[i], a.w[i], t[2 * i]);
    t[2 * i + 1] = ptx::madc_hi_cc(a.w[i], a.w[i], t[2 * i + 1]);
  }
  t[2 * N - 2] = ptx::madc_lo_cc(a.w[N - 1], a.w[N - 1], t[2 * N - 2]);
  t[2 * N - 1] = ptx::madc_hi(a.w[N - 1], a.w[N - 1], t[2 * N - 1]);
  return fe_redc<F>(t);
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
