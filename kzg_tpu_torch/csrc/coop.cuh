// Montgomery arithmetic spread over the lanes of a warp: the cooperative
// field operations of kernel K4 (horner.cuh) and of K8's cooperative mode.
//
// Lanes 0-15 of a warp work on one element together; lane j owns 32-bit
// word j (words N..15 are zero). A warp may also run two such operations at
// once, one a half-warp (lanes 16-31 then own words 0-15 of the second),
// each half reading its own 16 bits of every vote: under the full-warp mask
// both halves call every function together; under its half's own mask
// (coop_half_mask, as a cooperative-groups tile of 16) a half may also call
// alone, and two halves that run the same function stay converged. Operands of a product sit in shared
// memory, 16 words an element, so a lane reads its own word and every lane
// reads b's word i at step i (one address: a broadcast). Add, sub and the
// final carries are lane-local but for their carry chains, which a warp
// vote resolves at once (carry look-ahead over 16 bits): lane j reports
// whether its word generates a carry and whether it would pass one on, and
// the sum (g | p) + g of the two ballots shows every lane its incoming
// carry. Every result is canonical in [0, p), word for word the value of
// field.cuh's single-thread functions.
//
// The product is CIOS with the accumulator in carry-save form: lane j
// keeps column j as a 64-bit sum of 32-bit halves, lo(a_j b_i) +
// hi(a_{j-1} b_i) + lo(m p_j) + hi(m p_{j-1}), so no column carries until
// the end. Step i: b_i from shared memory; m = column 0 * n' from lane 0 by
// one shuffle (the low word of the whole accumulator is column 0's low
// word); then the accumulator shifts down one word, a second shuffle,
// lane 0 keeping its column's high part. After N steps the columns hold
// T < 2p below 2^38 each: one look-ahead resolves the carries and one more
// the conditional subtraction of p. The latency is N steps of two shuffles
// and a few dependent multiply-adds, against N^2 dependent multiply-adds of
// a one-thread CIOS.

#pragma once

#include "field.cuh"

namespace kzg {

constexpr int kCoopLanes = 16;
constexpr unsigned kCoopMask = 0xffffu;  // lanes 0-15 alone (lanes 16-31 idle)
constexpr unsigned kCoopPairMask = 0xffffffffu;  // both half-warps, each on its own element

// the half-warp of `lane` (0-31) alone
__device__ __forceinline__ unsigned coop_half_mask(int lane) {
  return 0xffffu << (lane & kCoopLanes);
}

// One lane's index in its half-warp, the modulus words its column needs,
// the lanes that call together and the shift of its half's vote bits.
template <class F>
struct CoopLane {
  int j;
  uint32_t pj, pjm;  // p's words j and j - 1, 0 outside [0, N)
  unsigned mask;
  int sh;
  // lane: 0-15 under kCoopMask, 0-31 under kCoopPairMask or coop_half_mask(lane)
  __device__ explicit CoopLane(int lane, unsigned m = kCoopMask)
      : j(lane & (kCoopLanes - 1)),
        pj(j < F::N ? F::mod(j) : 0u),
        pjm(j >= 1 && j - 1 < F::N ? F::mod(j - 1) : 0u),
        mask(m),
        sh(lane & kCoopLanes) {}
};

// The carry (or borrow) into word j of a 16-word sum whose word j
// generates one (gen) or passes an incoming one on (prop); *top gets the
// one out of word 15.
template <class F>
__device__ __forceinline__ uint32_t coop_carry(const CoopLane<F>& L, bool gen, bool prop,
                                               uint32_t* top) {
  const uint32_t g = (__ballot_sync(L.mask, gen) >> L.sh) & 0xffffu;
  const uint32_t a = g | ((__ballot_sync(L.mask, prop) >> L.sh) & 0xffffu);
  const uint32_t s = a + g;
  *top = s >> 16;
  return ((s ^ a ^ g) >> L.j) & 1u;
}

// word j of w mod p, for w < 2p
template <class F>
__device__ __forceinline__ uint32_t coop_reduce(const CoopLane<F>& L, uint32_t w) {
  uint32_t below;  // w < p: the subtraction borrows out of word 15
  const uint32_t b = coop_carry<F>(L, w < L.pj, w == L.pj, &below);
  return below ? w : w - L.pj - b;
}

// word j of a + b mod p, from the operands' words j
template <class F>
__device__ __forceinline__ uint32_t coop_add(const CoopLane<F>& L, uint32_t a, uint32_t b) {
  const uint32_t s = a + b;
  uint32_t top;
  const uint32_t c = coop_carry<F>(L, s < a, s == 0xffffffffu, &top);
  return coop_reduce<F>(L, s + c);
}

// word j of a - b mod p, from the operands' words j
template <class F>
__device__ __forceinline__ uint32_t coop_sub(const CoopLane<F>& L, uint32_t a, uint32_t b) {
  uint32_t neg;
  const uint32_t bw = coop_carry<F>(L, a < b, a == b, &neg);
  uint32_t r = a - b - bw;
  if (neg) {  // a < b (the same in every lane): add p, the carry out of word 15 drops
    const uint32_t s = r + L.pj;
    uint32_t top;
    r = s + coop_carry<F>(L, s < r, s == 0xffffffffu, &top);
  }
  return r;
}

// word j of A * B * 2^(-32 N) mod p; A and B are 16-word elements in
// shared memory (words N..15 zero), read by all 16 lanes
template <class F>
__device__ __forceinline__ uint32_t coop_mul(const CoopLane<F>& L, const uint32_t* A,
                                             const uint32_t* B) {
  const uint32_t aj = A[L.j];
  const uint32_t ajm = L.j ? A[L.j - 1] : 0u;
  uint64_t s = 0;
#pragma unroll
  for (int i = 0; i < F::N; i++) {
    const uint32_t bi = B[i];
    s += (uint64_t)(aj * bi) + __umulhi(ajm, bi);
    const uint32_t m = __shfl_sync(L.mask, (uint32_t)s * F::NPRIME, 0, kCoopLanes);
    s += (uint64_t)(m * L.pj) + __umulhi(m, L.pjm);  // column 0's low word is now 0
    const unsigned long long up = __shfl_down_sync(L.mask, (unsigned long long)s, 1,
                                                   kCoopLanes);
    s = (L.j == kCoopLanes - 1 ? 0ull : up) + (L.j == 0 ? s >> 32 : 0ull);
  }
  // column j's high part moves to column j + 1, then the carries resolve
  const uint32_t hin = __shfl_up_sync(L.mask, (uint32_t)(s >> 32), 1, kCoopLanes);
  const uint64_t u = (uint64_t)(uint32_t)s + (L.j ? hin : 0u);
  const uint32_t w = (uint32_t)u;
  uint32_t top;
  const uint32_t c = coop_carry<F>(L, (u >> 32) != 0u, w == 0xffffffffu, &top);
  return coop_reduce<F>(L, w + c);
}

}  // namespace kzg
