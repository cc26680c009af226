// The digit ladder (CurveOps.scalar_mul_digits) in one launch, over G1 (Fp)
// and G2 (Fp2): kernel K2's doubling with kernel K6's mixed addition inside.
//
// Replaces the rounds of `_PointKernels.dbl` and `.madd`
// (kzg_tpu/curve/pallas_ops.py:707, :270) that the reference's
// `scalar_mul_digits` (kzg_tpu/curve/ops.py:316-374) launches: for every
// lane, W windows (digits MSB first) of c doublings and one skip-masked
// madd-2007-bl with the affine table entry the lane's digit selects. The
// table of the 2^c - 1 multiples and its affine normalisation stay outside.
//
// Bound: the latency of each lane's chain, W (c dbl + 1 madd) dependent
// point operations, at the ladder's shapes (2^11-2^14 lanes), and the
// product throughput of all lanes once the lanes fill the card. Launched
// op by op, the chain was W (c + 1) launches of one thread a lane, each a
// latency-sized launch of serial CIOS products with the host between them.
//
// Design: K4's engine (horner.cuh), two lanes a block. Each lane's
// accumulator, table entry and temporaries live in shared memory, 16-word
// slots; the doubling and the madd are stages of independent chains of Fp
// operations from the program that kzg_tpu_torch/curve/horner_schedule.py
// generates (horner_schedule.cuh), each product, add and sub over 16 lanes
// (coop.cuh). Warp k runs chains k, k + warps, ... of a stage, its lanes
// 0-15 on the block's first lane and lanes 16-31 on the same chain of the
// second, each half under its own mask: the two halves run the same
// operations on their own slots and stay converged, so every warp
// instruction serves both (one lane a block left lanes 16-31 idle, which
// made the kernel throughput-bound from 2,048 lanes on). The doubling runs
// whatever the accumulator, as the twin does (dbl-2009-l keeps (1, 1, 0)).
// The madd's branches keep the twin's order of precedence, per lane: skip
// (digit 0 or p infinite) -> p; p infinite -> (x2, y2, 1); P == Q -> dbl(p);
// P == -Q -> (1, 1, 0). The madd stages run when either lane adds; they
// write only temporaries and (X3, Y3, Z3), which a lane takes only where
// its own branch says so; the rare doubling of P == Q runs on the half that
// needs it. Digits and masks are read by every thread; coordinates are
// tested through __syncthreads_or, so every thread takes the same way.
//
// Every value is canonical, so the result equals the plain twin word for
// word, Jacobian coordinates included.

#pragma once

#include "pair.cuh"

namespace {

// per block lane h with flags[h] set: table entry t[h] of ladder lane
// i0 + h, from (12[, 2], T, lanes) affine coordinates, -> X2, Y2; with
// take[h] also (X, Y, Z) = (x2, y2, 1), the sum with an infinite accumulator
template <class Prog>
__device__ __forceinline__ void load_entries(uint32_t* sm, int words, const bool* flags,
                                             const bool* take, const int* t,
                                             const uint32_t* tx, const uint32_t* ty,
                                             int entries, long long lanes, long long i0) {
  constexpr int kC = Prog::kComp * kSlotWords;
  for (int k = threadIdx.x; k < kLadderLanes * 3 * kC; k += blockDim.x) {
    const int h = k / (3 * kC), e = k % (3 * kC);
    if (!flags[h]) continue;
    const int coord = e / kC, comp = (e % kC) / kSlotWords, w = e % kSlotWords;
    uint32_t v;
    if (coord < 2) {
      const uint32_t* g = (coord == 0 ? tx : ty) +
                          ((long long)(Prog::kComp * w + comp) * entries + t[h]) * lanes + i0 + h;
      v = w < Fp::N ? *g : 0u;
      sm[h * words + kSlotWords * Prog::kX2 + e] = v;
    } else {
      v = (comp == 0 && w < Fp::N) ? Fp::one(w) : 0u;
    }
    if (take[h]) sm[h * words + kSlotWords * Prog::kX + e] = v;
  }
  __syncthreads();
}

template <class Prog>
__global__ void __launch_bounds__(32 * Prog::kWarps, min_blocks<Prog>())
ladder_kernel(uint32_t* __restrict__ ox, uint32_t* __restrict__ oy, uint32_t* __restrict__ oz,
              const uint32_t* __restrict__ tx, const uint32_t* __restrict__ ty,
              const int32_t* __restrict__ digits, const uint8_t* __restrict__ p_inf,
              int windows, int c, int entries, long long lanes) {
  constexpr int kWords = lane_words<Prog>();
  __shared__ uint32_t smem[kLadderLanes * kWords];
  __shared__ unsigned votes[Prog::kWarps];
  for (int t = threadIdx.x; t < kLadderLanes * kWords; t += blockDim.x) smem[t] = 0u;
  const long long i0 = (long long)blockIdx.x * kLadderLanes;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int half = lane >> 4;  // the block's ladder lane this half-warp works on
  uint32_t* sm = smem + half * kWords;
  const CoopLane<Fp> L(lane, kzg::coop_half_mask(lane));
  bool exists[kLadderLanes], inf[kLadderLanes];
  for (int h = 0; h < kLadderLanes; h++) {
    exists[h] = i0 + h < lanes;
    inf[h] = !exists[h] || p_inf[i0 + h] != 0;  // every multiple of infinity: all skipped
  }
  __syncthreads();
  set_infinities<Prog>(smem, kWords, exists);
  for (int w = 0; w < windows; w++) {
    for (int k = 0; k < c; k++) run_stages<Prog>(sm, L, warp, true, 0, Prog::kDblEnd);
    bool live[kLadderLanes], madd[kLadderLanes], take[kLadderLanes];
    int t[kLadderLanes];
    for (int h = 0; h < kLadderLanes; h++) {
      const int d = inf[h] ? 0 : digits[(long long)w * lanes + i0 + h];
      live[h] = d != 0;
      t[h] = min(max(d - 1, 0), entries - 1);
    }
    if (!live[0] && !live[1]) continue;  // the same in every thread
    const unsigned z = nonzero_bits<Prog>(smem, kWords, Prog::kZ, Prog::kZ, votes);
    for (int h = 0; h < kLadderLanes; h++) {
      madd[h] = live[h] && ((z >> (2 * h)) & 1u);
      take[h] = live[h] && !madd[h];  // infinity + Q = (x2, y2, 1)
    }
    load_entries<Prog>(smem, kWords, live, take, t, tx, ty, entries, lanes, i0);
    if (!madd[0] && !madd[1]) continue;
    run_stages<Prog>(sm, L, warp, true, Prog::kAddEnd, Prog::kMaddEnd);
    bool sum[kLadderLanes], same[kLadderLanes], opposite[kLadderLanes];
    const unsigned hr = nonzero_bits<Prog>(smem, kWords, Prog::kH, Prog::kR, votes);
    for (int h = 0; h < kLadderLanes; h++) {
      const bool h0 = !((hr >> (2 * h)) & 1u), r0 = !((hr >> (2 * h + 1)) & 1u);
      sum[h] = madd[h] && !h0;
      same[h] = madd[h] && h0 && r0;
      opposite[h] = madd[h] && h0 && !r0;
    }
    copy_points<Prog>(smem, kWords, sum, Prog::kX, Prog::kX3);
    if (same[0] || same[1])  // P == Q: dbl(P), on the halves whose lane needs it
      run_stages<Prog>(sm, L, warp, same[half], 0, Prog::kDblEnd);
    if (opposite[0] || opposite[1]) set_infinities<Prog>(smem, kWords, opposite);  // P == -Q
  }
  for (int h = 0; h < kLadderLanes; h++)
    if (exists[h]) move_point<Prog, true>(smem + h * kWords, Prog::kX, ox, oy, oz, (int)lanes,
                                          (int)(i0 + h));
}

template <class Prog>
int launch_ladder(void* ox, void* oy, void* oz, const void* tx, const void* ty,
                  const void* digits, const void* p_inf, int windows, int c, int entries,
                  long long lanes, void* stream) {
  if (windows <= 0 || c <= 0 || c > 16 || entries != (1 << c) - 1 || lanes <= 0 ||
      lanes >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((lanes + kLadderLanes - 1) / kLadderLanes);
  ladder_kernel<Prog><<<blocks, 32 * Prog::kWarps, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(ox), static_cast<uint32_t*>(oy), static_cast<uint32_t*>(oz),
      static_cast<const uint32_t*>(tx), static_cast<const uint32_t*>(ty),
      static_cast<const int32_t*>(digits), static_cast<const uint8_t*>(p_inf), windows, c,
      entries, lanes);
  return (int)cudaGetLastError();
}

}  // namespace
