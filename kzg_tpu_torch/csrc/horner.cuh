// Kernel K4, the Pippenger window join, over G1 (Fp) and G2 (Fp2).
//
// Replaces `_PointKernels.horner_join` (kzg_tpu/curve/pallas_ops.py:590,
// launched at :680): sum_w 2^(c w) S_w over W Jacobian window sums, MSB
// window first, c doublings (infinity kept fixed) then one add-2007-bl
// with its exceptional cases a window. One point in, one point out.
//
// Bound: the latency of the chain, not bytes nor throughput. The work is
// W (c + 1) dependent point operations, some 2,200 dependent Fp products
// at the main path's shapes, on 2 W + 1 points of data. A single thread
// walking it runs every product of a doubling one after another, each a
// 144-step serial CIOS, while 31 lanes of its warp and every other SM
// idle.
//
// Design: one block, its warps sharing the accumulator, the window sum and
// every temporary in shared memory (slots of 16 words). The doubling and
// the addition are stages of independent chains of Fp operations
// (horner_schedule.cuh, generated by kzg_tpu_torch/curve/horner_schedule.py):
// a dbl-2009-l is three levels of products over Fp ({X^2, Y^2, Y Z},
// {(2B)^2, X 4B, E^2}, {E (D - X3)}) and three over Fp2, whose Karatsuba
// products run side by side too. Warp k runs chains k, k + warps, ... of
// a stage, a barrier closes the stage. Inside a chain every product, add
// and sub is spread over 16 lanes, one word a lane (coop.cuh), so a
// product's latency is N shuffle-bound steps. The critical path of a
// doubling is three products and six linear steps over Fp, against seven
// products in a row for one thread. The block's branches
// (infinity kept fixed, add's P == Q and P == -Q cases) read whole
// coordinates through __syncthreads_or, so every thread takes the same
// way. Nothing lives in local memory; nothing goes through a call.
//
// Every value is canonical, so the result equals the plain twin
// (CurveOps.window_join) word for word, Jacobian coordinates included.

#pragma once

#include <cuda_runtime.h>

#include "coop.cuh"
#include "horner_schedule.cuh"

namespace {

using kzg::CoopLane;
using kzg::Fp;

constexpr int kSlotWords = 16;

// Runs stages [first, end) of the program: warp w takes chains w,
// w + kWarps, ... of each stage; a half-warp whose `active` is set runs the
// chain's operations in order on the slots at `sm` (K4: lanes 0-15; the
// ladder: each half on its own lane's slots), the others only meet the
// barriers.
template <class Prog>
__device__ __forceinline__ void run_stages(uint32_t* sm, const CoopLane<Fp>& L, int warp,
                                           bool active, int first, int end) {
  for (int st = first; st < end; st++) {
    if (active) {
      for (int ch = Prog::stage(st) + warp; ch < Prog::stage(st + 1); ch += Prog::kWarps) {
        for (int o = Prog::chain(ch); o < Prog::chain(ch + 1); o++) {
          const uint32_t op = Prog::op(o);
          const uint32_t* a = sm + kSlotWords * ((op >> 16) & 0xffu);
          const uint32_t* b = sm + kSlotWords * (op >> 24);
          const uint32_t kind = op & 0xffu;
          uint32_t r;
          if (kind == 0u) {
            r = kzg::coop_mul<Fp>(L, a, b);
          } else if (kind == 1u) {
            r = kzg::coop_add<Fp>(L, a[L.j], b[L.j]);
          } else {
            r = kzg::coop_sub<Fp>(L, a[L.j], b[L.j]);
          }
          sm[kSlotWords * ((op >> 8) & 0xffu) + L.j] = r;
          __syncwarp(L.mask);  // the half's next operation reads every word
        }
      }
    }
    __syncthreads();
  }
}

// Whether the coordinate at `slot` (kComp slots) is non-zero; a barrier.
template <class Prog>
__device__ __forceinline__ bool nonzero(const uint32_t* sm, int slot) {
  const int t = threadIdx.x;
  return __syncthreads_or(t < kSlotWords * Prog::kComp && sm[kSlotWords * slot + t] != 0u);
}

// the three coordinates at src -> dst
template <class Prog>
__device__ __forceinline__ void copy_point(uint32_t* sm, int dst, int src) {
  for (int t = threadIdx.x; t < 3 * Prog::kComp * kSlotWords; t += blockDim.x)
    sm[kSlotWords * dst + t] = sm[kSlotWords * src + t];
  __syncthreads();
}

// the accumulator (X, Y, Z) = (1, 1, 0), Montgomery
template <class Prog>
__device__ __forceinline__ void set_infinity(uint32_t* sm) {
  constexpr int kC = Prog::kComp * kSlotWords;  // words of a coordinate
  for (int t = threadIdx.x; t < 3 * kC; t += blockDim.x) {
    const int w = t % kSlotWords;
    sm[kSlotWords * Prog::kX + t] = (t < 2 * kC && t % kC < kSlotWords && w < Fp::N) ? Fp::one(w)
                                                                                    : 0u;
  }
  __syncthreads();
}

// point i of a (12, W) or (12, 2, W) batch <-> the three coordinates at slot
template <class Prog, bool kStore>
__device__ __forceinline__ void move_point(uint32_t* sm, int slot, uint32_t* x, uint32_t* y,
                                           uint32_t* z, int n, int i) {
  constexpr int kC = Prog::kComp * kSlotWords;
  for (int t = threadIdx.x; t < 3 * kC; t += blockDim.x) {
    const int coord = t / kC, comp = (t % kC) / kSlotWords, w = t % kSlotWords;
    uint32_t* g = (coord == 0 ? x : coord == 1 ? y : z) +
                  (long long)(Prog::kComp * w + comp) * n + i;
    if (kStore) {
      if (w < Fp::N) *g = sm[kSlotWords * slot + t];
    } else {
      sm[kSlotWords * slot + t] = w < Fp::N ? *g : 0u;
    }
  }
  __syncthreads();
}

template <class Prog>
__global__ void __launch_bounds__(32 * Prog::kWarps)
horner_join_kernel(uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                   uint32_t* __restrict__ oz, const uint32_t* __restrict__ sx,
                   const uint32_t* __restrict__ sy, const uint32_t* __restrict__ sz,
                   int windows, int c) {
  __shared__ uint32_t sm[kSlotWords * Prog::kSlots];
  for (int t = threadIdx.x; t < kSlotWords * Prog::kSlots; t += blockDim.x) sm[t] = 0u;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const CoopLane<Fp> L(lane & (kzg::kCoopLanes - 1));
  const bool active = lane < kzg::kCoopLanes;
  constexpr int kDbl = 0, kAdd = Prog::kDblEnd;
  set_infinity<Prog>(sm);
  for (int i = windows - 1; i >= 0; i--) {
    for (int k = 0; k < c && nonzero<Prog>(sm, Prog::kZ); k++)  // infinity stays fixed
      run_stages<Prog>(sm, L, warp, active, kDbl, Prog::kDblEnd);
    move_point<Prog, false>(sm, Prog::kX2, const_cast<uint32_t*>(sx),
                            const_cast<uint32_t*>(sy), const_cast<uint32_t*>(sz), windows, i);
    if (!nonzero<Prog>(sm, Prog::kZ)) {
      copy_point<Prog>(sm, Prog::kX, Prog::kX2);  // infinity + S = S
    } else if (nonzero<Prog>(sm, Prog::kZ2)) {
      run_stages<Prog>(sm, L, warp, active, kAdd, Prog::kAddEnd);
      if (nonzero<Prog>(sm, Prog::kH)) {
        copy_point<Prog>(sm, Prog::kX, Prog::kX3);
      } else if (!nonzero<Prog>(sm, Prog::kR)) {
        run_stages<Prog>(sm, L, warp, active, kDbl, Prog::kDblEnd);  // P == Q: dbl(P)
      } else {
        set_infinity<Prog>(sm);  // P == -Q
      }
    }  // S infinite: the accumulator stays
  }
  move_point<Prog, true>(sm, Prog::kX, ox, oy, oz, 1, 0);
}

template <class Prog>
int launch_horner_join(void* ox, void* oy, void* oz, const void* sx, const void* sy,
                       const void* sz, int windows, int c, void* stream) {
  if (windows <= 0 || c <= 0) return (int)cudaErrorInvalidValue;
  horner_join_kernel<Prog><<<1, 32 * Prog::kWarps, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(ox), static_cast<uint32_t*>(oy), static_cast<uint32_t*>(oz),
      static_cast<const uint32_t*>(sx), static_cast<const uint32_t*>(sy),
      static_cast<const uint32_t*>(sz), windows, c);
  return (int)cudaGetLastError();
}

}  // namespace
