// The pair-score inner loop shared by pair_score.cu and fused_suggest.cu.
//
//   score(z) = LSE_{j < Kb} (F . P[:, j]) - LSE_{j >= Kb} (F . P[:, j]),
//   F = [z^2, z, 1],  P = one label's [3, K] block from ops.score.pair_params
//
// Both kernels score a warp's CPW candidates with pair_scores() below, so
// a candidate's score is bit-identical in the two kernels whatever warp,
// block or lane holds it: every lane walks the same components in the same
// order, and the cross-lane merge is commutative, so the butterfly leaves
// the same (max, sum) in every lane.  That identity is what lets the fused
// kernel's winner equal the argmax over pair_score.cu's scores bit for bit.
// (The TPU reference shares its _region_logsumexp between its two kernels
// for the same reason: hyperopt_tpu/ops/pallas_fused.py:77-84, :180-184.)
//
// Every product-and-add is an explicit fmaf: nvcc contracts a*b + c on its
// own (--fmad=true), and might do so differently in the two kernels.

#pragma once

#include <cuda_runtime.h>

namespace pair_lse {

constexpr float NEG_BIG = -1e30f;
constexpr int WARPS = 8;               // warps per block
constexpr int CPW = 8;                 // candidates per warp (per lane, in registers)
constexpr int TC = WARPS * CPW;        // candidates per block
constexpr int THREADS = WARPS * 32;
constexpr int TK = 1024;               // components per shared-memory tile
// __launch_bounds__(THREADS, MIN_BLOCKS) of both kernels: two resident
// blocks per SM are enough for one wave at the main-path shape (256
// blocks), and the register room this leaves (ptxas takes 80 rather than
// the 64 it picks for four blocks) lets it unroll the component loop,
// which is measurably faster on an H100 (PERF.md)
constexpr int MIN_BLOCKS = 2;

// one online logsumexp step: (m, s) <- (max(m, c), s*exp(m-max) + exp(c-max)),
// with one exp per step: exp(-|c - m|) is either the new term or the rescale
__device__ __forceinline__ void lse_push(float& m, float& s, float c) {
  const float d = c - m;
  const float e = __expf(-fabsf(d));
  const bool up = d > 0.0f;
  s = up ? fmaf(s, e, 1.0f) : s + e;
  m = up ? c : m;
}

// merge two (max, sum) states; commutative bit for bit: the state with the
// larger max keeps its sum, only the other one is rescaled (and with equal
// maxes the result is s + s2)
__device__ __forceinline__ void lse_merge(float& m, float& s, float m2, float s2) {
  const bool other_hi = m2 > m;
  const float m_hi = other_hi ? m2 : m;
  const float s_hi = other_hi ? s2 : s;
  const float m_lo = other_hi ? m : m2;
  const float s_lo = other_hi ? s : s2;
  const float e = m_lo == m_hi ? 1.0f : __expf(m_lo - m_hi);
  s = fmaf(s_lo, e, s_hi);
  m = m_hi;
}

// Logsumexp over components [start, start + size) of one label's block p
// ([3, K], row-major) for the CPW candidates of this lane's warp.  Every
// thread of the block calls it with the same start and size.  On return
// every lane holds the same merged (m, s) for each candidate.
__device__ __forceinline__ void region_lse(const float* __restrict__ p, int K, int start,
                                           int size, const float (&f0)[CPW],
                                           const float (&f1)[CPW], float (&m)[CPW],
                                           float (&s)[CPW], float* __restrict__ tile,
                                           int lane) {
#pragma unroll
  for (int c = 0; c < CPW; ++c) {
    m[c] = NEG_BIG;
    s[c] = 0.0f;
  }
  for (int t0 = 0; t0 < size; t0 += TK) {
    const int len = min(TK, size - t0);
    __syncthreads();  // every warp is done with the previous tile
    for (int j = threadIdx.x; j < len; j += THREADS) {
      const int col = start + t0 + j;
      tile[j] = p[col];
      tile[TK + j] = p[K + col];
      tile[2 * TK + j] = p[2 * K + col];
    }
    __syncthreads();
    for (int j = lane; j < len; j += 32) {
      const float p0 = tile[j];
      const float p1 = tile[TK + j];
      const float p2 = tile[2 * TK + j];
#pragma unroll
      for (int c = 0; c < CPW; ++c) {
        lse_push(m[c], s[c], fmaf(f0[c], p0, fmaf(f1[c], p1, p2)));
      }
    }
  }
#pragma unroll
  for (int c = 0; c < CPW; ++c) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[c], off);
      const float s2 = __shfl_xor_sync(0xffffffffu, s[c], off);
      lse_merge(m[c], s[c], m2, s2);
    }
  }
}

// Scores of this warp's CPW candidates z against one label's block p
// ([3, K], the first k_below components the below mixture).  Every lane
// gets every score.  tile: 3 * TK floats of shared memory.
__device__ __forceinline__ void pair_scores(const float* __restrict__ p, int K, int k_below,
                                            const float (&z)[CPW], float (&score)[CPW],
                                            float* __restrict__ tile, int lane) {
  float f0[CPW], f1[CPW];
#pragma unroll
  for (int c = 0; c < CPW; ++c) {
    f0[c] = z[c] * z[c];
    f1[c] = z[c];
  }
  float mb[CPW], sb[CPW], ma[CPW], sa[CPW];
  region_lse(p, K, 0, k_below, f0, f1, mb, sb, tile, lane);
  region_lse(p, K, k_below, K - k_below, f0, f1, ma, sa, tile, lane);
#pragma unroll
  for (int c = 0; c < CPW; ++c) {
    score[c] = (mb[c] + logf(sb[c])) - (ma[c] + logf(sa[c]));
  }
}

}  // namespace pair_lse
