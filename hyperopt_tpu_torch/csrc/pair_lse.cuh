// The pair-score inner loop shared by pair_score.cu and fused_suggest.cu.
//
//   score(z) = LSE_{j < Kb} (F . P[:, j]) - LSE_{j >= Kb} (F . P[:, j]),
//   F = [z^2, z, 1],  P = one label's [3, K] block from ops.score.pair_params
//
// What bounds it on an H100: the exp.  Every (candidate, component) cell
// needs one, and MUFU.EX2 returns 16 results per SM per clock against 128
// FP32 instructions: at 1.98 GHz on 132 SMs the 2.69e8 cells of the
// main-path shape (L=2, C=8192, K=16418) take 0.064 ms of SFU time, twice
// their 0.032 ms at the f32 peak.  A warp's exp occupies its scheduler's
// SFU for 8 clocks, so the loop stays SFU-bound only while a cell costs
// fewer than 8 issue slots, the exp's own slot included.
//
// What the loop does about it, per cell: two FFMA for the quadratic, one
// FMNMX toward the chunk max, and FADD (c - m), FMUL (by log2 e), MUFU.EX2
// (ex2.approx.ftz, one instruction) and FADD into the sum.  No select
// chain: each lane takes the max of its G-component chunk first and
// rescales its running sum once per chunk, so a cell costs 1 + 1/G exps
// and, in the SASS at CPW = 8, 7.7 issue slots (492 instructions per chunk
// of 64 cells) -- under the SFU's 9 clocks per 32 cells.  Measured, the
// loop reaches ~60% of the SFU bound: even with the exp replaced by an
// FFMA it issues in only ~65% of the clocks (PERF.md).  d = c - m is
// one rounded subtraction in natural-log units before the scaling by
// log2 e: folding log2 e into P or into an FFMA with -m*log2e would add a
// rounding of |c| ~ 1e4-1e5 (the quadratic cancels terms that large at
// narrow sigmas), which the tolerance cannot absorb.
//
// Layout and order.  Each region (below, above) is cut into chunks of
// CHUNK = 32*G components from its start; lane l owns components
// 4l + 128i + {0..3} of a chunk, read as float4s from shared memory, so
// three LDS.128 per 4 components feed CPW candidates.  A score's bits
// depend only on the region sizes (fixed by K and Kb), the lane's
// components, the chunk order and the merge below -- never on CPW, WARPS,
// L, the block or the launch.  That is what lets the fused kernel's winner
// equal the argmax over pair_score.cu's scores bit for bit, whichever CPW
// either launch picks.  (The TPU reference shares its _region_logsumexp
// between its two kernels for the same reason:
// hyperopt_tpu/ops/pallas_fused.py:77-84, :180-184.)
//
// Cross-lane merge: the max by an xor butterfly (exact, so every lane gets
// the same bits), one rescale exp per lane, then the sum by an xor
// butterfly (float addition is commutative, so every lane again ends with
// the same bits): one exp per candidate and region instead of five.
//
// Staging: one block per SM, 16 warps, and a ring of STAGES = 18 tiles of
// [3, TK] in 216 KB of shared memory, filled by 4-byte cp.async (rows of P
// start at any float offset, so 16-byte copies would need alignment P
// does not have) that complete on an mbarrier per stage.  At the main
// path's K the whole label block is resident: every tile is copied once,
// the first while the candidates load, and no warp waits for another -- a
// warp waits only for its next tile to land.  A larger K refills a stage
// once every warp is done with it, STAGES/2 tiles ahead.  A tile's ragged
// tail up to its last chunk is padded with (0, 0, -inf) columns, which add
// exactly 0 to the sum and nothing to the max, so nothing is masked in the
// loop.
//
// Every product-and-add is an explicit fmaf: nvcc contracts a*b + c on its
// own (--fmad=true), and might do so differently in the two kernels.

#pragma once

#include <cuda_runtime.h>

namespace pair_lse {

constexpr float NEG_BIG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int WARPS = 16;              // warps per block, one block per SM
constexpr int THREADS = WARPS * 32;
constexpr int G = 8;                   // components per lane per chunk (float4 groups x 4)
constexpr int CHUNK = 32 * G;          // components per warp per chunk
constexpr int TK = 1024;               // components per staged tile, a multiple of CHUNK
// the ring of [3, TK] tiles in dynamic shared memory: 216 KB, all 18 tiles
// of the main path's K = 16418 (1 below, 17 above), so no stage is
// refilled there
constexpr int STAGES = 18;
constexpr int RING_BYTES = STAGES * 3 * TK * static_cast<int>(sizeof(float));
// __launch_bounds__(THREADS, 1) of both kernels: the ring takes the SM's
// shared memory, and 16 warps leave each thread up to 128 registers for the
// CPW candidates' state and a chunk of G quadratics per candidate

// candidates per warp the launch picks: 8 when the grid at 8 keeps three
// quarters of the SMs busy (L=2 at the main path: 128 blocks), else 4
// (L=1), so both fill the card
inline int pick_cpw(int blocks_at_8) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return 4 * blocks_at_8 >= 3 * sms ? 8 : 4;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void mbar_init(unsigned long long* b, unsigned count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;" ::"r"(smem_u32(b)), "r"(count) : "memory");
}

// an arrival that releases this thread's earlier shared-memory stores
__device__ __forceinline__ void mbar_arrive(unsigned long long* b) {
  asm volatile("{\n .reg .b64 st;\n mbarrier.arrive.shared.b64 st, [%0];\n}" ::"r"(smem_u32(b))
               : "memory");
}

// an arrival once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void mbar_arrive_copies(unsigned long long* b) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];" ::"r"(smem_u32(b)) : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* b, unsigned parity) {
  asm volatile(
      "{\n .reg .pred done;\n WAIT%=:\n"
      " mbarrier.try_wait.parity.shared.b64 done, [%0], %1;\n"
      " @!done bra WAIT%=;\n}" ::"r"(smem_u32(b)),
      "r"(parity)
      : "memory");
}

// the tiles of both regions in order: tile g covers components
// [start, start + len) of p's columns
struct Tiles {
  int kb, K, nb, n;
  __device__ Tiles(int K_, int kb_)
      : kb(kb_), K(K_), nb((kb_ + TK - 1) / TK), n(nb + (K_ - kb_ + TK - 1) / TK) {}
  __device__ int start(int g) const { return g < nb ? g * TK : kb + (g - nb) * TK; }
  __device__ int len(int g) const {
    return g < nb ? min(TK, kb - g * TK) : min(TK, K - kb - (g - nb) * TK);
  }
};

// The barriers of the ring's stages, in static shared memory: full[s]
// completes when the tile in stage s has landed (each thread arrives twice
// per fill: once for its stores, once for its copies), empty[s] when every
// warp is done with it.
struct RingBarriers {
  unsigned long long full[STAGES];
  unsigned long long empty[STAGES];
};

// every thread of the block: copy tile g of p ([3, K]) into its stage of
// the ring and pad it with (0, 0, -inf) up to its last chunk; a stage is
// refilled only once every warp is done with its previous tile
__device__ __forceinline__ void fill_tile(const float* __restrict__ p, int K, const Tiles& tl,
                                          int g, float* __restrict__ ring, RingBarriers& bar) {
  const int st = g % STAGES;
  if (g >= STAGES) mbar_wait(&bar.empty[st], (g / STAGES - 1) & 1);
  float* buf = ring + st * 3 * TK;
  const int start = tl.start(g), len = tl.len(g);
  for (int j = threadIdx.x; j < len; j += THREADS) {
    cp_async4(buf + j, p + start + j);
    cp_async4(buf + TK + j, p + K + start + j);
    cp_async4(buf + 2 * TK + j, p + 2 * K + start + j);
  }
  const int padded = (len + CHUNK - 1) / CHUNK * CHUNK;
  for (int j = len + threadIdx.x; j < padded; j += THREADS) {
    buf[j] = 0.0f;
    buf[TK + j] = 0.0f;
    buf[2 * TK + j] = __int_as_float(0xff800000);  // -inf
  }
  mbar_arrive(&bar.full[st]);
  mbar_arrive_copies(&bar.full[st]);
}

// one chunk of this lane's components (the G/4 float4 groups of each row
// at q + 128*h + 4*lane) into each candidate's (m, s)
template <int CPW>
__device__ __forceinline__ void chunk_step(const float* __restrict__ tile, int q, int lane,
                                           const float (&f0)[CPW], const float (&f1)[CPW],
                                           float (&m)[CPW], float (&s)[CPW]) {
  float p0[G], p1[G], p2[G];
#pragma unroll
  for (int h = 0; h < G / 4; ++h) {
    const int j = q + 128 * h + 4 * lane;
    const float4 a = *reinterpret_cast<const float4*>(tile + j);
    const float4 b = *reinterpret_cast<const float4*>(tile + TK + j);
    const float4 c = *reinterpret_cast<const float4*>(tile + 2 * TK + j);
    p0[4 * h] = a.x; p0[4 * h + 1] = a.y; p0[4 * h + 2] = a.z; p0[4 * h + 3] = a.w;
    p1[4 * h] = b.x; p1[4 * h + 1] = b.y; p1[4 * h + 2] = b.z; p1[4 * h + 3] = b.w;
    p2[4 * h] = c.x; p2[4 * h + 1] = c.y; p2[4 * h + 2] = c.z; p2[4 * h + 3] = c.w;
  }
#pragma unroll
  for (int c = 0; c < CPW; ++c) {
    float v[G], mv[G];
#pragma unroll
    for (int g = 0; g < G; ++g) mv[g] = v[g] = fmaf(f0[c], p0[g], fmaf(f1[c], p1[g], p2[g]));
    // the chunk max by a pairwise tree (fmaxf is exact and ignores NaN, so
    // any order gives the same bits)
#pragma unroll
    for (int w = 1; w < G; w *= 2) {
#pragma unroll
      for (int g = 0; g < G; g += 2 * w) mv[g] = fmaxf(mv[g], mv[g + w]);
    }
    const float mx = fmaxf(mv[0], m[c]);
    float e[G];
#pragma unroll
    for (int g = 0; g < G; ++g) e[g] = ex2((v[g] - mx) * LOG2E);
    // the chunk's terms by the same pairwise tree, then into the rescaled sum
#pragma unroll
    for (int w = 1; w < G; w *= 2) {
#pragma unroll
      for (int g = 0; g < G; g += 2 * w) e[g] += e[g + w];
    }
    s[c] = fmaf(s[c], ex2((m[c] - mx) * LOG2E), e[0]);
    m[c] = mx;
  }
}

// the lanes' (m, s) of each candidate merged into its logsumexp, the same
// bits in every lane: max butterfly, one rescale, sum butterfly
template <int CPW>
__device__ __forceinline__ void merge_lanes(const float (&m)[CPW], const float (&s)[CPW],
                                            float (&lse)[CPW]) {
#pragma unroll
  for (int c = 0; c < CPW; ++c) {
    float M = m[c];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
    // __fmul_rn: never contracted with the first add of the butterfly,
    // which would round differently in the two lanes of a pair
    float S = __fmul_rn(s[c], ex2((m[c] - M) * LOG2E));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) S += __shfl_xor_sync(0xffffffffu, S, off);
    lse[c] = M + logf(S);
  }
}

// Starts the copies of one label's block p ([3, K], the first k_below
// components the below mixture) into the ring: the first min(n, STAGES)
// tiles.  Every thread of the block calls it once, then pair_scores with
// the same p, K and k_below; the caller may do other work in between.
// ring: RING_BYTES of shared memory, 16-byte aligned.
__device__ __forceinline__ void begin_tiles(const float* __restrict__ p, int K, int k_below,
                                            float* __restrict__ ring, RingBarriers& bar) {
  const Tiles tl(K, k_below);
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&bar.full[i], 2 * THREADS);
      mbar_init(&bar.empty[i], WARPS);
    }
  }
  __syncthreads();
  for (int g = 0; g < min(tl.n, STAGES); ++g) fill_tile(p, K, tl, g, ring, bar);
}

// Scores of this warp's CPW candidates z against the block begin_tiles
// started.  Every lane gets every score.  The block's warps meet at no
// barrier: each waits only for its tiles to land, and a refill (K beyond
// the ring) waits for every warp to be done with the tile STAGES/2 back.
//
// PARTIALS (pair_score.cu's partials launch, one mesh shard's step): at
// the end of each region its logsumexp is kept as it is, below[c] for the
// first region and score[c] for the second, in place of their difference.
// The loop and the merges are the same instructions either way, so each
// region's logsumexp has the same bits in both modes and a score is
// below[c] - score[c] of the partials launch, bit for bit.
template <int CPW, bool PARTIALS = false>
__device__ __forceinline__ void pair_region_lses(const float* __restrict__ p, int K,
                                                 int k_below, const float (&z)[CPW],
                                                 float (&below)[CPW], float (&score)[CPW],
                                                 float* __restrict__ ring, RingBarriers& bar,
                                                 int lane) {
  float f0[CPW], f1[CPW], m[CPW], s[CPW];
#pragma unroll
  for (int c = 0; c < CPW; ++c) {
    f0[c] = z[c] * z[c];
    f1[c] = z[c];
    m[c] = NEG_BIG;
    s[c] = 0.0f;
  }
  const Tiles tl(K, k_below);
  for (int g = 0; g < tl.n; ++g) {
    if (g >= STAGES / 2 && g + STAGES / 2 < tl.n) {
      fill_tile(p, K, tl, g + STAGES / 2, ring, bar);
    }
    const int st = g % STAGES;
    mbar_wait(&bar.full[st], (g / STAGES) & 1);
    const float* tile = ring + st * 3 * TK;
    const int len = tl.len(g);
#pragma unroll 1
    for (int q = 0; q < len; q += CHUNK) chunk_step<CPW>(tile, q, lane, f0, f1, m, s);
    __syncwarp();
    if (lane == 0) mbar_arrive(&bar.empty[st]);
    if (g == tl.nb - 1 || g == tl.n - 1) {  // the end of a region
      float lse[CPW];
      merge_lanes<CPW>(m, s, lse);
#pragma unroll
      for (int c = 0; c < CPW; ++c) {
        if (g == tl.nb - 1) {
          below[c] = lse[c];
        } else {
          score[c] = PARTIALS ? lse[c] : below[c] - lse[c];
        }
        m[c] = NEG_BIG;
        s[c] = 0.0f;
      }
    }
  }
}

template <int CPW>
__device__ __forceinline__ void pair_scores(const float* __restrict__ p, int K, int k_below,
                                            const float (&z)[CPW], float (&score)[CPW],
                                            float* __restrict__ ring, RingBarriers& bar,
                                            int lane) {
  float below[CPW];
  pair_region_lses<CPW, false>(p, K, k_below, z, below, score, ring, bar, lane);
}

}  // namespace pair_lse
