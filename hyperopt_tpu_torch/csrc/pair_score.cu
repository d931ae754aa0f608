// Batched TPE pair score on Hopper (sm_90a):
//
//   out[l, c] = LSE_{j < Kb} (F_c . P[l, :, j]) - LSE_{j >= Kb} (F_c . P[l, :, j])
//   F_c = [z[l, c]^2, z[l, c], 1],  P[l] = [3, K] from ops.score.pair_params
//
// Replaces the TPU kernel hyperopt_tpu/ops/pallas_gmm.py::_kernel_batched
// (launched by _pair_score_pallas_batched), and at L=1 its single-label
// _kernel (launched by _pair_score_pallas), with the same values, not the
// same blocking.  Each (candidate, component) cell is the quadratic as two
// IEEE f32 FMAs on the CUDA cores (no tensor cores, no TF32: the
// contraction depth is 3), then one step of a chunked logsumexp.
//
// What bounds it: the SFU, not bytes and not the FP32 pipes.  It reads
// O(L*(C + K)) floats (~0.5 MB at the main-path shape L=2, C=8192,
// K=16418) and does L*C*K = 2.69e8 cells, each with one exp.  MUFU.EX2
// returns 16 results per SM per clock: 0.064 ms at 1.98 GHz on 132 SMs,
// against 0.032 ms for the cells' 8 f32 operations at 67 TFLOP/s.
//
// What the design does about it (pair_lse.cuh has the loop):
// - a cell costs 7.7 issue slots and 1.125 exps, so the SFU, not the
//   schedulers' issue rate, is the limit it aims at: the lane takes the max
//   of a chunk of 8 components before any exp, so there is no select
//   chain, and it rescales its sum once per chunk;
// - each lane holds CPW candidates in registers and walks its own
//   components of the shared-memory tile, so three float4 reads of P feed
//   4 x CPW cells, and CPW independent chains hide the SFU latency;
// - one block per SM holds the whole label block P in a shared-memory
//   ring (216 KB) filled by cp.async on mbarriers, so the 16 warps never
//   meet at a block barrier (the per-tile barriers of a two-stage ring
//   cost 8-9% at the main shape, PERF.md);
// - the lanes' (max, sum) pairs merge with one exp per candidate and region;
// - the launch picks CPW so the grid fills the card at every L: 8 at L=2
//   (128 blocks of 128 candidates at the main-path shape), 4 at L=1 (128
//   blocks of 64).
// A score's bits do not depend on CPW, L or the block (pair_lse.cuh), so
// the L=1 launch and row 0 of an L=2 launch agree bit for bit, and the
// fused kernel (fused_suggest.cu) reproduces them.
// The running max starts at NEG_BIG (-1e30), not -inf: a padding column
// (logcoef NEG_BIG) or a product that overflows to -inf then adds zero
// mass instead of NaN.  Ragged edges of C and of both regions of K are
// handled here; nothing is padded in device memory.
//
// The partials launch (pair_lse_partials_launch) is one mesh shard's step
// (parallel/sharding.py, the counterpart of the reference's shard_map
// scorer, hyperopt_tpu/parallel/sharding.py:345): the same loop, with each
// region's logsumexp written to out[2, L, C] in place of their difference,
// so shards of the component axis can be combined by a max and a sum.
//
// Plain C interface for ctypes: each launch function returns the
// cudaError_t of cudaGetLastError() after the launch.  It launches on the
// stream it is given, allocates nothing and does not synchronise.

#include <cuda_runtime.h>

#include "pair_lse.cuh"

namespace {

using namespace pair_lse;

// PARTIALS: out is [2, L, C], each region's logsumexp (the per-shard
// partials of the mesh scorer) in place of their difference ([L, C])
template <int CPW, bool PARTIALS>
__global__ void __launch_bounds__(THREADS, 1)
pair_score_kernel(const float* __restrict__ z, const float* __restrict__ params,
                  float* __restrict__ out, int C, int K, int k_below) {
  extern __shared__ __align__(16) float ring[];  // RING_BYTES
  __shared__ RingBarriers bar;
  const int l = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c0 = (blockIdx.x * WARPS + warp) * CPW;
  const float* zl = z + static_cast<size_t>(l) * C;
  const float* pl = params + static_cast<size_t>(l) * 3 * K;

  float zc[CPW], below[CPW], score[CPW];
#pragma unroll
  for (int c = 0; c < CPW; ++c) zc[c] = (c0 + c < C) ? zl[c0 + c] : 0.0f;
  begin_tiles(pl, K, k_below, ring, bar);  // after the loads of z: not queued behind P's
  pair_region_lses<CPW, PARTIALS>(pl, K, k_below, zc, below, score, ring, bar, lane);
  const size_t row = static_cast<size_t>(l) * C;
  const size_t region = static_cast<size_t>(gridDim.y) * C;
#pragma unroll
  for (int c = 0; c < CPW; ++c) {
    if (lane == c && c0 + c < C) {
      if (PARTIALS) {
        out[row + c0 + c] = below[c];
        out[region + row + c0 + c] = score[c];
      } else {
        out[row + c0 + c] = score[c];
      }
    }
  }
}

template <int CPW, bool PARTIALS>
void launch(const float* z, const float* params, float* out, int L, int C, int K, int k_below,
            cudaStream_t stream) {
  constexpr int TC = WARPS * CPW;
  cudaFuncSetAttribute(pair_score_kernel<CPW, PARTIALS>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, RING_BYTES);
  pair_score_kernel<CPW, PARTIALS><<<dim3((C + TC - 1) / TC, L), THREADS, RING_BYTES, stream>>>(
      z, params, out, C, K, k_below);
}

template <bool PARTIALS>
int launch_cpw(const float* z, const float* params, float* out, int L, int C, int K,
               int k_below, int cpw, cudaStream_t stream) {
  if (cpw == 8) {
    launch<8, PARTIALS>(z, params, out, L, C, K, k_below, stream);
  } else if (cpw == 4) {
    launch<4, PARTIALS>(z, params, out, L, C, K, k_below, stream);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// cpw: candidates per warp, 4 or 8 (the scores are the same bits either way)
extern "C" int pair_score_batched_launch_cpw(const float* z, const float* params, float* out,
                                             int L, int C, int K, int k_below, int cpw,
                                             void* stream) {
  return launch_cpw<false>(z, params, out, L, C, K, k_below, cpw,
                           static_cast<cudaStream_t>(stream));
}

extern "C" int pair_score_batched_launch(const float* z, const float* params, float* out,
                                         int L, int C, int K, int k_below, void* stream) {
  const int cpw = pick_cpw(L * ((C + WARPS * 8 - 1) / (WARPS * 8)));
  return pair_score_batched_launch_cpw(z, params, out, L, C, K, k_below, cpw, stream);
}

// One mesh shard's step (parallel/sharding.py): out [2, L, C] holds
// LSE_{j < Kb} and LSE_{j >= Kb} of each candidate, the same bits as the
// two regions inside pair_score_batched_launch's scores.
extern "C" int pair_lse_partials_launch(const float* z, const float* params, float* out, int L,
                                        int C, int K, int k_below, void* stream) {
  const int cpw = pick_cpw(L * ((C + WARPS * 8 - 1) / (WARPS * 8)));
  return launch_cpw<true>(z, params, out, L, C, K, k_below, cpw,
                          static_cast<cudaStream_t>(stream));
}
