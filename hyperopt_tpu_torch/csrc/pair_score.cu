// Batched TPE pair score on Hopper (sm_90a):
//
//   out[l, c] = LSE_{j < Kb} (F_c . P[l, :, j]) - LSE_{j >= Kb} (F_c . P[l, :, j])
//   F_c = [z[l, c]^2, z[l, c], 1],  P[l] = [3, K] from ops.score.pair_params
//
// Replaces the TPU kernel hyperopt_tpu/ops/pallas_gmm.py::_kernel_batched
// (launched by _pair_score_pallas_batched) with the same values, not the
// same blocking.  Each (candidate, component) cell is the quadratic as two
// IEEE f32 FMAs on the CUDA cores (no tensor cores, no TF32: the
// contraction depth is 3), then one online logsumexp step.
//
// What bounds it: operations, not bytes.  It reads O(L*(C + K)) floats and
// does O(L*C*K) cells of about 8 operations each (2 FMA for the quadratic;
// subtract, scale, exp, multiply-add or add, compare and select for the
// logsumexp), one of them an exp on the SFU, which issues at 1/8 of the
// FP32 rate.  At the main-path shape (L=2, C=8192, K=16418) that is
// 2.7e8 cells against ~1 MB of input.
//
// What the design does about it:
// - the online logsumexp keeps one exp per cell: with d = c - m it adds
//   exp(-|d|) either to s (d <= 0) or as the new rescale of s (d > 0);
// - every lane holds CPW candidates in registers and walks its own
//   stride of the component axis, so each component value read from shared
//   memory feeds CPW cells, and CPW independent chains hide the SFU and
//   FMA latencies;
// - a block's warps share one 3 x TK tile of P staged in shared memory;
// - the per-lane (m, s) partials merge with warp shuffles at the end of
//   each region, so the grid is (C / (WARPS * CPW), L) blocks: 256 at the
//   main-path shape, about two per SM on 132 SMs.
// The loop itself (pair_scores) lives in pair_lse.cuh, shared with
// fused_suggest.cu so that the two kernels give bit-identical scores.
// The running max starts at NEG_BIG (-1e30), not -inf: a padding column
// (logcoef NEG_BIG) or a product that overflows to -inf then adds zero
// mass instead of NaN.  Ragged edges of C and of both regions of K are
// masked here; nothing is padded to tile multiples.
//
// Plain C interface for ctypes: the launch function returns the
// cudaError_t of cudaGetLastError() after the launch.  It launches on the
// stream it is given, allocates nothing and does not synchronise.

#include <cuda_runtime.h>

#include "pair_lse.cuh"

namespace {

using namespace pair_lse;

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
pair_score_kernel(const float* __restrict__ z, const float* __restrict__ params,
                  float* __restrict__ out, int C, int K, int k_below) {
  __shared__ float tile[3 * TK];
  const int l = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c0 = blockIdx.x * TC + warp * CPW;
  const float* zl = z + static_cast<size_t>(l) * C;

  float zc[CPW], score[CPW];
#pragma unroll
  for (int c = 0; c < CPW; ++c) zc[c] = (c0 + c < C) ? zl[c0 + c] : 0.0f;
  pair_scores(params + static_cast<size_t>(l) * 3 * K, K, k_below, zc, score, tile, lane);
#pragma unroll
  for (int c = 0; c < CPW; ++c) {
    if (lane == c && c0 + c < C) out[static_cast<size_t>(l) * C + c0 + c] = score[c];
  }
}

}  // namespace

extern "C" int pair_score_batched_launch(const float* z, const float* params, float* out,
                                         int L, int C, int K, int k_below, void* stream) {
  const dim3 grid((C + TC - 1) / TC, L);
  pair_score_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      z, params, out, C, K, k_below);
  return static_cast<int>(cudaGetLastError());
}
