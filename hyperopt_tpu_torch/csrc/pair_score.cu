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
// The running max starts at NEG_BIG (-1e30), not -inf: a padding column
// (logcoef NEG_BIG) or a product that overflows to -inf then adds zero
// mass instead of NaN.  Ragged edges of C and of both regions of K are
// masked here; nothing is padded to tile multiples.
//
// Plain C interface for ctypes: the launch function returns the
// cudaError_t of cudaGetLastError() after the launch.  It launches on the
// stream it is given, allocates nothing and does not synchronise.

#include <cuda_runtime.h>

namespace {

constexpr float NEG_BIG = -1e30f;
constexpr int WARPS = 8;               // warps per block
constexpr int CPW = 8;                 // candidates per warp (per lane, in registers)
constexpr int TC = WARPS * CPW;        // candidates per block
constexpr int THREADS = WARPS * 32;
constexpr int TK = 1024;               // components per shared-memory tile

// one online logsumexp step: (m, s) <- (max(m, c), s*exp(m-max) + exp(c-max))
__device__ __forceinline__ void lse_push(float& m, float& s, float c) {
  const float d = c - m;
  const float e = __expf(-fabsf(d));
  const bool up = d > 0.0f;
  s = up ? fmaf(s, e, 1.0f) : s + e;
  m = up ? c : m;
}

__device__ __forceinline__ void lse_merge(float& m, float& s, float m2, float s2) {
  const float mm = fmaxf(m, m2);
  s = s * __expf(m - mm) + s2 * __expf(m2 - mm);
  m = mm;
}

// Logsumexp over components [start, start + size) of one label's block p
// ([3, K], row-major) for the CPW candidates of this lane's warp.  Every
// thread of the block calls it with the same start and size.
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

__global__ void __launch_bounds__(THREADS)
pair_score_kernel(const float* __restrict__ z, const float* __restrict__ params,
                  float* __restrict__ out, int C, int K, int k_below) {
  __shared__ float tile[3 * TK];
  const int l = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c0 = blockIdx.x * TC + warp * CPW;
  const float* zl = z + static_cast<size_t>(l) * C;
  const float* pl = params + static_cast<size_t>(l) * 3 * K;

  float f0[CPW], f1[CPW];
#pragma unroll
  for (int c = 0; c < CPW; ++c) {
    const float zc = (c0 + c < C) ? zl[c0 + c] : 0.0f;
    f0[c] = zc * zc;
    f1[c] = zc;
  }
  float mb[CPW], sb[CPW], ma[CPW], sa[CPW];
  region_lse(pl, K, 0, k_below, f0, f1, mb, sb, tile, lane);
  region_lse(pl, K, k_below, K - k_below, f0, f1, ma, sa, tile, lane);
#pragma unroll
  for (int c = 0; c < CPW; ++c) {
    if (lane == c && c0 + c < C) {
      out[static_cast<size_t>(l) * C + c0 + c] =
          (mb[c] + logf(sb[c])) - (ma[c] + logf(sa[c]));
    }
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
