// Fused TPE suggest on Hopper (sm_90a): draw -> score -> winner + EI partials.
//
// Replaces the TPU kernel hyperopt_tpu/ops/pallas_fused.py::_fused_kernel
// (launched by _fused_suggest_pallas).  Per label l and suggestion j (a
// segment of n_cand candidates) it computes
//   - optionally the candidates themselves (draw_in_kernel): the inverse-CDF
//     component pick count(cdf <= t), then the truncated-normal inverse
//     transform, the op chain of ops/gmm.py draw_from_rows term for term;
//   - z = log(max(x, 1e-12)) for log-scale labels;
//   - the pair score of every candidate (pair_lse.cuh, bit-identical to
//     pair_score.cu's);
//   - the winner: the first index of the largest score (NaN counts as the
//     largest, as torch.argmax does), its value and index;
//   - the EI partials over the sanitized scores (NaN -> -1e30, clamped to
//     +-1e30): max m, sum of exp(score - m), and the top n_top scores.
//
// What bounds it: operations, as pair_score.cu.  The score stage does the
// same L*C*K cells of ~8 operations (2.69e8 at the main-path shape), and
// the draw, winner and partials add O(L*C*(Kb + TC)) cheap operations.
// Bytes: the inputs once (O(L*(C + K))) and O(L*k*(n_top + 4)) outputs.
//
// What the design does about it:
// - the score stage is pair_score.cu's loop (8 warps x 8 candidates in
//   registers, components over the 32 lanes), so it costs what B1 costs;
// - the candidates, scores and partial reductions stay in shared memory:
//   only the winner and the partials leave the block;
// - the TPU grid (L, k, tiles) carries one accumulator across candidate
//   tiles in order.  Blocks here run in no order, so each block writes its
//   tile's partials (winner, (m, s), top n_top) to scratch, and a second
//   small kernel in this file merges each (l, j)'s tiles: the winner by
//   strict > in tile order, (m, s) by the max-rebased merge, the top set by
//   n_top rounds of a block argmax.  No float atomics: every run gives the
//   same bits.  A tile never holds two segments, and padding lanes of the
//   last tile count as -inf for the winner and add no mass.
//
// Plain C interface for ctypes: the launch function returns the
// cudaError_t of cudaGetLastError() after both launches.  It launches on
// the stream it is given, allocates nothing and does not synchronise.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cfloat>

#include "pair_lse.cuh"

namespace {

using namespace pair_lse;

constexpr float EPS = static_cast<float>(1e-12);
constexpr float SAN = 1e30f;                                      // score sanitization bound
constexpr float CDF_TOP = static_cast<float>(1.0 - 1e-6);         // ops/dists.py inverse_cdf
constexpr float SQRT2 = static_cast<float>(1.4142135623730951);
constexpr int PF = 4;  // per-tile floats before the top set: best, value, m, s

// XLA's f32 erf_inv (Giles), as ops/gmm.py erfinv_f32: f32 coefficients
// (decimal -> double -> float, as torch casts them), Horner steps as FMAs
__device__ __constant__ float ERFINV_LT5[9] = {
    static_cast<float>(2.81022636e-08), static_cast<float>(3.43273939e-07),
    static_cast<float>(-3.5233877e-06), static_cast<float>(-4.39150654e-06),
    static_cast<float>(0.00021858087),  static_cast<float>(-0.00125372503),
    static_cast<float>(-0.00417768164), static_cast<float>(0.246640727),
    static_cast<float>(1.50140941)};
__device__ __constant__ float ERFINV_GE5[9] = {
    static_cast<float>(-0.000200214257), static_cast<float>(0.000100950558),
    static_cast<float>(0.00134934322),   static_cast<float>(-0.00367342844),
    static_cast<float>(0.00573950773),   static_cast<float>(-0.0076224613),
    static_cast<float>(0.00943887047),   static_cast<float>(1.00167406),
    static_cast<float>(2.83297682)};

__device__ __forceinline__ float erfinv_f32(float x) {
  const float w = -log1pf(-x * x);
  const bool lt = w < 5.0f;
  const float ww = lt ? w - 2.5f : sqrtf(w) - 3.0f;
  float p = lt ? ERFINV_LT5[0] : ERFINV_GE5[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) p = fmaf(p, ww, lt ? ERFINV_LT5[i] : ERFINV_GE5[i]);
  return fabsf(x) == 1.0f ? x * FLT_MAX : p * x;
}

// one candidate from uniforms (u1, u2) and the label's [7, kb] draw table
// (ops/gmm.py draw_param_rows: cdf, mu, sigma, erf(a/√2), erf(b/√2),
// nextafter(a, +inf), nextafter(b, -inf)) -- draw_from_rows term for term
__device__ __forceinline__ float draw_one(float u1, float u2, const float* __restrict__ rows,
                                          int kb, bool log_scale) {
  const float total = rows[kb - 1];
  const float t = fminf(u1 * total, total * CDF_TOP);
  int comp = 0;
  for (int j = 0; j < kb; ++j) comp += rows[j] <= t ? 1 : 0;
  comp = min(comp, kb - 1);
  const float ea = rows[3 * kb + comp];
  const float eb = rows[4 * kb + comp];
  const float u = fmaxf(ea, fmaf(u2, eb - ea, ea));
  float tn = SQRT2 * erfinv_f32(u);
  tn = fminf(fmaxf(tn, rows[5 * kb + comp]), rows[6 * kb + comp]);
  const float x = fmaf(rows[2 * kb + comp], tn, rows[kb + comp]);
  return log_scale ? expf(x) : x;
}

__device__ __forceinline__ float sanitize(float s) {
  return isnan(s) ? -SAN : fminf(fmaxf(s, -SAN), SAN);
}

// (score, key) pairs ordered as torch.argmax reads them: NaN above all,
// then larger score, ties to the smaller key.  Keys are unique, so this is
// a strict total order and any reduction tree finds the same winner.
struct Cand {
  float v;
  int key;
};

__device__ __forceinline__ bool beats_nan(Cand a, Cand b) {
  const bool na = isnan(a.v), nb = isnan(b.v);
  if (na || nb) return na && (!nb || a.key < b.key);
  return a.v > b.v || (a.v == b.v && a.key < b.key);
}

// the top-set order: larger value, ties to the smaller key (no NaN here)
__device__ __forceinline__ bool beats(Cand a, Cand b) {
  return a.v > b.v || (a.v == b.v && a.key < b.key);
}

template <bool NAN_AWARE>
__device__ __forceinline__ Cand warp_best(Cand a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const Cand b{__shfl_xor_sync(0xffffffffu, a.v, off),
                 __shfl_xor_sync(0xffffffffu, a.key, off)};
    if (NAN_AWARE ? beats_nan(b, a) : beats(b, a)) a = b;
  }
  return a;
}

// the best pair of the block; red: WARPS Cand of shared memory
template <bool NAN_AWARE>
__device__ Cand block_best(Cand a, Cand* red) {
  const int warp = threadIdx.x >> 5;
  a = warp_best<NAN_AWARE>(a);
  if ((threadIdx.x & 31) == 0) red[warp] = a;
  __syncthreads();
  a = red[0];
  for (int w = 1; w < WARPS; ++w) {
    if (NAN_AWARE ? beats_nan(red[w], a) : beats(red[w], a)) a = red[w];
  }
  __syncthreads();  // red may be reused
  return a;
}

// the block's sum in a fixed order (every run gives the same bits); red:
// WARPS floats of shared memory
__device__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = red[0];
  for (int w = 1; w < WARPS; ++w) s += red[w];
  __syncthreads();
  return s;
}

__device__ float block_max(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = red[0];
  for (int w = 1; w < WARPS; ++w) m = fmaxf(m, red[w]);
  __syncthreads();
  return m;
}

// One block per (tile t, segment j, label l): TC candidates of one segment.
// Writes the tile's partials to scratch slot (l*k + j)*T + t:
//   part[slot*(PF + n_top) + {0: best score, 1: its value, 2: m, 3: s}],
//   the tile's top n_top sanitized scores after them (descending, -inf
//   padded), and arg[slot] = the best candidate's index in its segment.
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
fused_tile_kernel(const float* __restrict__ xin, const float* __restrict__ u_val,
                  const float* __restrict__ rows, const float* __restrict__ params,
                  float* __restrict__ part, int* __restrict__ arg, int k, int n_cand, int K,
                  int k_below, int n_top, int log_scale, int draw_in_kernel) {
  __shared__ float tile[3 * TK];
  __shared__ float xs[TC];
  __shared__ float sc[TC];
  __shared__ float sd[TC];
  const int t = blockIdx.x, j = blockIdx.y, l = blockIdx.z;
  const int T = gridDim.x;
  const int tid = threadIdx.x;
  const int i0 = t * TC;
  const int n_valid = min(TC, n_cand - i0);
  const size_t row = (static_cast<size_t>(l) * k + j) * n_cand + i0;

  // candidates of this tile
  if (tid < TC) {
    float x = 0.0f;
    if (tid < n_valid) {
      x = draw_in_kernel
              ? draw_one(xin[row + tid], u_val[row + tid],
                         rows + static_cast<size_t>(l) * 7 * k_below, k_below, log_scale)
              : xin[row + tid];
    }
    xs[tid] = x;
  }
  __syncthreads();

  // scores
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int c0 = warp * CPW;
  float z[CPW], score[CPW];
#pragma unroll
  for (int c = 0; c < CPW; ++c) {
    const float x = xs[c0 + c];
    z[c] = c0 + c < n_valid ? (log_scale ? logf(fmaxf(x, EPS)) : x) : 0.0f;
  }
  pair_scores(params + static_cast<size_t>(l) * 3 * K, K, k_below, z, score, tile, lane);
#pragma unroll
  for (int c = 0; c < CPW; ++c) {
    if (lane == c) {
      sc[c0 + c] = score[c];
      sd[c0 + c] = c0 + c < n_valid ? sanitize(score[c]) : -CUDART_INF_F;
    }
  }
  __syncthreads();

  const size_t slot = (static_cast<size_t>(l) * k + j) * T + t;
  float* out = part + slot * (PF + n_top);

  // top n_top: each valid candidate's rank among the tile's sanitized scores
  if (tid < n_valid) {
    const float v = sd[tid];
    int rank = 0;
    for (int i = 0; i < n_valid; ++i) {
      const float o = sd[i];
      rank += (o > v || (o == v && i < tid)) ? 1 : 0;
    }
    if (rank < n_top) out[PF + rank] = v;
  }
  for (int r = n_valid + tid; r < n_top; r += THREADS) out[PF + r] = -CUDART_INF_F;

  // winner, m and s: warp 0, two candidates per lane
  if (warp == 0) {
    Cand best{-CUDART_INF_F, 0x7fffffff};
    float m = NEG_BIG;
    for (int i = lane; i < n_valid; i += 32) {
      const Cand c{sc[i], i};
      if (beats_nan(c, best)) best = c;
      m = fmaxf(m, sd[i]);
    }
    best = warp_best<true>(best);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float s = 0.0f;
    for (int i = lane; i < n_valid; i += 32) s += expf(sd[i] - m);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) {
      out[0] = best.v;
      out[1] = xs[best.key];
      out[2] = m;
      out[3] = s;
      arg[slot] = i0 + best.key;
    }
  }
}

// One block per (segment j, label l): merges the segment's T tile partials.
__global__ void __launch_bounds__(THREADS)
fused_merge_kernel(const float* __restrict__ part, const int* __restrict__ arg,
                   float* __restrict__ win, int* __restrict__ best_idx,
                   float* __restrict__ seg_m, float* __restrict__ seg_s,
                   float* __restrict__ seg_top, int k, int T, int n_top) {
  __shared__ Cand red[WARPS];
  __shared__ float redf[WARPS];
  const int j = blockIdx.x, l = blockIdx.y;
  const size_t seg = static_cast<size_t>(l) * k + j;
  const float* p = part + seg * T * (PF + n_top);
  const int stride = PF + n_top;

  // winner: strict > in tile order (ties keep the earlier tile)
  Cand best{-CUDART_INF_F, 0x7fffffff};
  float m = NEG_BIG;
  for (int t = threadIdx.x; t < T; t += THREADS) {
    const Cand c{p[t * stride], t};
    if (beats_nan(c, best)) best = c;
    m = fmaxf(m, p[t * stride + 2]);
  }
  best = block_best<true>(best, red);
  m = block_max(m, redf);

  // (m, s): every tile's sum rebased to the segment's max
  float s = 0.0f;
  for (int t = threadIdx.x; t < T; t += THREADS) {
    s += p[t * stride + 3] * expf(p[t * stride + 2] - m);
  }
  s = block_sum(s, redf);

  if (threadIdx.x == 0) {
    win[seg] = p[best.key * stride + 1];
    best_idx[seg] = arg[seg * T + best.key];
    seg_m[seg] = m;
    seg_s[seg] = s;
  }

  // top n_top over the T tile sets: round r takes the largest
  // (value, position) pair after round r-1's in the order of `beats`
  Cand prev{CUDART_INF_F, -1};
  const int n = T * n_top;
  for (int r = 0; r < n_top; ++r) {
    Cand cur{-CUDART_INF_F, 0x7fffffff};
    for (int e = threadIdx.x; e < n; e += THREADS) {
      const Cand c{p[(e / n_top) * stride + PF + e % n_top], e};
      if (beats(prev, c) && beats(c, cur)) cur = c;
    }
    cur = block_best<false>(cur, red);
    if (threadIdx.x == 0) seg_top[seg * n_top + r] = cur.v;
    prev = cur;
  }
}

}  // namespace

extern "C" int fused_suggest_launch(const float* xin, const float* u_val, const float* rows,
                                    const float* params, float* part, int* arg, float* win,
                                    int* best_idx, float* seg_m, float* seg_s,
                                    float* seg_top, int L, int k, int n_cand, int K,
                                    int k_below, int n_top, int log_scale,
                                    int draw_in_kernel, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int T = (n_cand + TC - 1) / TC;
  fused_tile_kernel<<<dim3(T, k, L), THREADS, 0, st>>>(
      xin, u_val, rows, params, part, arg, k, n_cand, K, k_below, n_top, log_scale,
      draw_in_kernel);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_merge_kernel<<<dim3(k, L), THREADS, 0, st>>>(part, arg, win, best_idx, seg_m, seg_s,
                                                     seg_top, k, T, n_top);
  return static_cast<int>(cudaGetLastError());
}
