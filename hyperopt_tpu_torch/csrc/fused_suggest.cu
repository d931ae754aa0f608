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
// What bounds it: the SFU, as pair_score.cu.  The score stage does the
// same L*C*K cells with one exp each (2.69e8 at the main-path shape: 0.064
// ms of MUFU.EX2 at 16 per SM per clock, 1.98 GHz, 132 SMs, against 0.032
// ms for their f32 operations); the draw, winner and partials add
// O(L*C*(Kb + TC)) cheap operations.  Bytes: the inputs once
// (O(L*(C + K))) and O(L*k*(n_top + 4)) outputs.
//
// What the design does about it:
// - the score stage is pair_score.cu's loop (pair_lse.cuh: 7.7 issue slots
//   and 1.125 exps per cell, the label's P resident in shared memory), so
//   it costs what B1 costs, and the launch picks the candidates per warp
//   (CPW) as B1's does;
// - P's copies start before the candidates are loaded or drawn, and the
//   candidates, scores and partial reductions stay in shared memory: only
//   the winner and the partials leave the block;
// - the TPU grid (L, k, tiles) carries one accumulator across candidate
//   tiles in order.  Blocks here run in no order, so each block writes its
//   tile's partials (winner, (m, s), top n_top) to scratch, and a second
//   kernel in this file merges each (l, j)'s tiles in one block: the
//   winner by strict > in tile order, (m, s) by the max-rebased merge, and
//   the top set without rounds -- each candidate entry's rank counted in
//   parallel by binary searches of the tiles' sorted sets.  No float
//   atomics: every run gives the same bits.  A tile never holds two
//   segments, and padding lanes of the last tile count as -inf for the
//   winner and add no mass.
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
constexpr int MAX_TOP = 128;  // the largest n_top (ops/fused_kernel.py MAX_TOP)

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

// the warp's best pair in the order of beats_nan
__device__ __forceinline__ Cand warp_best(Cand a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const Cand b{__shfl_xor_sync(0xffffffffu, a.v, off),
                 __shfl_xor_sync(0xffffffffu, a.key, off)};
    if (beats_nan(b, a)) a = b;
  }
  return a;
}

// One block per (tile t, segment j, label l): TC candidates of one segment.
// Writes the tile's partials to scratch slot (l*k + j)*T + t:
//   part[slot*(PF + n_top) + {0: best score, 1: its value, 2: m, 3: s}],
//   the tile's top n_top sanitized scores after them (descending, -inf
//   padded), and arg[slot] = the best candidate's index in its segment.
template <int CPW>
__global__ void __launch_bounds__(THREADS, 1)
fused_tile_kernel(const float* __restrict__ xin, const float* __restrict__ u_val,
                  const float* __restrict__ rows, const float* __restrict__ params,
                  float* __restrict__ part, int* __restrict__ arg, int k, int n_cand, int K,
                  int k_below, int n_top, int log_scale, int draw_in_kernel) {
  constexpr int TC = WARPS * CPW;
  extern __shared__ __align__(16) float ring[];  // RING_BYTES
  __shared__ RingBarriers bar;
  __shared__ float xs[TC];
  __shared__ float sc[TC];
  __shared__ float sd[TC];
  const int t = blockIdx.x, j = blockIdx.y, l = blockIdx.z;
  const int T = gridDim.x;
  const int tid = threadIdx.x;
  const int i0 = t * TC;
  const int n_valid = min(TC, n_cand - i0);
  const size_t row = (static_cast<size_t>(l) * k + j) * n_cand + i0;
  const float* pl = params + static_cast<size_t>(l) * 3 * K;

  // candidates of this tile: their loads go out before P's copies, and
  // the copies overlap the draw
  float x = 0.0f, u = 0.0f;
  if (tid < n_valid) {
    x = xin[row + tid];
    if (draw_in_kernel) u = u_val[row + tid];
  }
  begin_tiles(pl, K, k_below, ring, bar);
  if (tid < TC) {
    if (draw_in_kernel && tid < n_valid) {
      x = draw_one(x, u, rows + static_cast<size_t>(l) * 7 * k_below, k_below, log_scale);
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
  pair_scores<CPW>(pl, K, k_below, z, score, ring, bar, lane);
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

  // winner, m and s: warp 0
  if (warp == 0) {
    Cand best{-CUDART_INF_F, 0x7fffffff};
    float m = NEG_BIG;
    for (int i = lane; i < n_valid; i += 32) {
      const Cand c{sc[i], i};
      if (beats_nan(c, best)) best = c;
      m = fmaxf(m, sd[i]);
    }
    best = warp_best(best);
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

constexpr int MERGE_THREADS = 256;

// One block per (segment j, label l): merges the segment's T tile partials
// (T * (PF + n_top) floats at part + seg * T * (PF + n_top)), reading them
// where they lie (a few KB per segment, in L2 after the tile kernel).
__global__ void __launch_bounds__(MERGE_THREADS)
fused_merge_kernel(const float* __restrict__ part, const int* __restrict__ arg,
                   float* __restrict__ win, int* __restrict__ best_idx,
                   float* __restrict__ seg_m, float* __restrict__ seg_s,
                   float* __restrict__ seg_top, int k, int T, int n_top) {
  __shared__ int top_tiles[MAX_TOP];
  const int j = blockIdx.x, l = blockIdx.y;
  const size_t seg = static_cast<size_t>(l) * k + j;
  const int stride = PF + n_top;
  const float* __restrict__ p = part + seg * T * stride;

  // The top set, with no rounds.  Each tile's entries are sorted in the
  // order of `beats`, keyed (tile, position) as t * MAX_TOP + position.
  // Only the nc = min(T, n_top) tiles whose heads are the best n_top heads
  // can hold any of it (those heads beat every entry of the other tiles);
  // top_tiles lists them in their heads' order.
  auto entry = [&](int t, int r) { return Cand{p[t * stride + PF + r], t * MAX_TOP + r}; };
  for (int t = threadIdx.x; t < T; t += MERGE_THREADS) {
    const Cand h = entry(t, 0);
    int rank = 0;
#pragma unroll 8
    for (int u = 0; u < T; ++u) rank += beats(entry(u, 0), h) ? 1 : 0;
    if (rank < n_top) top_tiles[rank] = t;
  }
  __syncthreads();
  // An entry of those tiles that the last of their heads does not beat has
  // the rank: its position, plus per other such tile the count of that
  // tile's entries that beat it (a binary search, the tile being sorted)
  const int nc = min(T, n_top);
  const Cand last_head = entry(top_tiles[nc - 1], 0);
  for (int i = threadIdx.x; i < nc * n_top; i += MERGE_THREADS) {
    const int ti = i / n_top, r = i - ti * n_top;
    const Cand e = entry(top_tiles[ti], r);
    if (nc == n_top && beats(last_head, e)) continue;
    int rank = r;
#pragma unroll 4
    for (int v = 0; v < nc; ++v) {
      const int u = top_tiles[v];
      int lo = 0, hi = v == ti ? 0 : n_top;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (beats(entry(u, mid), e)) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      rank += lo;
    }
    if (rank < n_top) seg_top[seg * n_top + rank] = e.v;
  }

  // winner, m and s: warp 0, lane l holding tiles l, l + 32, ...
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  // the winner: strict > in tile order (ties keep the earlier tile)
  Cand best{-CUDART_INF_F, 0x7fffffff};
  float m = NEG_BIG;
  for (int t = lane; t < T; t += 32) {
    const Cand c{p[t * stride], t};
    if (beats_nan(c, best)) best = c;
    m = fmaxf(m, p[t * stride + 2]);
  }
  best = warp_best(best);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  // (m, s): every tile's sum rebased to the segment's max
  float s = 0.0f;
  for (int t = lane; t < T; t += 32) s = fmaf(p[t * stride + 3], expf(p[t * stride + 2] - m), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {
    win[seg] = p[best.key * stride + 1];
    best_idx[seg] = __ldg(arg + seg * T + best.key);
    seg_m[seg] = m;
    seg_s[seg] = s;
  }
}

template <int CPW>
void launch_tiles(const float* xin, const float* u_val, const float* rows, const float* params,
                  float* part, int* arg, int L, int k, int n_cand, int K, int k_below, int n_top,
                  int log_scale, int draw_in_kernel, cudaStream_t st) {
  constexpr int TC = WARPS * CPW;
  cudaFuncSetAttribute(fused_tile_kernel<CPW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       RING_BYTES);
  fused_tile_kernel<CPW><<<dim3((n_cand + TC - 1) / TC, k, L), THREADS, RING_BYTES, st>>>(
      xin, u_val, rows, params, part, arg, k, n_cand, K, k_below, n_top, log_scale,
      draw_in_kernel);
}

}  // namespace

// part and arg hold the partials of ceil(n_cand / (WARPS * cpw)) tiles per
// segment; the launch picks cpw = 8 or 4 as pair_score.cu's does
extern "C" int fused_suggest_launch(const float* xin, const float* u_val, const float* rows,
                                    const float* params, float* part, int* arg, float* win,
                                    int* best_idx, float* seg_m, float* seg_s,
                                    float* seg_top, int L, int k, int n_cand, int K,
                                    int k_below, int n_top, int log_scale,
                                    int draw_in_kernel, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int cpw = pick_cpw(L * k * ((n_cand + WARPS * 8 - 1) / (WARPS * 8)));
  const int T = (n_cand + WARPS * cpw - 1) / (WARPS * cpw);
  if (cpw == 8) {
    launch_tiles<8>(xin, u_val, rows, params, part, arg, L, k, n_cand, K, k_below, n_top,
                    log_scale, draw_in_kernel, st);
  } else {
    launch_tiles<4>(xin, u_val, rows, params, part, arg, L, k, n_cand, K, k_below, n_top,
                    log_scale, draw_in_kernel, st);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_merge_kernel<<<dim3(k, L), MERGE_THREADS, 0, st>>>(part, arg, win, best_idx, seg_m,
                                                           seg_s, seg_top, k, T, n_top);
  return static_cast<int>(cudaGetLastError());
}
