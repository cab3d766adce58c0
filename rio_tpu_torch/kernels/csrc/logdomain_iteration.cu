// One fused log-domain Sinkhorn iteration with one read of the cost matrix.
//
// Replaces the Pallas TPU kernel `fused_iteration` (body `_iteration_kernel`)
// of rio_tpu/ops/pallas_sinkhorn.py:44-143. Given C (n, m) float32 and
// float32 log_a (n,), log_b (m,), g (m,) and eps, it computes
//
//   f_i  = eps * (log_a_i - LSE_j((g_j - C_ij) / eps))    (-inf where log_a_i = -inf)
//   g'_j = eps * (log_b_j - LSE_i((f_i - C_ij) / eps))    (-inf where log_b_j = -inf)
//
// with the Pallas kernel's conventions: each LSE is max + log(max(sum, 1e-30))
// with a max of -inf taken as 0, so a row whose every column is dead gets the
// finite f = eps * (log_a - log(1e-30)), and a column no live row reaches gets
// the finite LSE log(1e-30).
//
// Bound. C is read once: at 1,048,576 x 1024 that is 4 GiB, plus the vectors,
// 4,303,368,192 B, or ~1.285 ms per iteration at the H100's 3.35 TB/s. The
// work per element is two exponentials (one for the row sum, one for the
// column sum) and ~16 other float32 instructions: 2^31 exponentials at 16 per
// clock on each of 132 SMs at 1.98 GHz take ~0.51 ms, and the other
// instructions about as long again. So the kernel is bound by the bytes, but
// only if its arithmetic overlaps its loads.
//
// Design, for that bound:
// * C is read from device memory once per iteration. A warp owns one row at
//   a time and holds it in registers (32 floats a lane at m = 1024, 16-byte
//   loads, neighbouring lanes on neighbouring addresses). The next row's
//   loads (and its log_a) are issued before the current row is reduced, so
//   each warp keeps two rows in flight.
// * Exponentials are ex2.approx in base 2: z = (g - C) * log2(e) / eps.
//   g * log2(e) / eps is staged once per CTA in shared memory. JAX divides
//   by eps; multiplying by log2(e) / eps instead, and the approximate ex2,
//   change the last bits, which the stated tolerances (1e-4 + 1e-4 |ref|
//   against the plain twin) cover.
// * The row LSE needs the whole row before the row's column terms exist: a
//   warp max of z, then a warp sum of 2^(z - max) (both butterflies, so every
//   lane holds the same f_i).
// * The column LSE is online, per lane, over the rows the warp visits: a
//   running max M and a sum S rebased on it, for each of the lane's columns.
//   One exponential per element: t = 2^-|w - M|, then S = S t + 1, M = w if
//   w > M, else S += t. A difference of two -inf (a column no live row has
//   reached yet, or a cost of +inf) is clamped to -inf, so t is 0, not NaN.
//   Rows with f = -inf (zero mass) are skipped as a whole.
// * The Pallas kernel carries the column (max, sum) in VMEM across a grid
//   that runs in order. CTAs here run at once, so the grid is persistent
//   (one CTA per SM, each walking rows with a fixed stride); at the end each
//   CTA merges its warps' (max, sum) pairs in warp order and writes one
//   partial row to an (n_parts, m) float2 workspace. A second, small kernel
//   merges the partials in a fixed order with the split-LSE combine and
//   writes g'. No atomics: the result is the same from run to run.
// * Ragged n and m are masked here; the caller never pads or copies C.
//   Columns past m load as C = +inf with g = -inf, so they add nothing to
//   either LSE. A CTA folds at most 1024 columns (kTileCols); wider C is cut
//   into column tiles on a second grid axis, each of which reads the whole
//   row for the row LSE, so such C is read once per tile (correct, not
//   fast). Rows whose byte length or base address is not a multiple of 16
//   take a one-element-per-lane path (correct, not fast).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileCols = 1024;
constexpr int kFinalizeCols = 32;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000u); }
__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000u); }
__device__ __forceinline__ bool is_finite(float x) { return fabsf(x) < pos_inf(); }

// 2^x, one MUFU instruction; 2^-inf = 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Split-LSE combine in base 2: (M, S) <- (M, S) + (m2, s2), where S is a sum
// of 2^(x - M). An empty side (max -inf, sum 0) is skipped, never rebased.
__device__ __forceinline__ void lse_merge(float& M, float& S, float m2, float s2) {
  if (m2 == neg_inf()) return;
  if (M == neg_inf()) {
    M = m2;
    S = s2;
    return;
  }
  const float hi = fmaxf(M, m2);
  S = __fadd_rn(__fmul_rn(S, ex2(M - hi)), __fmul_rn(s2, ex2(m2 - hi)));
  M = hi;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

template <int VEC>
struct alignas(4 * VEC) Pack {
  float x[VEC];
};

// Loads this lane's C chunks of one row's column tile; columns past m are +inf.
// VEC = 4 only when m is a multiple of 4, so a pack is all in or all out.
template <int VEC, int C>
__device__ __forceinline__ void load_tile(const float* __restrict__ row, int tile0, int m, int lane,
                                          Pack<VEC> (&dst)[C]) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int col = tile0 + c * 32 * VEC + lane * VEC;
    if (col < m) {
      dst[c] = *reinterpret_cast<const Pack<VEC>*>(row + col);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) dst[c].x[j] = pos_inf();
    }
  }
}

// g * log2(e) / eps for this lane's VEC columns of chunk c. kShared: from the
// CTA's own tile staged in shared memory (laid out in column order, so a
// warp's float4 reads are 512 consecutive bytes); else from g in device
// memory for the tile at tile0, -inf past m.
template <int VEC, bool kShared>
__device__ __forceinline__ void load_gk(const float* gk_s, const float* __restrict__ g, float k,
                                        int tile0, int m, int c, int lane, float (&out)[VEC]) {
  const int i = c * 32 * VEC + lane * VEC;
  if constexpr (kShared) {
    if constexpr (VEC == 4) {
      const float4 w = *reinterpret_cast<const float4*>(gk_s + i);
      out[0] = w.x;
      out[1] = w.y;
      out[2] = w.z;
      out[3] = w.w;
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) out[j] = gk_s[i + j];
    }
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) out[j] = tile0 + i + j < m ? g[tile0 + i + j] * k : neg_inf();
  }
}

// Row LSE terms of one column tile, in base 2: the warp max of
// z = g k - C k over the tile, and the warp sum of 2^(z - max), with the max
// taken as 0 where it is not finite. Every lane returns the same pair.
template <int VEC, int C, bool kShared>
__device__ __forceinline__ void tile_stats(const Pack<VEC> (&vals)[C], const float* gk_s,
                                           const float* __restrict__ g, float k, int tile0, int m,
                                           int lane, float& tile_max, float& tile_sum) {
  float zmax = neg_inf();
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float gk[VEC];
    load_gk<VEC, kShared>(gk_s, g, k, tile0, m, c, lane, gk);
#pragma unroll
    for (int j = 0; j < VEC; ++j) zmax = fmaxf(zmax, fmaf(vals[c].x[j], -k, gk[j]));
  }
  zmax = warp_max(zmax);
  const float zsafe = is_finite(zmax) ? zmax : 0.f;
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float gk[VEC];
    load_gk<VEC, kShared>(gk_s, g, k, tile0, m, c, lane, gk);
#pragma unroll
    for (int j = 0; j < VEC; ++j) s = __fadd_rn(s, ex2(fmaf(vals[c].x[j], -k, gk[j]) - zsafe));
  }
  tile_max = zmax;
  tile_sum = warp_sum(s);
}

// Row sweep: f for every row, and per-CTA partial column (max, sum) pairs of
// w = (f - C) log2(e) / eps over the CTA's rows and its column tile
// (blockIdx.y). kMultiTile is false when one tile covers the row.
template <int VEC, int C, bool kMultiTile>
__global__ void __launch_bounds__(kThreads, 1)
    logdomain_rows_kernel(const float* __restrict__ cost, const float* __restrict__ log_a,
                          const float* __restrict__ g, float* __restrict__ f_out,
                          float2* __restrict__ partial, float eps, long long n, int m) {
  constexpr int kStride = 32 * VEC;   // columns one warp covers per chunk
  constexpr int kTile = kStride * C;  // columns this CTA folds
  __shared__ __align__(16) float gk_s[kTile];
  __shared__ float2 col_s[kTile];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tile = blockIdx.y;
  const int n_tiles = gridDim.y;
  const int tile0 = tile * kTile;
  const float k = kLog2e / eps;

  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const int col = tile0 + i;
    gk_s[i] = col < m ? g[col] * k : neg_inf();
  }
  __syncthreads();

  float cm[C][VEC];  // running column max of w, base 2
  float cs[C][VEC];  // running sum of 2^(w - cm)
#pragma unroll
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      cm[c][j] = neg_inf();
      cs[c][j] = 0.f;
    }
  }

  const long long warp_stride = static_cast<long long>(gridDim.x) * kWarps;
  long long r = static_cast<long long>(blockIdx.x) * kWarps + warp;
  Pack<VEC> cur[C];
  Pack<VEC> nxt[C];
  float la_cur = 0.f, la_nxt = 0.f;
  if (r < n) {
    load_tile<VEC, C>(cost + r * m, tile0, m, lane, cur);
    la_cur = log_a[r];
  }

  for (; r < n; r += warp_stride) {
    const long long r_next = r + warp_stride;
    if (r_next < n) {
      load_tile<VEC, C>(cost + r_next * m, tile0, m, lane, nxt);
      la_nxt = log_a[r_next];
    }

    float f = neg_inf();
    if (is_finite(la_cur)) {
      // Row LSE over the whole row, tile by tile in column order, so every
      // CTA of the row computes the same f bit for bit.
      float rmax = neg_inf(), rsum = 0.f;
      for (int t = 0; t < n_tiles; ++t) {
        float tmax = neg_inf(), tsum = 0.f;
        if (t == tile) {
          tile_stats<VEC, C, true>(cur, gk_s, g, k, tile0, m, lane, tmax, tsum);
        } else if constexpr (kMultiTile) {
          Pack<VEC> other[C];
          load_tile<VEC, C>(cost + r * m, t * kTile, m, lane, other);
          tile_stats<VEC, C, false>(other, gk_s, g, k, t * kTile, m, lane, tmax, tsum);
        }
        lse_merge(rmax, rsum, tmax, tsum);
      }
      const float rsafe = is_finite(rmax) ? rmax : 0.f;
      const float row_lse = rsafe * kLn2 + logf(fmaxf(rsum, 1e-30f));
      f = eps * (la_cur - row_lse);
    }
    if (tile == 0 && lane == 0) f_out[r] = f;

    if (is_finite(f)) {
      const float fk = f * k;
#pragma unroll
      for (int c = 0; c < C; ++c) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float w = fmaf(cur[c].x[j], -k, fk);
          const float M = cm[c][j];
          const float hi = fmaxf(M, w);
          const float t = ex2(fmaxf(fminf(M, w) - hi, neg_inf()));
          cs[c][j] = w > M ? fmaf(cs[c][j], t, 1.f) : cs[c][j] + t;
          cm[c][j] = hi;
        }
      }
    }
    if (r_next < n) {
#pragma unroll
      for (int c = 0; c < C; ++c) cur[c] = nxt[c];
      la_cur = la_nxt;
    }
  }

  // Merge the warps' pairs in warp order, then write this CTA's partial row.
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const int i = c * kStride + lane * VEC + j;
          float M = cm[c][j], S = cs[c][j];
          if (w > 0) {
            M = col_s[i].x;
            S = col_s[i].y;
            lse_merge(M, S, cm[c][j], cs[c][j]);
          }
          col_s[i] = make_float2(M, S);
        }
      }
    }
    __syncthreads();
  }
  float2* out = partial + static_cast<long long>(blockIdx.x) * m;
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const int col = tile0 + i;
    if (col < m) out[col] = col_s[i];
  }
}

// g'_j from the partial (max, sum) pairs of column j. A CTA owns
// kFinalizeCols columns; warp w merges parts w, w + kWarps, ... and the
// warps' pairs are merged in warp order.
__global__ void __launch_bounds__(kThreads)
    logdomain_finalize_kernel(const float2* __restrict__ partial, int n_parts,
                              const float* __restrict__ log_b, float* __restrict__ g_out,
                              float eps, int m) {
  __shared__ float2 pairs[kWarps][kFinalizeCols];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col = blockIdx.x * kFinalizeCols + lane;
  float M = neg_inf(), S = 0.f;
  if (col < m) {
    for (int p = warp; p < n_parts; p += kWarps) {
      const float2 q = partial[static_cast<long long>(p) * m + col];
      lse_merge(M, S, q.x, q.y);
    }
  }
  pairs[warp][lane] = make_float2(M, S);
  __syncthreads();
  if (warp == 0 && col < m) {
    float Mt = neg_inf(), St = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) lse_merge(Mt, St, pairs[w][lane].x, pairs[w][lane].y);
    const float msafe = is_finite(Mt) ? Mt : 0.f;
    const float col_lse = msafe * kLn2 + logf(fmaxf(St, 1e-30f));
    const float lb = log_b[col];
    g_out[col] = is_finite(lb) ? eps * (lb - col_lse) : neg_inf();
  }
}

struct Plan {
  int vec;     // floats per lane load: 4 (16 bytes) or 1
  int chunks;  // loads per lane per row tile
  int tiles;   // column tiles (grid.y)
};

Plan make_plan(const void* cost, long long m) {
  const bool aligned = (m * 4) % 16 == 0 && reinterpret_cast<uintptr_t>(cost) % 16 == 0;
  const int vec = aligned ? 4 : 1;
  const int max_chunks = kTileCols / (32 * vec);
  int chunks = 1;
  while (chunks < max_chunks && 32LL * vec * chunks < m) chunks *= 2;
  const long long tile = 32LL * vec * chunks;
  return Plan{vec, chunks, static_cast<int>((m + tile - 1) / tile)};
}

template <int VEC, int C, bool kMultiTile>
int parts_for(long long n, int* parts) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, logdomain_rows_kernel<VEC, C, kMultiTile>, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long want = (n + kWarps - 1) / kWarps;
  const long long cap = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const long long p = want < cap ? want : cap;
  *parts = static_cast<int>(p > 0 ? p : 1);
  return 0;
}

template <int VEC, int C, bool kMultiTile>
int launch(const float* cost, const float* log_a, const float* log_b, const float* g, float* f,
           float* g_out, float2* workspace, int n_parts, float eps, long long n, long long m,
           int tiles, cudaStream_t stream) {
  const dim3 grid(n_parts, tiles);
  logdomain_rows_kernel<VEC, C, kMultiTile><<<grid, kThreads, 0, stream>>>(
      cost, log_a, g, f, workspace, eps, n, static_cast<int>(m));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = static_cast<int>((m + kFinalizeCols - 1) / kFinalizeCols);
  logdomain_finalize_kernel<<<blocks, kThreads, 0, stream>>>(workspace, n_parts, log_b, g_out, eps,
                                                             static_cast<int>(m));
  return static_cast<int>(cudaGetLastError());
}

template <int VEC, int C, bool kMultiTile>
struct PartsFn {
  static int run(long long n, int* parts) { return parts_for<VEC, C, kMultiTile>(n, parts); }
};

template <int VEC, int C, bool kMultiTile>
struct LaunchFn {
  static int run(const float* cost, const float* log_a, const float* log_b, const float* g,
                 float* f, float* g_out, float2* workspace, int n_parts, float eps, long long n,
                 long long m, int tiles, cudaStream_t stream) {
    return launch<VEC, C, kMultiTile>(cost, log_a, log_b, g, f, g_out, workspace, n_parts, eps, n,
                                      m, tiles, stream);
  }
};

// Calls F<VEC, C, multi_tile>::run(args...) for the plan. Several tiles
// occur only at the largest chunk count, so only that one is built both ways.
template <template <int, int, bool> class F, typename... Args>
int dispatch(const Plan& plan, Args... args) {
  const bool multi = plan.tiles > 1;
  if (plan.vec == 4) {
    switch (plan.chunks) {
      case 1: return F<4, 1, false>::run(args...);
      case 2: return F<4, 2, false>::run(args...);
      case 4: return F<4, 4, false>::run(args...);
      case 8: return multi ? F<4, 8, true>::run(args...) : F<4, 8, false>::run(args...);
    }
  } else {
    switch (plan.chunks) {
      case 1: return F<1, 1, false>::run(args...);
      case 2: return F<1, 2, false>::run(args...);
      case 4: return F<1, 4, false>::run(args...);
      case 8: return F<1, 8, false>::run(args...);
      case 16: return F<1, 16, false>::run(args...);
      case 32: return multi ? F<1, 32, true>::run(args...) : F<1, 32, false>::run(args...);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Writes the number of partial rows (the first dimension of the float2
// workspace, n_parts x m) that logdomain_iteration_launch needs for this C.
int logdomain_iteration_parts(const void* cost, long long n, long long m, int* n_parts) {
  if (m <= 0 || m > 0x7fffffffLL || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<PartsFn>(make_plan(cost, m), n, n_parts);
}

// One iteration on `stream`: f (n,) and g_out (m,) from C, log_a, log_b, g
// and eps. Returns cudaGetLastError() after the launches (0 on success).
int logdomain_iteration_launch(const void* cost, const float* log_a, const float* log_b,
                               const float* g, float* f, float* g_out, void* workspace,
                               int n_parts, float eps, long long n, long long m, void* stream) {
  if (m <= 0 || m > 0x7fffffffLL || n < 0 || n_parts <= 0 || !(eps > 0.f))
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan plan = make_plan(cost, m);
  return dispatch<LaunchFn>(plan, static_cast<const float*>(cost), log_a, log_b, g, f, g_out,
                            static_cast<float2*>(workspace), n_parts, eps, n, m, plan.tiles,
                            static_cast<cudaStream_t>(stream));
}

}  // extern "C"
