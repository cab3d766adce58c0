// One fused Sinkhorn-Knopp (scaling-form) iteration with one read of K.
//
// Replaces the Pallas TPU kernel `fused_scaling_iteration` (body
// `_scaling_kernel`) of rio_tpu/ops/scaling.py. Given K (n, m) in bfloat16
// or float32 and float32 a (n,), b (m,), v (m,), it computes
//
//   u_i  = a_i / max(sum_j K_ij v_j, 1e-30)   (0 where a_i <= 0)
//   v'_j = b_j / max(sum_i K_ij u_i, 1e-30)   (0 where b_j <= 0)
//
// with every product and sum in float32.
//
// Bound. The work is two multiply-adds per element of K, far below what
// the card can compute per byte it reads, so the kernel is bound by the
// bytes of K it reads. At 1,048,576 x 1024 bfloat16 one iteration reads
// 2,147,483,648 B of K; at the H100's 3.35 TB/s that takes at least
// ~0.64 ms per iteration, ~19.2 ms for the 30 iterations of a solve.
// Reading K twice (K v, then K^T u, as two matrix-vector products do)
// would double that.
//
// Design, for that bound:
// * K is read from device memory once per iteration. A warp owns one row
//   at a time: it loads the row with 16-byte vector loads (neighbouring
//   lanes on neighbouring addresses), dots it with v (staged once per CTA
//   in shared memory), reduces the dot by shuffles, writes u_i, and
//   folds u_i * K_row into per-lane column accumulators while the row is
//   still in registers. The next row's loads (and its a_i) are issued
//   before the current row is reduced, so each warp keeps two rows in
//   flight. v in shared memory (not registers) keeps the bfloat16 kernel
//   near 80 registers, so at least two 8-warp CTAs fit on each SM; a
//   tighter register bound that forced spills ran at half the speed.
// * The Pallas kernel carries the column sum in VMEM across a grid that
//   runs in order. CTAs here run concurrently, so the grid is persistent
//   (a few CTAs per SM, each walking rows with a fixed stride); at the end
//   each CTA sums its warps' accumulators in a fixed order and writes one
//   partial row to an (n_parts, m) float32 workspace. A second, small
//   kernel sums the partials in a fixed order and applies the v' update.
//   No atomics: the result is the same from run to run.
// * Ragged n and m are masked here; the caller never pads or copies K.
//   A CTA folds at most 1024 columns (kTileCols); wider K is cut into
//   column tiles on a second grid axis, each of which reads the whole row
//   for the dot, so such K is read once per tile (correct, not fast).
//   Rows whose byte length or base address is not a multiple of 16 take a
//   one-element-per-lane path (correct, not fast).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileCols = 1024;
constexpr int kFinalizeCols = 32;

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T x[VEC];
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() { return __float2bfloat16(0.f); }

// Loads this lane's C chunks of one row's column tile; chunks past m are 0.
template <typename T, int VEC, int C>
__device__ __forceinline__ void load_tile(const T* __restrict__ row, int tile0, int m, int lane,
                                          Pack<T, VEC> (&dst)[C]) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int col = tile0 + c * 32 * VEC + lane * VEC;
    if (col < m) {
      dst[c] = *reinterpret_cast<const Pack<T, VEC>*>(row + col);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) dst[c].x[j] = zero<T>();
    }
  }
}

// v for this lane's VEC columns of chunk c, from shared memory. v_s holds
// the tile in groups of G = min(VEC, 4) floats ordered (chunk, group, lane),
// so a warp's float4 reads are 512 consecutive bytes: no bank conflicts.
template <int VEC>
__device__ __forceinline__ void load_v(const float* v_s, int c, int lane, float (&out)[VEC]) {
  constexpr int G = VEC >= 4 ? 4 : 1;
  constexpr int NG = VEC / G;
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    const float* p = v_s + ((c * NG + g) * 32 + lane) * G;
    if constexpr (G == 4) {
      const float4 w = *reinterpret_cast<const float4*>(p);
      out[g * 4 + 0] = w.x;
      out[g * 4 + 1] = w.y;
      out[g * 4 + 2] = w.z;
      out[g * 4 + 3] = w.w;
    } else {
      out[g] = p[0];
    }
  }
}

// Row sweep: u for every row, and per-CTA partial column sums of u_i * K_ij
// over the CTA's rows and its column tile (blockIdx.y). kMultiTile is false
// when one tile covers the row (gridDim.y == 1). For bfloat16 K the launch
// bound asks for at least two CTAs per SM.
template <typename T, int VEC, int C, bool kMultiTile>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 2 ? 2 : 1)
    scaling_rows_kernel(const T* __restrict__ K, const float* __restrict__ a,
                        const float* __restrict__ v, float* __restrict__ u,
                        float* __restrict__ partial, long long n, int m) {
  constexpr int kStride = 32 * VEC;  // columns one warp covers per chunk
  constexpr int kTile = kStride * C;  // columns this CTA folds
  constexpr int G = VEC >= 4 ? 4 : 1;
  constexpr int NG = VEC / G;
  __shared__ float col_sum[kTile];
  __shared__ __align__(16) float v_s[kTile];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tile = blockIdx.y;
  const int n_tiles = gridDim.y;
  const int tile0 = tile * kTile;

  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const int q = i % G, l = (i / G) % 32, g = (i / (G * 32)) % NG, c = i / (G * 32 * NG);
    const int col = tile0 + c * kStride + l * VEC + g * G + q;
    v_s[i] = col < m ? v[col] : 0.f;
  }
  __syncthreads();

  float acc[C][VEC];
#pragma unroll
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[c][j] = 0.f;
  }

  const long long warp_stride = static_cast<long long>(gridDim.x) * kWarps;
  long long r = static_cast<long long>(blockIdx.x) * kWarps + warp;
  Pack<T, VEC> cur[C];
  Pack<T, VEC> nxt[C];
  float a_cur = 0.f, a_nxt = 0.f;
  if (r < n) {
    load_tile<T, VEC, C>(K + r * m, tile0, m, lane, cur);
    a_cur = a[r];
  }

  for (; r < n; r += warp_stride) {
    const long long r_next = r + warp_stride;
    if (r_next < n) {
      load_tile<T, VEC, C>(K + r_next * m, tile0, m, lane, nxt);
      a_nxt = a[r_next];
    }

    // The dot runs over the whole row, tile by tile in column order, so
    // every CTA of the row computes the same u_i bit for bit.
    float dot = 0.f;
    for (int t = 0; t < n_tiles; ++t) {
      if (t == tile) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          float vc[VEC];
          load_v<VEC>(v_s, c, lane, vc);
#pragma unroll
          for (int j = 0; j < VEC; ++j) dot = fmaf(to_float(cur[c].x[j]), vc[j], dot);
        }
      } else if constexpr (kMultiTile) {
        Pack<T, VEC> other[C];
        load_tile<T, VEC, C>(K + r * m, t * kTile, m, lane, other);
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int col = t * kTile + c * kStride + lane * VEC;
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            const float vj = col < m ? v[col + j] : 0.f;
            dot = fmaf(to_float(other[c].x[j]), vj, dot);
          }
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);

    const float ai = a_cur;
    const float ui = ai > 0.f ? ai / fmaxf(dot, 1e-30f) : 0.f;
    if (tile == 0 && lane == 0) u[r] = ui;
    if (ui != 0.f) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[c][j] = fmaf(ui, to_float(cur[c].x[j]), acc[c][j]);
      }
    }
    if (r_next < n) {
#pragma unroll
      for (int c = 0; c < C; ++c) cur[c] = nxt[c];
      a_cur = a_nxt;
    }
  }

  // Sum the warps' accumulators in warp order, then write this CTA's partial row.
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const int i = c * kStride + lane * VEC + j;
          col_sum[i] = (w == 0 ? 0.f : col_sum[i]) + acc[c][j];
        }
      }
    }
    __syncthreads();
  }
  float* out = partial + static_cast<long long>(blockIdx.x) * m;
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const int col = tile0 + i;
    if (col < m) out[col] = col_sum[i];
  }
}

// v'_j = b_j / max(sum_p partial[p, j], 1e-30). A CTA owns kFinalizeCols
// columns; warp w sums parts w, w + kWarps, ... and the warps' sums are
// added in warp order.
__global__ void __launch_bounds__(kThreads)
    scaling_finalize_kernel(const float* __restrict__ partial, int n_parts,
                            const float* __restrict__ b, float* __restrict__ v_out, int m) {
  __shared__ float sums[kWarps][kFinalizeCols];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col = blockIdx.x * kFinalizeCols + lane;
  float s = 0.f;
  if (col < m) {
    for (int p = warp; p < n_parts; p += kWarps) s += partial[static_cast<long long>(p) * m + col];
  }
  sums[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && col < m) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += sums[w][lane];
    const float bj = b[col];
    v_out[col] = bj > 0.f ? bj / fmaxf(total, 1e-30f) : 0.f;
  }
}

struct Plan {
  int vec;    // elements per lane load: 16 bytes' worth, or 1
  int chunks; // loads per lane per row tile
  int tiles;  // column tiles (grid.y)
};

template <typename T>
Plan make_plan(const void* K, long long m) {
  constexpr int kVec16 = 16 / sizeof(T);
  const bool aligned = (m * sizeof(T)) % 16 == 0 && reinterpret_cast<uintptr_t>(K) % 16 == 0;
  const int vec = aligned ? kVec16 : 1;
  const int max_chunks = vec == 1 ? 8 : kTileCols / (32 * vec);
  int chunks = 1;
  while (chunks < max_chunks && 32LL * vec * chunks < m) chunks *= 2;
  const long long tile = 32LL * vec * chunks;
  return Plan{vec, chunks, static_cast<int>((m + tile - 1) / tile)};
}

template <typename T, int VEC, int C, bool kMultiTile>
int parts_for(long long n, int* parts) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, scaling_rows_kernel<T, VEC, C, kMultiTile>, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long want = (n + kWarps - 1) / kWarps;
  long long cap = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  long long p = want < cap ? want : cap;
  *parts = static_cast<int>(p > 0 ? p : 1);
  return 0;
}

template <typename T, int VEC, int C, bool kMultiTile>
int launch(const void* K, const float* a, const float* b, const float* v, float* u, float* v_out,
           float* workspace, int n_parts, long long n, long long m, int tiles,
           cudaStream_t stream) {
  dim3 grid(n_parts, tiles);
  scaling_rows_kernel<T, VEC, C, kMultiTile><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(K), a, v, u, workspace, n, static_cast<int>(m));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = static_cast<int>((m + kFinalizeCols - 1) / kFinalizeCols);
  scaling_finalize_kernel<<<blocks, kThreads, 0, stream>>>(workspace, n_parts, b, v_out,
                                                           static_cast<int>(m));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC, int C, template <typename, int, int, bool> class F,
          typename... Args>
int with_tiles(const Plan& plan, Args... args) {
  return plan.tiles > 1 ? F<T, VEC, C, true>::run(args...) : F<T, VEC, C, false>::run(args...);
}

// Calls F<T, VEC, C, multi_tile>::run(args...) for the plan.
template <typename T, template <typename, int, int, bool> class F, typename... Args>
int dispatch(const Plan& plan, Args... args) {
  constexpr int V = 16 / sizeof(T);
  if (plan.vec == V) {
    switch (plan.chunks) {
      case 1: return with_tiles<T, V, 1, F>(plan, args...);
      case 2: return with_tiles<T, V, 2, F>(plan, args...);
      case 4: return with_tiles<T, V, (4 * V * 32 <= kTileCols ? 4 : 1), F>(plan, args...);
      case 8: return with_tiles<T, V, (8 * V * 32 <= kTileCols ? 8 : 1), F>(plan, args...);
    }
  } else {
    switch (plan.chunks) {
      case 1: return with_tiles<T, 1, 1, F>(plan, args...);
      case 2: return with_tiles<T, 1, 2, F>(plan, args...);
      case 4: return with_tiles<T, 1, 4, F>(plan, args...);
      case 8: return with_tiles<T, 1, 8, F>(plan, args...);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int VEC, int C, bool kMultiTile>
struct PartsFn {
  static int run(long long n, int* parts) { return parts_for<T, VEC, C, kMultiTile>(n, parts); }
};

template <typename T, int VEC, int C, bool kMultiTile>
struct LaunchFn {
  static int run(const void* K, const float* a, const float* b, const float* v, float* u,
                 float* v_out, float* workspace, int n_parts, long long n, long long m, int tiles,
                 cudaStream_t stream) {
    return launch<T, VEC, C, kMultiTile>(K, a, b, v, u, v_out, workspace, n_parts, n, m, tiles,
                                         stream);
  }
};

}  // namespace

extern "C" {

// dtype: 0 for float32 K, 1 for bfloat16 K. Writes the number of partial
// rows (the first dimension of the float32 workspace, n_parts x m) that
// scaling_iteration_launch needs for this K.
int scaling_iteration_parts(int dtype, const void* K, long long n, long long m, int* n_parts) {
  if (m <= 0 || m > 0x7fffffffLL || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return dispatch<float, PartsFn>(make_plan<float>(K, m), n, n_parts);
  if (dtype == 1)
    return dispatch<__nv_bfloat16, PartsFn>(make_plan<__nv_bfloat16>(K, m), n, n_parts);
  return static_cast<int>(cudaErrorInvalidValue);
}

// One iteration on `stream`: u (n,) and v_out (m,) from K, a, b, v.
// Returns cudaGetLastError() after the launches (0 on success).
int scaling_iteration_launch(int dtype, const void* K, const float* a, const float* b,
                             const float* v, float* u, float* v_out, float* workspace,
                             int n_parts, long long n, long long m, void* stream) {
  if (m <= 0 || m > 0x7fffffffLL || n < 0 || n_parts <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const Plan plan = make_plan<float>(K, m);
    return dispatch<float, LaunchFn>(plan, K, a, b, v, u, v_out, workspace, n_parts, n, m,
                                     plan.tiles, s);
  }
  if (dtype == 1) {
    const Plan plan = make_plan<__nv_bfloat16>(K, m);
    return dispatch<__nv_bfloat16, LaunchFn>(plan, K, a, b, v, u, v_out, workspace, n_parts, n, m,
                                             plan.tiles, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
