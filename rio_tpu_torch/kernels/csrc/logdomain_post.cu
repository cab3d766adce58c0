// After the log-domain solve: each row's seat from the potentials, and the
// plan's column sums for the column-marginal error, in one read of the cost.
//
// Replaces no TPU kernel. The JAX package rounds from the potentials with
// plain jnp (rio_tpu/ops/sinkhorn.py, plan_rounded_assign) and takes the
// error with plain jnp (marginal_err), and so did the port's log-domain step:
// on the H100, at 1,048,576 x 1024 float32, the rounding per 65,536-row chunk
// (where, add, mul, softmax, cumsum, the compare; kernel 6 takes only rows of
// at most 32 columns) wrote and re-read 256 MB float32 temporaries for ~30.5
// ms a step, and marginal_err's five whole-matrix float32 passes took ~26.3
// ms: ~44 reads of the cost's 4 GiB. Both need the same logit of the final
// plan, so this kernel reads the cost once for both.
//
// Given float32 C (n, m), f (n), g (m), q (n) and inv_eps, the float32 1 / eps,
// for each row i:
//
//   x_ij  = ((f_i + g_j) - C_ij) * inv_eps    where f_i is finite
//         = 0 if g_j is finite else -inf       on a padding row
//   e_ij  = exp(x_ij - max_j x_ij)
//   c_ij  = e_i0 + ... + e_ij                  (summed in this kernel's order)
//   idx_i = min(#{j : c_ij < q_i * max(c_i,m-1, 1e-30)}, m - 1)
//
// and, over the rows with a finite f_i, each column's sum of exp(x_ij), with a
// logit that is not finite adding 0. The rows kernel writes one row of
// column sums a CTA to an (n_parts, m) workspace; the finalize kernel sums
// the parts in a fixed order and writes err = sum_j |col_j - b_j|. That is
// rio_tpu_torch.ops.potential_round.potential_round_ref's seat (its softmax
// CDF compared with q) and rio_tpu_torch.ops.sinkhorn.marginal_err; only the
// order of the float sums, the approximate base-2 exponentials and the
// threshold's place differ, so a seat can differ only where a row's CDF meets
// its quantile within float rounding. No atomics: the same inputs give the
// same bits from run to run.
//
// Bound. C once, f and q read and idx written, g and b read: 4nm + 12n + 8m
// bytes, 4,307,558,400 B at 1,048,576 x 1024, ~1.286 ms at the H100's 3.35
// TB/s. One exponential an element (exp(x) = exp(x - max) exp(max)): 2^30
// at 16 a clock on each of 132 SMs at 1.98 GHz take ~0.26 ms, and the other
// ~20 float32 instructions an element about as long again. The bytes bind,
// if the arithmetic overlaps the loads.
//
// Design, for that bound (kernel 2's grid, kernel 3's rounding):
// * A persistent grid, two CTAs of 8 warps an SM; a warp owns one row at a
//   time and holds it in registers (32 floats a lane at m = 1024, 16-byte
//   loads, neighbouring lanes on neighbouring addresses). The 16 warps of an
//   SM keep its loads in flight: a warp loads its next row after it has
//   written its seat, with no second row in registers.
// * g is staged once a CTA in shared memory, in column order: a warp's float4
//   reads are 512 consecutive bytes.
// * The rounding: a warp max of x, then e = 2^((x - max) log2 e) and each
//   lane's running sums over its columns; one five-step shuffle scan a chunk
//   gives each lane the offset of its run and the chunks' totals the row's
//   total; each lane counts its columns below the threshold and a warp
//   reduction adds the counts.
// * The column sums: exp(x) = e * 2^(max log2 e), one more exponential a row;
//   where that factor overflows, a row takes 2^(x log2 e) element by element.
//   Each lane keeps one float accumulator for each of its columns over the
//   rows its warp visits; at the end the CTA merges its warps in warp order
//   into shared memory and writes its workspace row.
// * What a row decides (real or padding; exp(max) finite or not) is the same
//   for the whole warp, so each case is a branch around a whole loop, never a
//   test of each element.
// * Rows wider than 1024 columns, or whose byte length or base address is
//   not a multiple of 16, take logdomain_post_any_kernel: one column a lane,
//   32 columns a step, three passes over the row (its max; the total and the
//   column sums; the count), each warp with its own workspace row of column
//   sums (correct, not fast). Every CUDA cost launches one of the two; the
//   plain twin (rio_tpu_torch/ops/logdomain_post.py) serves CPU tensors.
//
// Measured on an H100 80GB HBM3 at 700 W, the rows kernel at 1,048,576 x 1024
// on a converged solve (CUDA-event medians of 15 batches of 10 launches):
// 1.443 ms, 89% of the bytes bound, 118 registers, no spills. Per-element
// tests of the row's cases took 3.557 ms (36%, 155 registers); the warp-
// uniform branches with one CTA an SM and the next row prefetched into
// registers 1.894 ms (68%, 162 registers); two CTAs an SM with that prefetch
// 1.648 ms (78%, 128 registers); three CTAs an SM 2.282 ms (56%, 80
// registers). The finalize takes ~0.02 ms. The any kernel (38 registers, two
// CTAs an SM, 2,112 workspace rows): 12.2 ms at 1,048,576 x 1024 on a base 4
// bytes past 16, 12.3 ms at 1,048,576 x 1025, 12.2 at x 1001 (~10% of the
// bytes bound: a warp has one 128-byte load in flight), its finalize 0.07-0.12
// ms; the plain twin takes ~55.6 ms at these shapes.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kVec = 4;                   // floats a 16-byte load
constexpr int kStride = 32 * kVec;        // columns one chunk of a warp covers
constexpr int kMaxCols = 1024;            // widest row a warp holds in registers
constexpr int kFinalizeThreads = 1024;    // one column a thread at m <= 1024, more above
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000u); }
__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000u); }
__device__ __forceinline__ bool is_finite(float x) { return fabsf(x) < pos_inf(); }

// 2^x, one MUFU instruction; 2^-inf = 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = __fadd_rn(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

// Inclusive sum over the warp's lanes, lane order.
__device__ __forceinline__ float warp_inclusive_sum(float x, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(kFull, x, off);
    if (lane >= off) x = __fadd_rn(x, y);
  }
  return x;
}

struct alignas(16) Pack {
  float x[kVec];
};

// This lane's C chunks of one row; chunks past m are left as they are and
// never read (m is a multiple of 4, so a chunk is wholly in or out).
template <int C>
__device__ __forceinline__ void load_row(const float* __restrict__ row, int m, int lane,
                                         Pack (&dst)[C]) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int col = c * kStride + lane * kVec;
    if (col < m) dst[c] = *reinterpret_cast<const Pack*>(row + col);
  }
}

// Rows of at most C * 128 columns, C rows 16-byte aligned.
template <int C>
__global__ void __launch_bounds__(kThreads, 2)
    logdomain_post_rows_kernel(const float* __restrict__ cost, const float* __restrict__ f,
                               const float* __restrict__ g, const float* __restrict__ q,
                               int* __restrict__ idx, float* __restrict__ partial,
                               float inv_eps, long long n, int m) {
  constexpr int kTile = kStride * C;
  __shared__ __align__(16) float g_s[kTile];
  __shared__ float col_s[kTile];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < kTile; i += kThreads) g_s[i] = i < m ? g[i] : neg_inf();
  __syncthreads();

  float acc[C][kVec];  // this lane's column sums of exp(x) over the warp's rows
#pragma unroll
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) acc[c][j] = 0.f;
  }

  const long long warp_stride = static_cast<long long>(gridDim.x) * kWarps;
  for (long long r = static_cast<long long>(blockIdx.x) * kWarps + warp; r < n; r += warp_stride) {
    Pack cur[C];
    load_row<C>(cost + r * m, m, lane, cur);
    const float f_cur = f[r];
    const float q_cur = q[r];

    // The logits, in place of the row's costs; -inf past m. Whether the row
    // is real is the same for the whole warp, so each case is its own loop.
    const bool real = is_finite(f_cur);
    float xmax = neg_inf();
    if (real) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int col0 = c * kStride + lane * kVec;
        const float4 g4 = *reinterpret_cast<const float4*>(g_s + col0);
        const float gv[kVec] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const float x =
              col0 < m ? __fmul_rn(__fsub_rn(__fadd_rn(f_cur, gv[j]), cur[c].x[j]), inv_eps)
                       : neg_inf();
          cur[c].x[j] = x;
          xmax = fmaxf(xmax, x);
        }
      }
    } else {  // a padding row: uniform over the live columns
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int col0 = c * kStride + lane * kVec;
        const float4 g4 = *reinterpret_cast<const float4*>(g_s + col0);
        const float gv[kVec] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const float x = col0 < m && is_finite(gv[j]) ? 0.f : neg_inf();
          cur[c].x[j] = x;
          xmax = fmaxf(xmax, x);
        }
      }
    }
    xmax = warp_max(xmax);

    // exp(x - max) in place of the logits, and the column sums of exp(x).
    // Where exp(max) is finite, exp(x) = exp(x - max) exp(max) for every
    // column: a logit of -inf gives 0, a NaN gives NaN, which fmaxf turns to
    // 0, and +inf cannot occur (the max would be +inf). Else (a padding row,
    // or exp(max) overflows or is NaN) each column takes its own exponential.
    const float scale = ex2(__fmul_rn(xmax, kLog2e));
    if (real && scale < pos_inf()) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const float e = ex2(__fmul_rn(__fsub_rn(cur[c].x[j], xmax), kLog2e));
          acc[c][j] = __fadd_rn(acc[c][j], fmaxf(__fmul_rn(e, scale), 0.f));
          cur[c].x[j] = e;
        }
      }
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c) {
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const float x = cur[c].x[j];
          if (real && is_finite(x)) acc[c][j] = __fadd_rn(acc[c][j], ex2(__fmul_rn(x, kLog2e)));
          cur[c].x[j] = ex2(__fmul_rn(__fsub_rn(x, xmax), kLog2e));
        }
      }
    }

    // The row's CDF of e, counted against q times its total (kernel 3's form).
    float base[C];      // the row's sum of e before this lane's run of chunk c
    float carry = 0.f;  // the row's sum of e over the chunks done
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        s = __fadd_rn(s, cur[c].x[j]);
        cur[c].x[j] = s;
      }
      const float incl = warp_inclusive_sum(s, lane);
      const float excl = __shfl_up_sync(kFull, incl, 1);
      base[c] = lane == 0 ? carry : __fadd_rn(carry, excl);
      carry = __fadd_rn(carry, __shfl_sync(kFull, incl, 31));
    }
    const float thr = __fmul_rn(q_cur, fmaxf(carry, 1e-30f));
    int below = 0;
#pragma unroll
    for (int c = 0; c < C; ++c) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const int col = c * kStride + lane * kVec + j;
        below += (col < m && __fadd_rn(base[c], cur[c].x[j]) < thr) ? 1 : 0;
      }
    }
    below = __reduce_add_sync(kFull, below);
    if (lane == 0) idx[r] = below < m ? below : m - 1;
  }

  // Merge the warps' sums in warp order, then write this CTA's partial row.
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const int i = c * kStride + lane * kVec + j;
          col_s[i] = w == 0 ? acc[c][j] : __fadd_rn(col_s[i], acc[c][j]);
        }
      }
    }
    __syncthreads();
  }
  float* out = partial + static_cast<long long>(blockIdx.x) * m;
  for (int i = threadIdx.x; i < m; i += kThreads) out[i] = col_s[i];
}

// The logit of column j of a row (see the top of this file).
__device__ __forceinline__ float logit(const float* __restrict__ row, const float* __restrict__ g,
                                       float f_r, bool real, float inv_eps, int j) {
  const float gj = g[j];
  if (real) return __fmul_rn(__fsub_rn(__fadd_rn(f_r, gj), row[j]), inv_eps);
  return is_finite(gj) ? 0.f : neg_inf();
}

// Any row: one column a lane, 32 columns a step. Warp w of CTA b owns row
// b * kWarps + w of the workspace and adds each of its rows' exp(x) to it,
// column by column, in row order. The running sum at column j is the steps'
// carry plus the lane's inclusive sum, computed the same way in the second
// and third passes, so the total the second pass finds is the running sum
// at column m - 1.
__global__ void __launch_bounds__(kThreads)
    logdomain_post_any_kernel(const float* __restrict__ cost, const float* __restrict__ f,
                              const float* __restrict__ g, const float* __restrict__ q,
                              int* __restrict__ idx, float* __restrict__ partial,
                              float inv_eps, long long n, int m) {
  const int lane = threadIdx.x & 31;
  const long long part = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  float* __restrict__ col = partial + part * m;  // only this lane's columns, by this lane
  for (int j = lane; j < m; j += 32) col[j] = 0.f;

  const long long warp_stride = static_cast<long long>(gridDim.x) * kWarps;
  for (long long r = part; r < n; r += warp_stride) {
    const float* row = cost + r * m;
    const float f_r = f[r];
    const bool real = is_finite(f_r);

    float xmax = neg_inf();
    for (int j = lane; j < m; j += 32) xmax = fmaxf(xmax, logit(row, g, f_r, real, inv_eps, j));
    xmax = warp_max(xmax);

    float carry = 0.f;  // the row's sum of e over the steps done
    for (int s = 0; s < m; s += 32) {
      const int j = s + lane;
      float e = 0.f;
      if (j < m) {
        const float x = logit(row, g, f_r, real, inv_eps, j);
        e = ex2(__fmul_rn(__fsub_rn(x, xmax), kLog2e));
        if (real && is_finite(x)) col[j] = __fadd_rn(col[j], ex2(__fmul_rn(x, kLog2e)));
      }
      carry = __fadd_rn(carry, __shfl_sync(kFull, warp_inclusive_sum(e, lane), 31));
    }

    const float thr = __fmul_rn(q[r], fmaxf(carry, 1e-30f));
    int below = 0;
    carry = 0.f;
    for (int s = 0; s < m; s += 32) {
      const int j = s + lane;
      const bool in = j < m;
      const float e =
          in ? ex2(__fmul_rn(__fsub_rn(logit(row, g, f_r, real, inv_eps, j), xmax), kLog2e)) : 0.f;
      const float incl = warp_inclusive_sum(e, lane);
      below += (in && __fadd_rn(carry, incl) < thr) ? 1 : 0;
      carry = __fadd_rn(carry, __shfl_sync(kFull, incl, 31));
    }
    below = __reduce_add_sync(kFull, below);
    if (lane == 0) idx[r] = below < m ? below : m - 1;
  }
}

// err = sum_j |sum_p partial[p, j] - b_j|: thread t sums columns t,
// t + 1024, ... over the parts in order, then the block adds the threads'
// terms lane by lane and warp by warp, in a fixed order.
__global__ void __launch_bounds__(kFinalizeThreads)
    logdomain_post_finalize_kernel(const float* __restrict__ partial, int n_parts,
                                   const float* __restrict__ b, float* __restrict__ err, int m) {
  __shared__ float warp_terms[kFinalizeThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float term = 0.f;
  for (int j = threadIdx.x; j < m; j += kFinalizeThreads) {
    float col = 0.f;
#pragma unroll 8
    for (int p = 0; p < n_parts; ++p) col = __fadd_rn(col, partial[static_cast<long long>(p) * m + j]);
    term = __fadd_rn(term, fabsf(__fsub_rn(col, b[j])));
  }
  term = warp_sum(term);
  if (lane == 0) warp_terms[warp] = term;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < kFinalizeThreads / 32; ++w) total = __fadd_rn(total, warp_terms[w]);
    *err = total;
  }
}

using RowsFn = void (*)(const float*, const float*, const float*, const float*, int*, float*, float,
                        long long, int);

// The rows kernel with the fewest chunks that cover the row, or, for any
// other row, the any kernel (*per_cta: the workspace rows a CTA writes).
RowsFn kernel_for(const void* cost, long long m, int* per_cta) {
  const bool aligned = m % kVec == 0 && reinterpret_cast<uintptr_t>(cost) % 16 == 0;
  *per_cta = 1;
  if (!aligned || m > kMaxCols) {
    *per_cta = kWarps;
    return logdomain_post_any_kernel;
  }
  if (m <= kStride) return logdomain_post_rows_kernel<1>;
  if (m <= 2 * kStride) return logdomain_post_rows_kernel<2>;
  if (m <= 4 * kStride) return logdomain_post_rows_kernel<4>;
  return logdomain_post_rows_kernel<kMaxCols / kStride>;
}

}  // namespace

extern "C" {

// Writes the number of partial rows (the first dimension of the float32
// workspace, n_parts x m) that logdomain_post_launch needs for this C: a
// row for every resident CTA of the rows kernel, or for every warp of the
// any kernel at up to two CTAs an SM; fewer when n has fewer rows, and at
// least one CTA's.
int logdomain_post_parts(const void* cost, long long n, long long m, int* n_parts) {
  if (n < 0 || m <= 0 || m > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  int per_cta = 1;
  const RowsFn kernel = kernel_for(cost, m, &per_cta);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) per_sm = 1;
  if (per_cta > 1 && per_sm > 2) per_sm = 2;  // bounds the any kernel's workspace
  const long long want = (n + kWarps - 1) / kWarps;
  const long long cap = static_cast<long long>(sms) * per_sm;
  const long long blocks = want < cap ? (want > 0 ? want : 1) : cap;
  *n_parts = static_cast<int>(blocks * per_cta);
  return 0;
}

// The rows pass on `stream`: idx (n,) int32 and the workspace's n_parts rows
// of column sums from C, f, g, q and inv_eps, n_parts as
// logdomain_post_parts wrote it. Returns cudaGetLastError() after the launch
// (0 on success). With no rows it writes zero sums.
int logdomain_post_launch(const void* cost, const float* f, const float* g, const float* q,
                          int* idx, float* partial, int n_parts, float inv_eps, long long n,
                          long long m, void* stream) {
  if (n < 0 || m <= 0 || m > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  int per_cta = 1;
  const RowsFn kernel = kernel_for(cost, m, &per_cta);
  if (n_parts <= 0 || n_parts % per_cta) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<n_parts / per_cta, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cost), f, g, q, idx, partial, inv_eps, n, static_cast<int>(m));
  return static_cast<int>(cudaGetLastError());
}

// The finalize on `stream`: err (one float32) from the workspace's n_parts
// rows of m column sums and b (m). Returns cudaGetLastError() after the
// launch (0 on success).
int logdomain_post_finalize(const float* partial, int n_parts, const float* b, float* err,
                            long long m, void* stream) {
  if (m <= 0 || m > INT_MAX || n_parts <= 0) return static_cast<int>(cudaErrorInvalidValue);
  logdomain_post_finalize_kernel<<<1, kFinalizeThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      partial, n_parts, b, err, static_cast<int>(m));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
