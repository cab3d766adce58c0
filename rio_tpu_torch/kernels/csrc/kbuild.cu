// The scaling solve's kernel matrix K and its per-row shift, in one read of
// the cost.
//
// Replaces no TPU kernel. The JAX package builds K with plain jnp
// (rio_tpu/ops/scaling.py, scaling_kernel), and so did the port: on the H100
// the eager form made five passes over the float32 cost or a float32
// temporary of its size (the row min, the subtract, the divide, the exp, the
// cast), about 34 GiB of traffic and 13.5 ms at 1,048,576 x 1024. This
// kernel reads the cost once and writes K once.
//
// Given a float32 cost C (n, m) and a scale s, for each row i:
//
//   shift_i = min_j C_ij     (NaN if the row holds a NaN, as torch.min)
//           = 0              where that is not finite
//   K_ij    = exp((C_ij - shift_i) * s)   rounded to K's dtype
//
// with s = 1 / (-eps) in float32. That is PyTorch's own arithmetic for
// `(C - shift).div_(-eps).exp_().to(dtype)` on a CUDA tensor: its division
// by a host scalar multiplies by the float32 reciprocal. The subtract and
// the multiply round to nearest (__fsub_rn, __fmul_rn: no contraction into
// an fma), expf is the accurate libdevice function that torch.exp calls (the
// build has no fast-math), and the cast is __float2bfloat16_rn, as
// c10::BFloat16 on sm_80 and later. So K's bits equal the eager form's.
//
// Bound. Per element one subtract, one multiply and one exponential, read
// as 4 bytes and written as 2 (bfloat16 K): the kernel is bound by bytes.
// At 1,048,576 x 1024 bfloat16 that is 4 GiB read and 2 GiB written plus
// the 4 MB shift, 6.44e9 B, ~1.92 ms at the H100's 3.35 TB/s.
//
// Design, for that bound:
// * A warp owns one row at a time and the grid is persistent, as in
//   cdf_round.cu. A row of up to 1024 columns stays in registers: each lane
//   holds C chunks of 4 contiguous floats (chunk c, lane l: columns
//   c*128 + l*4 ...), loaded as 16 bytes with neighbouring lanes on
//   neighbouring addresses. At 62 registers a thread four CTAs, 32 warps,
//   share an SM, and their rows in flight, 128 KB an SM, cover the memory's
//   latency: a form that also loaded each warp's next row before reducing
//   the current one (93 registers, two CTAs) took the same time.
// * The row min is a per-lane min over the registers and a five-step
//   shuffle reduction; no shared memory, no atomics.
// * Each lane writes its chunk as 8 bytes (bfloat16) or 16 bytes (float32),
//   so a warp's store covers one contiguous run of the row.
// * Rows wider than 1024 columns, or whose byte length or base address is
//   not a multiple of 16, take kbuild_any_kernel: one column a lane, 32
//   columns a step, one pass for the min and a second for K (correct, not
//   fast).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxCols = 1024;  // widest row kbuild_rows_kernel holds in registers
constexpr unsigned kFull = 0xffffffffu;

// torch.min's rule: a NaN on either side wins.
__device__ __forceinline__ float nan_min(float a, float b) { return (a < b || a != a) ? a : b; }

__device__ __forceinline__ float warp_nan_min(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = nan_min(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__device__ __forceinline__ float finite_or_zero(float x) { return isfinite(x) ? x : 0.f; }

__device__ __forceinline__ float k_entry(float c, float shift, float scale) {
  return expf(__fmul_rn(__fsub_rn(c, shift), scale));
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
struct alignas(sizeof(T) * 4) Quad {
  T x[4];
};

// Loads this lane's C chunks of one row; chunks past m hold +inf, which no
// min takes (m is a multiple of 4, so a chunk is wholly inside or outside).
template <int C>
__device__ __forceinline__ void load_row(const float* __restrict__ row, int m, int lane,
                                         float4 (&dst)[C]) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int col = c * 128 + lane * 4;
    dst[c] = col < m ? *reinterpret_cast<const float4*>(row + col)
                     : make_float4(INFINITY, INFINITY, INFINITY, INFINITY);
  }
}

// Rows of at most C * 128 columns, cost rows 16-byte aligned.
template <typename T, int C>
__global__ void __launch_bounds__(kThreads, 4)
    kbuild_rows_kernel(const float* __restrict__ cost, T* __restrict__ K,
                       float* __restrict__ shift, long long n, int m, float scale) {
  const int lane = threadIdx.x & 31;
  const long long warp_stride = static_cast<long long>(gridDim.x) * kWarps;
  for (long long r = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5); r < n;
       r += warp_stride) {
    float4 x[C];
    load_row<C>(cost + r * m, m, lane, x);

    float lo = INFINITY;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      lo = nan_min(lo, x[c].x);
      lo = nan_min(lo, x[c].y);
      lo = nan_min(lo, x[c].z);
      lo = nan_min(lo, x[c].w);
    }
    const float s = finite_or_zero(warp_nan_min(lo));

    T* row = K + r * m;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = c * 128 + lane * 4;
      if (col < m) {
        Quad<T> q;
        q.x[0] = from_float<T>(k_entry(x[c].x, s, scale));
        q.x[1] = from_float<T>(k_entry(x[c].y, s, scale));
        q.x[2] = from_float<T>(k_entry(x[c].z, s, scale));
        q.x[3] = from_float<T>(k_entry(x[c].w, s, scale));
        *reinterpret_cast<Quad<T>*>(row + col) = q;
      }
    }
    if (lane == 0) shift[r] = s;
  }
}

// Any row: one column a lane, 32 columns a step, two passes over the row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    kbuild_any_kernel(const float* __restrict__ cost, T* __restrict__ K,
                      float* __restrict__ shift, long long n, int m, float scale) {
  const int lane = threadIdx.x & 31;
  const long long warp_stride = static_cast<long long>(gridDim.x) * kWarps;
  for (long long r = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5); r < n;
       r += warp_stride) {
    const float* in = cost + r * m;
    float lo = INFINITY;
    for (int col = lane; col < m; col += 32) lo = nan_min(lo, in[col]);
    const float s = finite_or_zero(warp_nan_min(lo));
    T* out = K + r * m;
    for (int col = lane; col < m; col += 32) out[col] = from_float<T>(k_entry(in[col], s, scale));
    if (lane == 0) shift[r] = s;
  }
}

template <typename T>
using KernelFn = void (*)(const float*, T*, float*, long long, int, float);

// A persistent grid: every resident CTA, or fewer when n has fewer rows.
template <typename T>
int launch(KernelFn<T> kernel, const float* cost, T* K, float* shift, long long n, int m,
           float scale, cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long want = (n + kWarps - 1) / kWarps;
  const long long cap = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const int blocks = static_cast<int>(want < cap ? want : cap);
  kernel<<<blocks, kThreads, 0, stream>>>(cost, K, shift, n, m, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_for(const float* cost, void* K, float* shift, long long n, int m, float scale,
               cudaStream_t stream) {
  const bool aligned = m % 4 == 0 && reinterpret_cast<uintptr_t>(cost) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(K) % 16 == 0;
  KernelFn<T> kernel = kbuild_any_kernel<T>;
  if (aligned && m <= kMaxCols) {  // the fewest chunks that cover the row
    if (m <= 128) {
      kernel = kbuild_rows_kernel<T, 1>;
    } else if (m <= 256) {
      kernel = kbuild_rows_kernel<T, 2>;
    } else if (m <= 512) {
      kernel = kbuild_rows_kernel<T, 4>;
    } else {
      kernel = kbuild_rows_kernel<T, kMaxCols / 128>;
    }
  }
  return launch<T>(kernel, cost, static_cast<T*>(K), shift, n, m, scale, stream);
}

}  // namespace

extern "C" {

// dtype: 0 for float32 K, 1 for bfloat16 K. Writes K (n, m) and shift (n,)
// float32 on `stream`; returns cudaGetLastError() after the launch (0 on
// success; nothing is launched for n == 0).
int kbuild_launch(int dtype, const float* cost, void* K, float* shift, long long n, long long m,
                  float scale, void* stream) {
  if (m <= 0 || m > 0x7fffffffLL || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int mi = static_cast<int>(m);
  if (dtype == 0) return launch_for<float>(cost, K, shift, n, mi, scale, s);
  if (dtype == 1) return launch_for<__nv_bfloat16>(cost, K, shift, n, mi, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
