// Rounding of the soft plan from its potentials, for rows of at most 32
// columns, in one read of the cost.
//
// Replaces no TPU kernel. The JAX package rounds with plain jnp
// (rio_tpu/ops/sinkhorn.py, plan_rounded_assign), and so did the port: on the
// H100 the eager chain wrote and re-read (rows x m) float32 temporaries for
// the logit, the padding where, the softmax, the cumsum and the compare, and
// PyTorch's innermost scan gave each 32-wide row its own 512-thread block
// (ATen's get_log_num_threads_x_inner_scan<uint32_t> wraps on log2(m) -
// log2(rows) < 0 and clamps to 9): ~9 ms a chunk of the two-level solve,
// ~137 ms of its scans a 10,485,760-object solve. This kernel reads the cost
// once and writes one int32 a row.
//
// Given float32 cost C (B, n, m), f (B, n), g (B, m) and q (B, n), with
// m <= 32 and inv_eps the float32 1 / eps, for each row i of each problem:
//
//   x_ij  = ((f_i + g_j) - C_ij) * inv_eps     where f_i is finite
//         = 0 if g_j is finite else -inf        on a padding row
//   p_ij  = softmax_j(x_ij)
//   c_ij  = p_i0 + ... + p_ij
//   idx_i = min(#{j : c_ij < q_i}, m - 1)
//
// bit for bit as the eager chain gives it on the card
// (rio_tpu_torch.ops.potential_round.potential_round_ref), because each step
// takes PyTorch's own order for this shape:
// * The logit is three correctly rounded operations, the last a multiply:
//   PyTorch divides a CUDA tensor by a host scalar as a multiply by the
//   float32 reciprocal. __fadd_rn/__fsub_rn/__fmul_rn keep nvcc from
//   contracting any of them into an FMA.
// * The softmax is softmax_warp_forward's (ATen PersistentSoftmax.cuh) for a
//   row of m <= 32: the row's max, expf(x - max), an xor-butterfly sum, then
//   e / sum, NaN where the sum is 0. That kernel shuffles over width
//   next_pow2(m); here the butterfly spans the warp, and the lanes past the
//   width hold exp(-inf - max) = 0, so their steps leave every lane below the
//   width as it was (a float sum is the same both ways round, so every lane
//   holds the one tree sum). The max is one __reduce_max_sync over each
//   float's order key: without a NaN that is the same value as the butterfly
//   of a < b ? b : a, but for the sign of a zero, and x - (+0) and x - (-0)
//   are equal but for x = -0, where both exponentials are 1. A NaN in the row,
//   or a max that is not finite, makes every p of the row NaN either way.
// * The CDF is tensor_kernel_scan_innermost_dim's Sklansky scan (ATen
//   ScanUtils.cuh): at step k = 0..4 a lane with bit k set adds the value of
//   lane ((lane >> k) << k) - 1. Values flow only to higher lanes, so the
//   lanes past m (0 there, or NaN where the row is NaN) change nothing below.
// * idx counts the lanes below m whose sum is below q, as
//   (cum < q).sum(-1) does, and is clamped to m - 1.
//
// Bound. B n m float32 of cost and 3 B n floats of f, q and idx: at the
// two-level solve's coarse stage (655,360 x 32) 91.8 MB, 0.027 ms at the
// H100's 3.35 TB/s; at its fine stage (32 x 25,600 x 32) 114.7 MB, 0.034 ms.
// A row costs 12 warp shuffles, a warp reduction and a ballot, a correctly
// rounded exponential and division: ~100 instructions a row of 32 columns,
// so the issue of instructions, not the bytes, sets the pace.
//
// Design: one warp a tile of 32 rows of one problem, one lane a column.
// The warp issues all 32 rows' loads at once (one 128-byte line a row at
// m = 32), loads the tile's f and q with one coalesced load each and hands
// them to each row by shuffle, rounds the rows in turn in registers, keeps
// row r's seat in lane r and stores the tile's 32 seats with one store. No
// shared memory, no atomics. Measured on an H100 80GB HBM3 at 700 W, on the
// roundings of a two-level solve of 655,360 objects: 0.122 ms at 655,360 x 32
// and 0.200 ms at 32 x 25,600 x 32 (61 registers, no spills), against 4.5
// and 5.6 ms for the eager chain. The butterfly max with a break past the
// last row took 0.160 and 0.250 ms (80 registers, spills, 9,480 SASS
// instructions against 3,368); rounding two or four rows side by side took
// 3-4% less than one.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 32;  // rows a warp rounds in one tile
constexpr unsigned kFull = 0xffffffffu;

// A float's bits as an int that orders as the float does (NaN aside), and back.
__device__ __forceinline__ int order_key(float x) {
  const int b = __float_as_int(x);
  return b ^ ((b >> 31) & 0x7fffffff);
}
__device__ __forceinline__ float from_key(int k) { return __int_as_float(k ^ ((k >> 31) & 0x7fffffff)); }

__global__ void __launch_bounds__(kThreads)
    potential_round_kernel(const float* __restrict__ cost, const float* __restrict__ f,
                           const float* __restrict__ g, const float* __restrict__ q,
                           int* __restrict__ out, long long tiles_per_problem, long long tiles,
                           long long n, int m, float inv_eps) {
  const long long tile = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (tile >= tiles) return;  // uniform over the warp
  const int lane = threadIdx.x & 31;
  const long long b = tile / tiles_per_problem;
  const long long r0 = (tile - b * tiles_per_problem) * kRows;
  const int rows = static_cast<int>(min(static_cast<long long>(kRows), n - r0));
  const long long base = b * n + r0;  // the tile's first row of all B * n

  const bool col = lane < m;
  const float gl = col ? g[b * m + lane] : -INFINITY;
  const float pad_x = isfinite(gl) ? 0.f : -INFINITY;
  const float fl = lane < rows ? f[base + lane] : 0.f;
  const float ql = lane < rows ? q[base + lane] : 0.f;
  float c[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    c[r] = col && r < rows ? cost[(base + r) * m + lane] : 0.f;
  }

  // Every lane runs every row, so no shuffle sits in a branch; the seats of
  // rows past `rows` (rounded from zeros) are dropped.
  int seat = 0;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float fr = __shfl_sync(kFull, fl, r);
    float x = -INFINITY;
    if (col) x = isfinite(fr) ? __fmul_rn(__fsub_rn(__fadd_rn(fr, gl), c[r]), inv_eps) : pad_x;
    const float e = expf(__fsub_rn(x, from_key(__reduce_max_sync(kFull, order_key(x)))));
    float sum = e;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum = __fadd_rn(sum, __shfl_xor_sync(kFull, sum, off));
    float cum = sum == 0.f ? __int_as_float(0x7fffffff) : __fdiv_rn(e, sum);
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      const float v = __shfl_sync(kFull, cum, (((lane >> k) << k) - 1) & 31);
      if ((lane >> k) & 1) cum = __fadd_rn(cum, v);
    }
    const float qr = __shfl_sync(kFull, ql, r);  // not under the && below: every lane shuffles
    const unsigned below = __ballot_sync(kFull, col && cum < qr);
    if (lane == r) seat = min(__popc(below), m - 1);
  }
  if (lane < rows) out[base + lane] = seat;
}

}  // namespace

extern "C" {

// Writes out (batch * n,) int32 on `stream` from cost (batch, n, m), f
// (batch, n), g (batch, m) and q (batch, n) float32, all contiguous, for
// 1 <= m <= 32; returns cudaGetLastError() after the launch (0 on success;
// nothing is launched when there is no row).
int potential_round_launch(const float* cost, const float* f, const float* g, const float* q,
                           int* out, long long batch, long long n, long long m, float inv_eps,
                           void* stream) {
  if (batch < 0 || n < 0 || m < 1 || m > 32) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || n == 0) return 0;
  const long long per = (n + kRows - 1) / kRows;
  const long long tiles = batch * per;
  const long long blocks = (tiles + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  potential_round_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      cost, f, g, q, out, per, tiles, n, static_cast<int>(m), inv_eps);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
