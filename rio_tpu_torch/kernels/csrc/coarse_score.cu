// The coarse scores of the two-level solve: each object's best live member
// in each group of nodes, in one launch.
//
// Replaces no TPU kernel. The JAX package scores the groups one at a time
// with plain jnp (rio_tpu/parallel/hierarchical.py, a map over single
// groups), and so did the port, in blocks of groups: on the H100 a block's
// float32 GEMM wrote its (n, groups * S) scores, masked_fill wrote a masked
// copy, amax read it and a strided copy filled the result, ~11 GB of traffic
// a chunk of 655,360 objects for an 84 MB result and ~150 ms of a
// 10,485,760-object solve. This kernel writes only the result.
//
// Given float32 object features X (n, d), node features W (d, M), a bool
// live (M,) and G groups of S = M / G consecutive nodes, for each object i
// and group g:
//
//   out_ig = max over live j in g of  sum_k X_ik W_kj
//          = -inf where no member of g is live,
//
// a NaN score propagating as torch.amax propagates it (max.NaN.f32). Each
// dot product is one fmaf chain in k order 0 .. d-1 from +0.0, the order of
// a single-pass FFMA GEMM tile such as cuBLAS's, which the eager form ran.
// Features past d are zero in this kernel's registers, and fmaf(0, 0, acc)
// is acc for every acc such a chain makes (it never makes -0), so padding d
// up to a multiple of 4 leaves every bit as it is. No TF32, no atomics.
//
// Bound. 2 n M d float32 operations against n d + n G floats of traffic:
// at n = 655,360, d = 16, M = 1024 that is 21.5 GFLOP, 0.32 ms at the
// H100's 67 TFLOP/s without tensor cores, against 126 MB, 0.04 ms at
// 3.35 TB/s. The kernel is bound by its FMAs.
//
// Design, for that bound:
// * The grid is persistent, two CTAs of 256 threads an SM: each CTA takes an
//   equal run of rows and works through it in chunks of 256 * R rows, R = 4
//   consecutive rows a thread, their d features held in registers (at most
//   128 registers a thread, no spills at d = 16).
// * The node features of a tile of whole groups are staged once per CTA in
//   shared memory, feature-major, and only the live members: each group's
//   live members are packed (a warp ballot per 32 members) and padded to a
//   multiple of 4 by repeating its first live member, which leaves the max
//   unchanged. At d = 16 and M = 1024 every group fits one tile (64 KB). A
//   dead node costs nothing, and a group with no live member is an empty
//   loop that leaves -inf.
// * The inner loop takes 4 nodes at a time, unrolled twice: for each
//   feature k one broadcast float4 load from shared memory (feature k of the
//   4 nodes) feeds 4 R independent FMAs, so a thread runs 4 R chains at once
//   and shared memory is read once per 4 R FMAs.
// * Measured at n = 655,360, d = 16, M = 1024 on an H100 80GB HBM3 at 700 W:
//   0.59 ms a launch, 54% of the FMA bound, against 11.6 ms for the eager
//   form; 128 threads a CTA took 0.64 ms, 6 or 8 rows a thread 0.64-0.68.
// * Each CTA stages its (rows x 8 groups) results in shared memory and
//   writes them as whole runs of each row.
// * d over 32, or a group too wide for the shared-memory tile, takes
//   coarse_any_kernel: one thread a row, features and nodes read from
//   global memory (correct, not fast).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMinCtas = 2;  // CTAs an SM: 128 registers a thread at most
constexpr int kRowsPerThread = 4;  // R for d <= 16; 2 for d <= 32
constexpr int kNodeBytes = 64 * 1024;  // shared memory for a tile's node features
constexpr int kOutGroups = 8;  // groups of results staged before a write
constexpr unsigned kFull = 0xffffffffu;

// torch.amax's rule: a NaN on either side wins.
__device__ __forceinline__ float nan_max(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }

// D: features held per row (d padded to a multiple of 4); R: rows a thread.
template <int D, int R>
__global__ void __launch_bounds__(kThreads, kMinCtas)
    coarse_tiles_kernel(const float* __restrict__ obj, const float* __restrict__ node,
                        const unsigned char* __restrict__ live, float* __restrict__ out,
                        long long n, int d, int m, int groups, int s, int tile_groups,
                        int slot_cap, bool vec) {
  constexpr int kRows = kThreads * R;
  constexpr int kStride = kRows + 4;  // staged rows of one group; +4 spreads the reads over banks
  extern __shared__ float4 smem4[];
  float* feat = reinterpret_cast<float*>(smem4);  // [D][slot_cap], feature-major
  float* stage = feat + D * slot_cap;              // [kOutGroups][kStride]
  int* off = reinterpret_cast<int*>(stage + kOutGroups * kStride);  // [tile_groups + 1]
  int* slot_node = off + tile_groups + 1;                           // [slot_cap]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long per = n / gridDim.x, extra = n % gridDim.x;
  const long long r_lo = blockIdx.x * per + (blockIdx.x < extra ? blockIdx.x : extra);
  const long long r_hi = r_lo + per + (blockIdx.x < extra ? 1 : 0);

  for (int g0 = 0; g0 < groups; g0 += tile_groups) {
    const int ng = min(tile_groups, groups - g0);
    __syncthreads();  // the previous tile's readers are done
    if (warp == 0) {  // pack each group's live members, padded to a multiple of 4
      int used = 0;
      for (int gg = 0; gg < ng; ++gg) {
        const int first = (g0 + gg) * s;
        int count = 0;
        for (int base = 0; base < s; base += 32) {
          const int j = base + lane;
          const bool on = j < s && live[first + j];
          const unsigned mask = __ballot_sync(kFull, on);
          if (on) slot_node[used + count + __popc(mask & ((1u << lane) - 1u))] = first + j;
          count += __popc(mask);
        }
        __syncwarp();
        const int padded = round4(count);
        if (count + lane < padded) slot_node[used + count + lane] = slot_node[used];
        if (lane == 0) off[gg] = used;
        used += padded;
      }
      if (lane == 0) off[ng] = used;
    }
    __syncthreads();
    const int slots = off[ng];
    for (int k = 0; k < D; ++k) {
      for (int sl = tid; sl < slots; sl += kThreads) {
        feat[k * slot_cap + sl] = k < d ? node[static_cast<long long>(k) * m + slot_node[sl]] : 0.f;
      }
    }
    __syncthreads();

    for (long long c0 = r_lo; c0 < r_hi; c0 += kRows) {
      const int rows = static_cast<int>(min(static_cast<long long>(kRows), r_hi - c0));
      const bool active = warp * 32 * R < rows;  // uniform over the warp
      float x[R][D];
      if (active) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int row = tid * R + r;
          const float* src = obj + (c0 + (row < rows ? row : 0)) * d;
          if (vec) {
#pragma unroll
            for (int k = 0; k < D; k += 4) {
              const float4 q = *reinterpret_cast<const float4*>(src + k);
              x[r][k] = q.x;
              x[r][k + 1] = q.y;
              x[r][k + 2] = q.z;
              x[r][k + 3] = q.w;
            }
          } else {
#pragma unroll
            for (int k = 0; k < D; ++k) x[r][k] = k < d ? src[k] : 0.f;
          }
        }
      }
      for (int gs = 0; gs < ng; gs += kOutGroups) {
        const int nsub = min(kOutGroups, ng - gs);
        if (active) {
          for (int gg = 0; gg < nsub; ++gg) {
            float best[R];
#pragma unroll
            for (int r = 0; r < R; ++r) best[r] = -INFINITY;
            const int hi = off[gs + gg + 1];
#pragma unroll 2
            for (int sl = off[gs + gg]; sl < hi; sl += 4) {
              float acc[R][4];
#pragma unroll
              for (int r = 0; r < R; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
#pragma unroll
              for (int k = 0; k < D; ++k) {
                const float4 w = *reinterpret_cast<const float4*>(feat + k * slot_cap + sl);
#pragma unroll
                for (int r = 0; r < R; ++r) {
                  acc[r][0] = fmaf(x[r][k], w.x, acc[r][0]);
                  acc[r][1] = fmaf(x[r][k], w.y, acc[r][1]);
                  acc[r][2] = fmaf(x[r][k], w.z, acc[r][2]);
                  acc[r][3] = fmaf(x[r][k], w.w, acc[r][3]);
                }
              }
#pragma unroll
              for (int r = 0; r < R; ++r) {
                best[r] = nan_max(nan_max(best[r], acc[r][0]), nan_max(acc[r][1], acc[r][2]));
                best[r] = nan_max(best[r], acc[r][3]);
              }
            }
#pragma unroll
            for (int r = 0; r < R; ++r) stage[gg * kStride + tid * R + r] = best[r];
          }
        }
        __syncthreads();
        const int total = rows * nsub;
        for (int e = tid; e < total; e += kThreads) {
          const int row = e / nsub, c = e - row * nsub;
          out[(c0 + row) * groups + g0 + gs + c] = stage[c * kStride + row];
        }
        __syncthreads();
      }
    }
  }
}

// Any shape: one thread a row, everything read from global memory.
__global__ void __launch_bounds__(kThreads)
    coarse_any_kernel(const float* __restrict__ obj, const float* __restrict__ node,
                      const unsigned char* __restrict__ live, float* __restrict__ out,
                      long long n, int d, int m, int groups, int s) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += stride) {
    const float* x = obj + i * d;
    for (int g = 0; g < groups; ++g) {
      float best = -INFINITY;
      for (int j = g * s; j < (g + 1) * s; ++j) {
        if (!live[j]) continue;
        float acc = 0.f;
        for (int k = 0; k < d; ++k) acc = fmaf(x[k], node[static_cast<long long>(k) * m + j], acc);
        best = nan_max(best, acc);
      }
      out[i * groups + g] = best;
    }
  }
}

int device_sms(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return static_cast<int>(err);
}

template <int D, int R>
int launch_tiles(const float* obj, const float* node, const unsigned char* live, float* out,
                 long long n, int d, int m, int groups, int s, cudaStream_t stream) {
  constexpr int kRows = kThreads * R;
  const int per_group = round4(s);
  int tile_groups = kNodeBytes / (D * 4 * per_group);
  if (tile_groups > groups) tile_groups = groups;
  if (tile_groups > kOutGroups) tile_groups -= tile_groups % kOutGroups;  // runs of 8 results a row
  const int slot_cap = tile_groups * per_group;
  const size_t bytes = sizeof(float) * (static_cast<size_t>(D) * slot_cap +
                                        static_cast<size_t>(kOutGroups) * (kRows + 4)) +
                       sizeof(int) * (static_cast<size_t>(tile_groups) + 1 + slot_cap);
  auto kernel = coarse_tiles_kernel<D, R>;
  int sms = 0, per_sm = 0;
  int rc = device_sms(&sms);
  if (rc) return rc;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long want = (n + kRows - 1) / kRows;
  const long long cap = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const int blocks = static_cast<int>(want < cap ? want : cap);
  const bool vec = d == D && reinterpret_cast<uintptr_t>(obj) % 16 == 0;
  kernel<<<blocks, kThreads, bytes, stream>>>(obj, node, live, out, n, d, m, groups, s, tile_groups,
                                              slot_cap, vec);
  return static_cast<int>(cudaGetLastError());
}

// Whether one group's padded members fit the tile at D features.
bool fits(int D, int s) { return static_cast<long long>(D) * 4 * round4(s) <= kNodeBytes; }

}  // namespace

extern "C" {

// Writes out (n, groups) float32 on `stream` from obj (n, d), node (d, m)
// float32 and live (m,) bytes, all contiguous; returns cudaGetLastError()
// after the launch (0 on success; nothing is launched for n == 0).
int coarse_score_launch(const float* obj, const float* node, const unsigned char* live, float* out,
                        long long n, long long d, long long m, long long groups, void* stream) {
  if (n < 0 || d < 0 || m <= 0 || groups <= 0 || m % groups != 0 || m > 0x7fffffffLL ||
      d > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int di = static_cast<int>(d), mi = static_cast<int>(m), gi = static_cast<int>(groups);
  const int s = mi / gi;
  constexpr int R = kRowsPerThread;
  if (di <= 4 && fits(4, s)) return launch_tiles<4, R>(obj, node, live, out, n, di, mi, gi, s, st);
  if (di <= 8 && fits(8, s)) return launch_tiles<8, R>(obj, node, live, out, n, di, mi, gi, s, st);
  if (di <= 16 && fits(16, s)) return launch_tiles<16, R>(obj, node, live, out, n, di, mi, gi, s, st);
  if (di <= 32 && fits(32, s)) return launch_tiles<32, R / 2>(obj, node, live, out, n, di, mi, gi, s, st);
  int sms = 0;
  int rc = device_sms(&sms);
  if (rc) return rc;
  const long long want = (n + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sms) * 8;
  coarse_any_kernel<<<static_cast<int>(want < cap ? want : cap), kThreads, 0, st>>>(
      obj, node, live, out, n, di, mi, gi, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
