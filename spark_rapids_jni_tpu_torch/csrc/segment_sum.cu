// Segmented float64 sum in a fixed order for Hopper (sm_90a).
//
// Replaces no Pallas kernel. It is the port's counterpart of the
// reference's _segmented_sum_scan (spark_rapids_jni_tpu/ops/groupby.py),
// the associative scan XLA emits for the general groupby's float sums:
// that scan adds in an order fixed by its shape, so the same input gives
// the same bits. index_add_'s atomics add in an order the card picks (8
// bit patterns in 8 runs on the H100), so a fleet could not compare two
// runs of a float plan bit for bit; this kernel fixes the order.
//
// What it computes: out[g] = the float64 sum of rows [g_lo[g], g_hi[g])
// of values, the contiguous sorted rows of group g (0.0 for an empty
// group), for g < m. Rows of no range (groups past m) are not read.
//
// The order depends on the bounds alone, not on the grid:
// - each group's rows split into chunks of `chunk` rows from g_lo (the
//   wrapper's constant, 1,024: 32 a lane); a warp sums one chunk: lane j
//   adds rows j, j + 32, ... in row order,
//   then the 32 lane sums meet in a fixed butterfly (xor 16, 8, 4, 2, 1);
// - a second kernel folds each group's chunk sums the same way: lane j
//   adds chunks j, j + 32, ... in order, then the butterfly.
// Every chunk is the same work, whatever the sizes of the groups: the
// first kernel's warps walk the chunk ids (a group's first chunk id is a
// prefix sum the wrapper computes), and find each chunk's group by a
// binary search of those ids, so one group of 60M rows spreads over as
// many warps as 60M rows in small groups.
//
// Bound on this card: bytes (each value read once, the bounds read once,
// each sum written once). A chunk's loads are coalesced (a warp reads
// 256 contiguous bytes a step), issued kUnroll ahead of their adds.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;     // 8 warps a block
constexpr int kUnroll = 8;        // loads in flight a lane
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ double butterfly(double acc) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(kFull, acc, off);
  }
  return acc;
}

// first[g] = the first chunk id of group g; first[m] = the chunk count.
// The group of chunk c: the last g with first[g] <= c (first is
// non-decreasing; an empty group shares its id with the next).
__device__ __forceinline__ int64_t group_of(const int64_t* __restrict__ first,
                                           int64_t m, int64_t c) {
  int64_t lo = 0, hi = m;  // first[lo] <= c < first[hi]
  while (hi - lo > 1) {
    const int64_t mid = lo + (hi - lo) / 2;
    if (first[mid] <= c) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
chunk_sums_kernel(const double* __restrict__ values,
                  const int64_t* __restrict__ g_lo,
                  const int64_t* __restrict__ g_hi,
                  const int64_t* __restrict__ first, int64_t m,
                  int64_t chunk, double* __restrict__ partial) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * (kThreads / 32);
  const int64_t chunks = first[m];
  for (int64_t c = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
       c < chunks; c += warps) {
    const int64_t g = group_of(first, m, c);
    const int64_t begin = g_lo[g] + (c - first[g]) * chunk;
    const int64_t stop = begin + chunk, hi = g_hi[g];
    const int64_t end = stop < hi ? stop : hi;
    double acc = 0.0;
    for (int64_t r0 = begin + lane; r0 < end; r0 += 32 * kUnroll) {
      double v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t r = r0 + 32 * u;
        v[u] = r < end ? values[r] : 0.0;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (r0 + 32 * u < end) acc += v[u];
      }
    }
    acc = butterfly(acc);
    if (lane == 0) partial[c] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
fold_kernel(const int64_t* __restrict__ first, int64_t m,
            const double* __restrict__ partial, double* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * (kThreads / 32);
  for (int64_t g = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5); g < m;
       g += warps) {
    const int64_t lo = first[g], hi = first[g + 1];
    double acc = 0.0;
    for (int64_t c = lo + lane; c < hi; c += 32) acc += partial[c];
    acc = butterfly(acc);
    if (lane == 0) out[g] = acc;
  }
}

}  // namespace

// values: device float64[n]; g_lo, g_hi: device int64[m], group g's rows
// [g_lo[g], g_hi[g]) within [0, n); first: device int64[m + 1], the
// exclusive prefix sum of each group's ceil((g_hi - g_lo) / chunk)
// chunks; partial: device float64[max_chunks] scratch, max_chunks >=
// first[m]; out: device float64[m]. blocks: the grid of both kernels
// (any count gives the same bits). Launches on ``stream`` and returns
// the first CUDA error.
extern "C" int srjt_segment_sum(const void* values, const void* g_lo,
                                const void* g_hi, const void* first,
                                int64_t m, int64_t chunk, void* partial,
                                int32_t blocks, void* out, void* stream) {
  if (m <= 0) return static_cast<int>(cudaSuccess);
  if (blocks < 1 || chunk < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* f = static_cast<const int64_t*>(first);
  chunk_sums_kernel<<<blocks, kThreads, 0, s>>>(
      static_cast<const double*>(values), static_cast<const int64_t*>(g_lo),
      static_cast<const int64_t*>(g_hi), f, m, chunk,
      static_cast<double*>(partial));
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  fold_kernel<<<blocks, kThreads, 0, s>>>(f, m,
                                          static_cast<const double*>(partial),
                                          static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}
