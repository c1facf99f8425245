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
// of values, the contiguous sorted rows of group g (+0.0 for an empty
// group), for g < m. Rows of no range (groups past m) are not summed.
//
// The order depends on the bounds alone, not on the grid:
// - each group's rows split into chunks of kChunk (1,024) rows from
//   g_lo; one warp sums one chunk: lane j adds rows j, j + 32, ... in
//   row order, then the 32 lane sums meet in a fixed butterfly (xor 16,
//   8, 4, 2, 1);
// - a group of one chunk is that sum plus 0.0; a larger group's chunk
//   sums fold the same way: lane j adds chunks j, j + 32, ... in order,
//   then the butterfly.
//
// Bound on this card: bytes (each value read once, the bounds read
// once, each sum written once): 123 MB, 0.037 ms at the H100's 3.35
// TB/s, at a quarter of SF10 lineitem by l_suppkey. What held an
// earlier design at 0.11 of that (on an NVIDIA H100 80GB HBM3 at 700.00
// W) was not bytes: a prefix sum of chunk ids in six torch passes
// before the launch, and a binary search of those ids per chunk (17
// dependent global loads at 100,000 groups). This one finds its work
// from the row index instead:
// - sums_kernel: a warp takes a block of kChunk rows, reads gid (each
//   sorted row's group id) at the block's first and last row, then the
//   bounds of those groups with one load a lane, and sums every group
//   of at most kChunk rows that starts in the block, its 32 sums
//   written with one store. A group of more than kChunk rows is summed
//   chunk by chunk wherever a chunk ends: at most two chunks end in a
//   block, both of the block's first group, so the chunk sums go to
//   partial[2 * block] (a full chunk) and partial[2 * block + 1] (the
//   group's last chunk). Every block is the same work whatever the
//   sizes of the groups, so one group of 15M rows spreads over the card
//   as 100,000 small ones do.
// - fold_kernel: a warp takes 32 groups, writes +0.0 for the empty
//   ones and folds the chunk sums of the large ones, 32 loads in flight
//   a lane (one group of 15M rows leaves one warp 14,646 sums to fold).
// No torch pass runs before the launch and no scratch needs zeroing;
// the two kernels launch back to back from one call. On that card:
// 0.076-0.134 ms with the wrapper, 0.117-0.165 ms with the same rows in
// one group.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 8 warps a block
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 8;     // loads in flight a lane
constexpr int kFoldUnroll = 32;  // the fold's: one warp may fold 15,000
constexpr int64_t kChunk = 1024;  // segment_sum.CHUNK
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ double butterfly(double acc) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(kFull, acc, off);
  }
  return acc;
}

// The fixed-order sum of rows [begin, end), end - begin <= kChunk, in
// every lane: lane j adds rows begin + j, begin + j + 32, ..., kUnroll
// loads issued before their adds.
__device__ __forceinline__ double chunk_sum(const double* __restrict__ values,
                                            int64_t begin, int64_t end,
                                            int lane) {
  double acc = 0.0;
  for (int64_t r0 = begin + lane; r0 < end; r0 += 32 * kUnroll) {
    double v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t r = r0 + 32 * u;
      v[u] = r < end ? __ldg(values + r) : 0.0;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r0 + 32 * u < end) acc += v[u];
    }
  }
  return butterfly(acc);
}

// The partial slot of chunk k of a group [lo, hi) of k_count chunks:
// by the block that holds the chunk's last row.
__device__ __forceinline__ int64_t slot_of(int64_t lo, int64_t hi, int64_t k,
                                           int64_t k_count) {
  const int64_t end = lo + (k + 1) * kChunk < hi ? lo + (k + 1) * kChunk : hi;
  return 2 * ((end - 1) / kChunk) + (k == k_count - 1 ? 1 : 0);
}

// A warp's count of the items it takes of `total`, starting at `first`
// and striding by `stride`, as a value the compiler knows is the same in
// every lane (a loop around shuffles needs a uniform trip count).
__device__ __forceinline__ int warp_trips(int64_t first, int64_t total,
                                          int64_t stride) {
  const int64_t t = first < total ? (total - first + stride - 1) / stride : 0;
  return static_cast<int>(__reduce_max_sync(kFull, static_cast<unsigned>(t)));
}

__global__ void __launch_bounds__(kThreads)
sums_kernel(const double* __restrict__ values, const int64_t* __restrict__ gid,
            const int64_t* __restrict__ g_lo, const int64_t* __restrict__ g_hi,
            int64_t m, int64_t n, double* __restrict__ partial,
            double* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t nblk = (n + kChunk - 1) / kChunk;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
  const int64_t w0 = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const int trips = warp_trips(w0, nblk, warps);
  for (int t = 0; t < trips; ++t) {
    const int64_t b = w0 + t * warps;
    const int64_t b0 = b * kChunk;
    const int64_t b1 = b0 + kChunk < n ? b0 + kChunk : n;
    const int64_t gf = gid[b0];
    if (!__all_sync(kFull, gf < m)) continue;  // rows of groups past m
    const int64_t gl = gid[b1 - 1] < m ? gid[b1 - 1] : m - 1;
    const int64_t lo = g_lo[gf], hi = g_hi[gf];
    if (__all_sync(kFull, hi - lo > kChunk)) {
      // the chunks of group gf whose last row lies in this block: a
      // full one, and the last one
      const int64_t kc = (hi - lo + kChunk - 1) / kChunk;
      const int64_t kf = (b0 - lo) / kChunk;
      if (__all_sync(kFull, kf < kc - 1)) {
        const int64_t s = lo + kf * kChunk;
        const double sum = chunk_sum(values, s, s + kChunk, lane);
        if (lane == 0) partial[2 * b] = sum;
      }
      if (__all_sync(kFull, hi - 1 < b0 + kChunk)) {
        const double sum = chunk_sum(values, lo + (kc - 1) * kChunk, hi, lane);
        if (lane == 0) partial[2 * b + 1] = sum;
      }
    }
    // the groups of at most kChunk rows that start in this block: gf if
    // its first row is b0, then gf + 1 .. gl; their bounds one a lane
    const int64_t gs = lo < b0 ? gf + 1 : gf;
    const int runs = __reduce_max_sync(
        kFull, static_cast<unsigned>((gl - gs + 32) / 32));
    for (int run = 0; run < runs; ++run) {
      const int64_t g = gs + 32 * run + lane;
      int64_t glo = 0, ghi = 0;
      if (g <= gl) {
        glo = g_lo[g];
        ghi = g_hi[g];
      }
      const bool mine = ghi - glo > 0 && ghi - glo <= kChunk;
      unsigned todo = __ballot_sync(kFull, mine);
      double res = 0.0;
      while (todo != 0) {
        const int i = __ffs(todo) - 1;
        todo &= todo - 1;
        const int64_t s = __shfl_sync(kFull, glo, i);
        const int64_t e = __shfl_sync(kFull, ghi, i);
        const double sum = chunk_sum(values, s, e, lane);
        if (lane == i) res = 0.0 + sum;  // the fold of one chunk sum
      }
      if (mine) out[g] = res;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
fold_kernel(const int64_t* __restrict__ g_lo, const int64_t* __restrict__ g_hi,
            int64_t m, const double* __restrict__ partial,
            double* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t runs = (m + 31) / 32;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
  const int64_t w0 = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const int trips = warp_trips(w0, runs, warps);
  for (int t = 0; t < trips; ++t) {
    const int64_t g = 32 * (w0 + t * warps) + lane;
    int64_t lo = 0, hi = 0;
    if (g < m) {
      lo = g_lo[g];
      hi = g_hi[g];
      if (hi <= lo) out[g] = 0.0;  // an empty group
    }
    unsigned todo = __ballot_sync(kFull, hi - lo > kChunk);
    while (todo != 0) {
      const int i = __ffs(todo) - 1;
      todo &= todo - 1;
      const int64_t s = __shfl_sync(kFull, lo, i);
      const int64_t e = __shfl_sync(kFull, hi, i);
      const int64_t kc = (e - s + kChunk - 1) / kChunk;
      double acc = 0.0;
      for (int64_t k0 = lane; k0 < kc; k0 += 32 * kFoldUnroll) {
        double v[kFoldUnroll];
#pragma unroll
        for (int u = 0; u < kFoldUnroll; ++u) {
          const int64_t k = k0 + 32 * u;
          v[u] = k < kc ? partial[slot_of(s, e, k, kc)] : 0.0;
        }
#pragma unroll
        for (int u = 0; u < kFoldUnroll; ++u) {
          if (k0 + 32 * u < kc) acc += v[u];
        }
      }
      acc = butterfly(acc);
      if (lane == i) out[g] = acc;
    }
  }
}

}  // namespace

// values: device float64[n]; gid: device int64[n], each row's group id,
// non-decreasing, the rows of group g < m exactly [g_lo[g], g_hi[g])
// (ids >= m: rows of no group); g_lo, g_hi: device int64[m]; partial:
// device float64[2 * ceil(n / 1024)] scratch, written before it is read;
// out: device float64[m]. blocks: the most blocks of either kernel (any
// count gives the same bits). Launches on ``stream`` and returns the
// first CUDA error.
extern "C" int srjt_segment_sum(const void* values, const void* gid,
                                const void* g_lo, const void* g_hi,
                                int64_t m, int64_t n, void* partial,
                                int32_t blocks, void* out, void* stream) {
  if (m <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* lo = static_cast<const int64_t*>(g_lo);
  const int64_t* hi = static_cast<const int64_t*>(g_hi);
  double* o = static_cast<double*>(out);
  const int64_t want1 = ((n + kChunk - 1) / kChunk + kWarps - 1) / kWarps;
  sums_kernel<<<static_cast<unsigned>(want1 < blocks ? want1 : blocks),
                kThreads, 0, s>>>(
      static_cast<const double*>(values), static_cast<const int64_t*>(gid),
      lo, hi, m, n, static_cast<double*>(partial), o);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t want2 = ((m + 31) / 32 + kWarps - 1) / kWarps;
  fold_kernel<<<static_cast<unsigned>(want2 < blocks ? want2 : blocks),
                kThreads, 0, s>>>(lo, hi, m,
                                  static_cast<const double*>(partial), o);
  return static_cast<int>(cudaGetLastError());
}
