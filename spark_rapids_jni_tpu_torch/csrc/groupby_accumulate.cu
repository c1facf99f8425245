// Bounded-groupby accumulate for Hopper (sm_90a).
//
// Replaces the Pallas kernel spark_rapids_jni_tpu/ops/pallas/
// groupby_accumulate.py (accumulate, body _make_kernel): per-(group, lane)
// sums, mins and maxs over dense group ids gid in [0, m], where m means
// "no group".
//
// What differs from the TPU kernel:
// - Hopper has native int64 and a wrapping int64 sum does not depend on
//   the order of its terms, so there are no 16-bit limb lanes: every lane
//   accumulates in int64 and the totals are bit-identical to the plain
//   version's whatever order the rows are combined in.
// - Each lane is a descriptor (values pointer or null for the constant 1,
//   validity pointer or null for "all valid", element kind, op, neutral),
//   and the kernel applies the validity itself: no masked copy of a
//   column is materialized.
// - The TPU grid ran its blocks in order; here each block keeps partials
//   for every (group, lane) in shared memory (m*L int64, at most 2048
//   entries = 16 KB) and folds them into the output with one global
//   atomic per (group, lane) at its end.
//
// Bound on this card: bytes (each row's group id, and each lane's value
// and validity bytes, read once). The first design sent every (row,
// lane) through one 64-bit shared-memory atomic into part[g * L + l]. At
// TPC-H q1 (m = 12 slots, ~7 live groups) the 32 threads of a warp hit ~7
// addresses, so each atomic instruction serialised several ways, and the
// kernel reached a fifth of its byte bound. The SASS of that build
// (cuobjdump -sass, sm_90a) says why it was worse than serialisation:
// there is no 64-bit add, min or max instruction on shared memory, and
// every such atomic compiled to a compare-and-swap loop (ATOMS.CAST.SPIN.64,
// nine in that kernel), which retries whenever another thread changed the
// word between its load and its swap.
//
// This design has no same-address atomics per row. The element kind and
// op of a lane are template arguments of the code that reads its rows,
// chosen by one warp-uniform switch per lane (with_lane); the two kernels
// order their loops differently:
// - Small domains (m <= kSmallM, q1's case): lanes outer, rows inner. A
//   block walks tiles of kTile rows; it stages the tile's group ids in
//   shared memory once, then runs each lane over the whole tile, so the
//   switch runs once per lane and tile, not per row. Every thread owns a
//   private column of m partials in shared memory, laid out
//   [group][thread] so a warp's updates never share a bank pair, and
//   updates it with a plain load and store. After each lane's pass over
//   the tile, 16 threads per group fold the 256 columns (16 reads each,
//   then shuffles) into the block's partials. The fold reads m * 256
//   partials per lane per 8192-row tile (3,072 at q1's m = 12), a third
//   of the tile's updates but without their global loads.
// - Larger domains: per-thread columns would not fit. Rows outer, lanes
//   inner: each warp takes 32 rows at a time and first tests whether they
//   are in 32 different groups (each row writes its thread id into a
//   one-byte tag per group and reads it back: a store, a load and a vote).
//   If they are, every row is its own group's leader. If not, it finds
//   the rows of each group once (__match_any_sync on the group id, shared
//   by every lane), and for each lane reduces each group's values over
//   its rank order in as many shuffle steps as the warp's largest group
//   needs (five when all 32 share one). Then, for each lane (one uniform
//   switch per lane and 32 rows), one leader per group updates the
//   block's partials with a shared atomic: still a CAS loop, but at most
//   one per group per warp instruction, each at a different address.
// Loads are coalesced element loads (a warp reads whole sectors), issued
// kBatch rows at a time ahead of their shared-memory updates. The lane
// descriptors travel in the launch's parameters and a small kernel fills
// the output with the neutrals, so a launch makes no host-to-device copy
// and the card does not wait on the host between the launches.
// Measured on the H100 at q1 (PERF.md): loading and updating row by row
// kept one load in flight per thread (2.7 ms); batching the loads made it
// 1.7-2.1 ms and moving the descriptors into the parameters 1.6 ms, half
// the byte bound. A branch-free variant (rows in no group updating a
// spare row, read-only-path loads, 16K-row tiles) was slower, 2.0 ms.
// The large-domain kernel at 60M rows (bench_kernels --large, PERF.md):
// with one group it takes a quarter to a third of the time of one atomic
// per row and lane; with rows spread over m = 2048 groups, where that
// loop meets no contention, the distinct-rows test keeps it within 10 %
// of it (without the test, __match_any_sync and the rank arithmetic on
// every warp made it 1.9x slower).
// ptxas (-Xptxas -v, build.log): accumulate_small_kernel 40 registers,
// accumulate_large_kernel 32, fill_neutral_kernel 12; no stack, no spills.
// Dynamic shared memory per block: 40 bytes a lane plus m * L partials
// (8 bytes each); for the small kernel m * 256 private partials and the
// tile's 8,192 one-byte group ids (34,264 bytes at q1's m = 12, L = 11),
// for the large kernel m one-byte tags.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>
#include <type_traits>

namespace {

enum Kind : int64_t {
  kOne = 0,   // no values: the constant 1 (row and valid counts)
  kI8 = 1,
  kI16 = 2,
  kI32 = 3,
  kI64 = 4,
  kU8 = 5,
  kU16 = 6,
  kU32 = 7,
  kU64 = 8,   // summed as its int64 bit pattern (wrapping)
};

enum Op : int64_t { kSum = 0, kMin = 1, kMax = 2 };

// One lane; the wrapper writes these as int64[L, 5] rows.
struct Lane {
  const void* values;
  const uint8_t* valid;  // torch.bool: one byte per row
  int64_t kind;
  int64_t op;
  int64_t neutral;       // 0 for sums, the min/max sentinel otherwise
};
static_assert(sizeof(Lane) == 40, "Lane must match the wrapper's int64[5]");

// Up to kParamLanes lanes travel in the launch's parameters (2,560 bytes),
// so a launch needs no host-to-device copy; more come from device memory.
constexpr int kParamLanes = 64;
struct LaneParams {
  Lane lane[kParamLanes];
};

constexpr int kThreads = 256;
static_assert(kThreads <= 256, "the large kernel tags groups with uint8 ids");
constexpr int kSmallM = 16;           // largest m of the per-thread path
constexpr int kRowsPerThread = 32;
constexpr int kTile = kThreads * kRowsPerThread;  // rows per tile
constexpr int kBatch = 8;             // loads in flight per thread
constexpr uint8_t kNoGroup = 0xFF;
constexpr unsigned kFull = 0xFFFFFFFFu;

template <typename T> struct Type {};  // T = void: the constant 1
template <int64_t OP> using OpC = std::integral_constant<int64_t, OP>;

template <typename T>
__device__ __forceinline__ long long value(Type<T>, const void* values,
                                           int64_t i) {
  // uint64 keeps its bit pattern: the sum wraps like the plain version's
  return static_cast<long long>(static_cast<const T*>(values)[i]);
}
__device__ __forceinline__ long long value(Type<void>, const void*,
                                           int64_t) {
  return 1;
}

template <int64_t OP>
__device__ __forceinline__ long long combine(long long a, long long b) {
  if (OP == kSum) {
    return static_cast<long long>(static_cast<unsigned long long>(a) +
                                  static_cast<unsigned long long>(b));
  }
  if (OP == kMin) return a < b ? a : b;
  return a > b ? a : b;
}

__device__ __forceinline__ long long combine(int64_t op, long long a,
                                             long long b) {
  if (op == kSum) return combine<kSum>(a, b);
  if (op == kMin) return combine<kMin>(a, b);
  return combine<kMax>(a, b);
}

__device__ __forceinline__ void atomic_fold(long long* slot, int64_t op,
                                            long long v) {
  if (op == kSum) {
    atomicAdd(reinterpret_cast<unsigned long long*>(slot),
              static_cast<unsigned long long>(v));
  } else if (op == kMin) {
    atomicMin(slot, v);
  } else {
    atomicMax(slot, v);
  }
}

// f(Type<element>{}, OpC<op>{}) with the lane's kind and op as types
template <typename O, typename F>
__device__ __forceinline__ void with_kind(int64_t kind, O op, F& f) {
  switch (kind) {
    case kI8: f(Type<int8_t>{}, op); break;
    case kI16: f(Type<int16_t>{}, op); break;
    case kI32: f(Type<int32_t>{}, op); break;
    case kI64: f(Type<long long>{}, op); break;
    case kU8: f(Type<uint8_t>{}, op); break;
    case kU16: f(Type<uint16_t>{}, op); break;
    case kU32: f(Type<uint32_t>{}, op); break;
    case kU64: f(Type<unsigned long long>{}, op); break;
    default: f(Type<void>{}, op); break;
  }
}

template <typename F>
__device__ __forceinline__ void with_lane(const Lane& lane, F&& f) {
  if (lane.op == kSum) {
    with_kind(lane.kind, OpC<kSum>{}, f);
  } else if (lane.op == kMin) {
    with_kind(lane.kind, OpC<kMin>{}, f);
  } else {
    with_kind(lane.kind, OpC<kMax>{}, f);
  }
}

__device__ __forceinline__ const Lane& lane_at(const LaneParams& params,
                                               const Lane* lanes_dev, int j) {
  return lanes_dev == nullptr ? params.lane[j] : lanes_dev[j];
}

// out[g, l] = lane l's neutral: the output the blocks fold into
__global__ void __launch_bounds__(kThreads)
fill_neutral_kernel(const __grid_constant__ LaneParams params,
                    const Lane* __restrict__ lanes_dev, int num_lanes,
                    int cells, long long* __restrict__ out) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j < cells) out[j] = lane_at(params, lanes_dev, j % num_lanes).neutral;
}

// Shared-memory layout common to both kernels: the lane descriptors, then
// the block's partials [group][lane].
__device__ __forceinline__ void load_lanes(const LaneParams& params,
                                           const Lane* lanes_dev,
                                           int num_lanes, int m,
                                           Lane* lane_s, long long* blk) {
  for (int j = threadIdx.x; j < num_lanes; j += blockDim.x) {
    lane_s[j] = lane_at(params, lanes_dev, j);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < m * num_lanes; j += blockDim.x) {
    blk[j] = lane_s[j % num_lanes].neutral;
  }
  __syncthreads();
}

// the output starts at each lane's neutral, so a partial that is still
// neutral has nothing to add
__device__ __forceinline__ void flush(const Lane* lane_s, int num_lanes,
                                      int m, const long long* blk,
                                      long long* __restrict__ out) {
  __syncthreads();
  for (int j = threadIdx.x; j < m * num_lanes; j += blockDim.x) {
    const Lane& lane = lane_s[j % num_lanes];
    if (blk[j] != lane.neutral) atomic_fold(out + j, lane.op, blk[j]);
  }
}

// ---- small domains: per-thread private partials ---------------------------

// One lane over the tile's rows: each thread takes rows tid, tid + 256,
// ... in batches of kBatch, issuing every load of a batch before its first
// shared-memory update, so the loads are in flight together.
template <typename T, int64_t OP>
__device__ __forceinline__ void tile_rows(Type<T> type, OpC<OP>,
                                          const Lane& lane, int64_t base,
                                          int rows, const uint8_t* gid_s,
                                          long long* mine) {
  const uint8_t* __restrict__ valid = lane.valid;
  for (int r0 = threadIdx.x; r0 < rows; r0 += kThreads * kBatch) {
    long long v[kBatch];
    unsigned g[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int r = r0 + b * kThreads;
      g[b] = kNoGroup;
      if (r < rows) {
        const int64_t row = base + r;
        v[b] = value(type, lane.values, row);
        if (valid == nullptr || valid[row] != 0) g[b] = gid_s[r];
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (g[b] != kNoGroup) {
        long long* slot = mine + g[b] * kThreads;
        *slot = combine<OP>(*slot, v[b]);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
accumulate_small_kernel(const int32_t* __restrict__ gid, int64_t n,
                        const __grid_constant__ LaneParams params,
                        const Lane* __restrict__ lanes_dev, int num_lanes,
                        int m, long long* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  Lane* lane_s = reinterpret_cast<Lane*>(smem);
  long long* blk = reinterpret_cast<long long*>(lane_s + num_lanes);
  long long* priv = blk + m * num_lanes;  // [group][thread]
  uint8_t* gid_s = reinterpret_cast<uint8_t*>(priv + m * kThreads);
  long long* mine = priv + threadIdx.x;
  load_lanes(params, lanes_dev, num_lanes, m, lane_s, blk);

  // fold: 16 threads per group, each combining 16 of the 256 columns
  const int fold_g = threadIdx.x >> 4;
  const int fold_part = threadIdx.x & 15;
  const int64_t tiles = (n + kTile - 1) / kTile;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t base = tile * kTile;
    const int rows = static_cast<int>(n - base < kTile ? n - base : kTile);
    for (int r0 = threadIdx.x; r0 < rows; r0 += kThreads * kBatch) {
      int32_t g[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int r = r0 + b * kThreads;
        g[b] = r < rows ? gid[base + r] : -1;
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int r = r0 + b * kThreads;
        if (r < rows) {
          gid_s[r] = (g[b] >= 0 && g[b] < m) ? static_cast<uint8_t>(g[b])
                                             : kNoGroup;
        }
      }
    }
    __syncthreads();
    for (int l = 0; l < num_lanes; ++l) {
      const Lane lane = lane_s[l];
      for (int g = 0; g < m; ++g) mine[g * kThreads] = lane.neutral;
      with_lane(lane, [&](auto type, auto op) {
        tile_rows(type, op, lane, base, rows, gid_s, mine);
      });
      __syncthreads();
      long long acc = lane.neutral;
      if (fold_g < m) {
        const long long* col = priv + fold_g * kThreads + fold_part;
#pragma unroll
        for (int q = 0; q < kThreads / 16; ++q) {
          acc = combine(lane.op, acc, col[q * 16]);
        }
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        acc = combine(lane.op, acc, __shfl_xor_sync(kFull, acc, off, 16));
      }
      if (fold_g < m && fold_part == 0) {
        long long* cell = blk + fold_g * num_lanes + l;
        *cell = combine(lane.op, *cell, acc);
      }
      __syncthreads();
    }
  }
  flush(lane_s, num_lanes, m, blk, out);
}

// ---- larger domains: warp-aggregated shared atomics -----------------------

// position of the n-th (from 0) set bit of mask; n < popc(mask)
__device__ __forceinline__ int nth_set_bit(unsigned mask, int n) {
  int pos = 0;
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) {
    const int low = __popc(mask & ((1u << w) - 1u));
    if (n >= low) {
      n -= low;
      mask >>= w;
      pos += w;
    }
  }
  return pos;
}

__global__ void __launch_bounds__(kThreads)
accumulate_large_kernel(const int32_t* __restrict__ gid, int64_t n,
                        const __grid_constant__ LaneParams params,
                        const Lane* __restrict__ lanes_dev, int num_lanes,
                        int m, long long* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  Lane* lane_s = reinterpret_cast<Lane*>(smem);
  long long* blk = reinterpret_cast<long long*>(lane_s + num_lanes);
  // tag[g]: the thread that last claimed group g (any warp of the block)
  uint8_t* tag = reinterpret_cast<uint8_t*>(blk + m * num_lanes);
  load_lanes(params, lanes_dev, num_lanes, m, lane_s, blk);

  const int lane_id = threadIdx.x & 31;
  const uint8_t me = static_cast<uint8_t>(threadIdx.x);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  // a block-uniform loop: the warp's collectives run converged
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads; base < n;
       base += stride) {
    const int64_t row = base + threadIdx.x;
    const bool in = row < n;
    const int32_t g = in ? gid[row] : -1;
    const bool ok = g >= 0 && g < m;
    // Are the warp's rows in distinct groups? Each claims its group's
    // tag; two rows of one group cannot both read their own claim back,
    // so "all read their own" proves it (another warp's claim in between
    // only sends the warp down the exact path below).
    if (ok) tag[g] = me;
    __syncwarp();
    const bool distinct = __all_sync(kFull, !ok || tag[g] == me);
    // Otherwise: the rows of this warp in the same group as this one
    // (rows in no group form one more set, whose leader writes nothing),
    // and as many shuffle steps as the warp's largest group needs.
    int rank = 0, count = 1, steps = 0;
    int src[5] = {lane_id, lane_id, lane_id, lane_id, lane_id};
    if (!distinct) {
      const unsigned peers = __match_any_sync(kFull, ok ? g : -1);
      rank = __popc(peers & ((1u << lane_id) - 1u));
      count = __popc(peers);
      steps = 32 - __clz(__reduce_max_sync(kFull, ok ? count : 1) - 1);
#pragma unroll
      for (int k = 0; k < 5; ++k) {
        const int r = rank + (1 << k);
        if (k < steps && r < count) src[k] = nth_set_bit(peers, r);
      }
    }
    for (int l = 0; l < num_lanes; ++l) {
      const Lane lane = lane_s[l];
      with_lane(lane, [&](auto type, auto op_c) {
        constexpr int64_t OP = decltype(op_c)::value;
        long long v = lane.neutral;
        if (ok && (lane.valid == nullptr || lane.valid[row] != 0)) {
          v = value(type, lane.values, row);
        }
        // rank r ends holding the combine of ranks [r, count)
#pragma unroll
        for (int k = 0; k < 5; ++k) {
          if (k >= steps) break;
          const long long o = __shfl_sync(kFull, v, src[k]);
          if (rank + (1 << k) < count) v = combine<OP>(v, o);
        }
        if (ok && rank == 0) {
          atomic_fold(blk + g * num_lanes + l, OP, v);
        }
      });
    }
  }
  flush(lane_s, num_lanes, m, blk, out);
}

template <typename Kernel>
int launch(Kernel kernel, size_t smem, int64_t work_blocks, int sms,
           cudaStream_t stream, const int32_t* gid, int64_t n,
           const LaneParams& params, const Lane* lanes_dev, int num_lanes,
           int m, long long* out) {
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) per_sm = 1;
  const int64_t cap = static_cast<int64_t>(sms) * per_sm;
  const int blocks = static_cast<int>(work_blocks < cap ? work_blocks : cap);
  kernel<<<blocks, kThreads, smem, stream>>>(gid, n, params, lanes_dev,
                                             num_lanes, m, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// gid: device int32[n]; lanes: HOST int64[num_lanes, 5] (see Lane); out:
// device int64[m, num_lanes], which the launch first fills with each
// lane's neutral. Up to kParamLanes lanes go in the launch parameters;
// above that, lanes_dev (device, num_lanes * 40 bytes) receives a copy.
// m <= kSmallM takes the per-thread kernel, larger m the warp-aggregated
// one. Launches on ``stream`` and returns the first CUDA error.
extern "C" int srjt_groupby_accumulate(const void* gid, int64_t n,
                                       const void* lanes, int32_t num_lanes,
                                       int32_t m, void* lanes_dev, void* out,
                                       int32_t sms, void* stream) {
  if (n <= 0 || num_lanes <= 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  LaneParams params{};
  const Lane* dev = nullptr;
  if (num_lanes <= kParamLanes) {
    memcpy(params.lane, lanes, static_cast<size_t>(num_lanes) * sizeof(Lane));
  } else {
    if (lanes_dev == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t err = cudaMemcpyAsync(
        lanes_dev, lanes, static_cast<size_t>(num_lanes) * sizeof(Lane),
        cudaMemcpyHostToDevice, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    dev = static_cast<const Lane*>(lanes_dev);
  }
  const int32_t* g = static_cast<const int32_t*>(gid);
  long long* o = static_cast<long long*>(out);
  const int cells = m * num_lanes;
  fill_neutral_kernel<<<(cells + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      params, dev, num_lanes, cells, o);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t common = static_cast<size_t>(num_lanes) * sizeof(Lane) +
                        static_cast<size_t>(m) * num_lanes * sizeof(long long);
  if (m <= kSmallM) {
    const size_t smem =
        common + static_cast<size_t>(m) * kThreads * sizeof(long long) + kTile;
    return launch(accumulate_small_kernel, smem, (n + kTile - 1) / kTile, sms,
                  s, g, n, params, dev, num_lanes, m, o);
  }
  return launch(accumulate_large_kernel, common + m,
                (n + kThreads - 1) / kThreads, sms, s, g, n, params, dev,
                num_lanes, m, o);
}
