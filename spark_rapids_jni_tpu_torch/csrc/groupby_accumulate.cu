// Bounded-groupby accumulate for Hopper (sm_90a).
//
// Replaces the Pallas kernel spark_rapids_jni_tpu/ops/pallas/
// groupby_accumulate.py (accumulate, body _make_kernel): per-(group, lane)
// sums, mins and maxs over dense group ids gid in [0, m], where m means
// "no group".
//
// What differs from the TPU kernel:
// - Hopper has native int64 and a wrapping int64 sum does not depend on
//   the order of its terms, so there are no 16-bit limb lanes: every
//   integer lane accumulates in int64 and the totals are bit-identical to
//   the plain version's whatever order the rows are combined in.
// - Each lane is a descriptor (values pointer or null for the constant 1,
//   validity pointer or null for "all valid", element kind, op, neutral),
//   and the kernel applies the validity itself: no masked copy of a
//   column is materialized.
// - The TPU kernel took int32 lanes only; the reference sent float sums,
//   float and uint64 min/max and wide domains to XLA. This kernel takes
//   them all:
//   * min and max compare a lane's int64 order key: integers as they
//     are, uint64 with its sign bit flipped, floats (float32 widened to
//     float64 exactly) by the IEEE total order, in which -0.0 < +0.0, so
//     a tie of -0.0 and +0.0 returns -0.0 for min and +0.0 for max
//     whatever the order of the rows. A NaN (either sign, any payload)
//     takes the key that wins the op, so NaN propagates as in jnp.min and
//     torch.amin, and comes back as the canonical quiet NaN. The final
//     fold turns each key back into the value's 64-bit pattern.
//   * float sums (kSumF) add in float64 in an order fixed by the launch
//     shape alone, so a run repeats bit for bit: every combine below is
//     either a thread's own rows in row order, a fold in a fixed tree, or
//     (large domains) warps committing one after another.
//   * a launch takes up to kParamLanes lanes within the 227 KB of dynamic
//     shared memory a block may opt in to; the wrapper splits more lanes
//     over several launches, each reading gid again.
//   * a domain too wide for one lane's partials (m past ~23,000 slots)
//     splits into windows of groups [g0, g0 + w): each launch of the
//     large kernel covers one window (a row whose group falls outside it
//     joins no group there), and its fold writes that window's block of
//     out[m, L]. The wrapper picks the window width and the lanes a
//     launch that read the fewest bytes; each launch keeps one fixed
//     order, so float sums still repeat bit for bit.
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
//   then shuffles) into the block's partials.
// - Larger domains: per-thread columns would not fit. Rows outer, lanes
//   inner, in blocks of 256 or 1,024 threads, whichever keeps more warps
//   resident (ties: 256). Wide partials (the monthly rollup's 134 KB)
//   leave room for one block a multiprocessor, and 1,024 threads keep 32
//   warps of loads in flight; small ones fit 8 blocks of 256, whose
//   separate partials spread a hot group's updates (q5's null slot holds
//   ~99.9 % of its rows: with 1,024-thread blocks its time rose from
//   1.50 to 1.80 ms). Each warp
//   takes 32 rows at a time and first tests whether they are in 32
//   different groups (each row writes its thread id into a two-byte tag
//   per group and reads it back: a store, a load and a vote). If they
//   are, every row is its own group's leader. If not, it finds the rows
//   of each group once (__match_any_sync on the group id, shared by every
//   lane), and for each lane reduces each group's values over its rank
//   order in as many shuffle steps as the warp's largest group needs
//   (five when all 32 share one). Then one leader per group updates the
//   block's partials: a shared atomic for integer and min/max lanes (a
//   CAS loop, at most one per group per warp instruction, each at a
//   different address), and for float sums a plain add, warp after warp
//   between barriers, so their order is fixed.
// - No global atomics: each block writes its partials to its own row of
//   a scratch buffer, and a second kernel folds the rows of each cell in
//   a fixed tree (one block a cell) and decodes the order keys.
// - A launch of integer lanes only takes kernels compiled without the
//   float paths (FLOATS = false): with them the small kernel needed 54
//   registers, or spilled at 40, and planned q1's A took 1.86-1.98 ms
//   against 1.55 before the float paths existed (PERF.md).
// Loads are coalesced element loads (a warp reads whole sectors); the
// small kernel issues them kBatch rows at a time ahead of their
// shared-memory updates. The lane descriptors travel in the launch's
// parameters, so a launch makes no host-to-device copy and the card does
// not wait on the host between the launches.
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
// Dynamic shared memory per block: 40 bytes a lane plus m * L partials
// (8 bytes each); for the small kernel m * 256 private partials and the
// tile's 8,192 one-byte group ids, for the large kernel m two-byte tags
// (m: the window's width).
// ptxas's registers and spills are in build.log (-Xptxas -v).

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
  kF32 = 9,   // widened to float64
  kF64 = 10,
};

// kSum: wrapping int64 sum; kMin / kMax: over the int64 order key;
// kSumF: float64 sum
enum Op : int64_t { kSum = 0, kMin = 1, kMax = 2, kSumF = 3 };

// One lane; the wrapper writes these as int64[L, 5] rows.
struct Lane {
  const void* values;
  const uint8_t* valid;  // torch.bool: one byte per row
  int64_t kind;
  int64_t op;
  int64_t neutral;       // the neutral's key (kSumF: the bits of 0.0)
};
static_assert(sizeof(Lane) == 40, "Lane must match the wrapper's int64[5]");

// Up to kParamLanes lanes travel in the launch's parameters (2,560 bytes)
constexpr int kParamLanes = 64;
struct LaneParams {
  Lane lane[kParamLanes];
};

constexpr int kThreads = 256;        // small kernel, and the fold kernel
constexpr int kWideThreads = 1024;   // large kernel when one block fills an SM
constexpr int kSmallM = 16;           // largest m of the per-thread path
constexpr int kRowsPerThread = 32;
constexpr int kTile = kThreads * kRowsPerThread;  // rows per tile
constexpr int kBatch = 8;             // loads in flight per thread
constexpr int kMaxSmem = 232448;      // opt-in dynamic shared memory, sm_90
constexpr uint8_t kNoGroup = 0xFF;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr long long kKeyMin = static_cast<long long>(0x8000000000000000ull);
constexpr long long kKeyMax = 0x7FFFFFFFFFFFFFFFll;
constexpr long long kCanonicalNaN = 0x7FF8000000000000ll;

template <typename T> struct Type {};  // T = void: the constant 1
template <int64_t OP> using OpC = std::integral_constant<int64_t, OP>;

// a float64's IEEE total-order key as a signed int64; NaN wins the op
template <int64_t OP>
__device__ __forceinline__ long long float_key(double x) {
  if (x != x) return OP == kMin ? kKeyMin : kKeyMax;
  const long long b = __double_as_longlong(x);
  return b >= 0 ? b : b ^ kKeyMax;
}

// the lane's int64 word for row i: the value (integer sums, counts,
// integer min/max), the order key (uint64 and float min/max), or the
// float64 bits (float sums)
template <typename T, int64_t OP>
__device__ __forceinline__ long long value(Type<T>, OpC<OP>,
                                           const void* values, int64_t i) {
  const T v = static_cast<const T*>(values)[i];
  if constexpr (std::is_floating_point<T>::value) {
    if constexpr (OP == kSumF) {
      return __double_as_longlong(static_cast<double>(v));
    } else {
      return float_key<OP>(static_cast<double>(v));
    }
  } else if constexpr (std::is_same<T, unsigned long long>::value) {
    const long long b = static_cast<long long>(v);
    return OP == kSum ? b : b ^ kKeyMin;
  } else {
    return static_cast<long long>(v);
  }
}
template <int64_t OP>
__device__ __forceinline__ long long value(Type<void>, OpC<OP>, const void*,
                                           int64_t) {
  return 1;
}

template <int64_t OP>
__device__ __forceinline__ long long combine(long long a, long long b) {
  if constexpr (OP == kSum) {
    return static_cast<long long>(static_cast<unsigned long long>(a) +
                                  static_cast<unsigned long long>(b));
  } else if constexpr (OP == kSumF) {
    return __double_as_longlong(__longlong_as_double(a) +
                                __longlong_as_double(b));
  } else if constexpr (OP == kMin) {
    return a < b ? a : b;
  } else {
    return a > b ? a : b;
  }
}

// combine by a runtime op (FLOATS = false: no float sum possible)
template <bool FLOATS>
__device__ __forceinline__ long long combine_rt(int64_t op, long long a,
                                                long long b) {
  if constexpr (FLOATS) {
    if (op == kSumF) return combine<kSumF>(a, b);
  }
  switch (op) {
    case kSum: return combine<kSum>(a, b);
    case kMin: return combine<kMin>(a, b);
    default: return combine<kMax>(a, b);
  }
}

// the value's 64-bit pattern from a finished partial
__device__ __forceinline__ long long decode(const Lane& lane, long long k) {
  if (lane.op == kSum || lane.op == kSumF) return k;
  if (lane.kind == kU64) return k ^ kKeyMin;
  if (lane.kind == kF32 || lane.kind == kF64) {
    if (k == (lane.op == kMin ? kKeyMin : kKeyMax)) return kCanonicalNaN;
    return k >= 0 ? k : k ^ kKeyMax;
  }
  return k;
}

template <int64_t OP>
__device__ __forceinline__ void atomic_fold(long long* slot, long long v) {
  if constexpr (OP == kSum) {
    atomicAdd(reinterpret_cast<unsigned long long*>(slot),
              static_cast<unsigned long long>(v));
  } else if constexpr (OP == kMin) {
    atomicMin(slot, v);
  } else {
    atomicMax(slot, v);
  }
}

// f(Type<element>{}, OpC<op>{}) with the lane's kind and op as types
template <typename O, typename F>
__device__ __forceinline__ void with_int_kind(int64_t kind, O op, F& f) {
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

template <typename O, typename F>
__device__ __forceinline__ void with_float_kind(int64_t kind, O op, F& f) {
  if (kind == kF32) {
    f(Type<float>{}, op);
  } else {
    f(Type<double>{}, op);
  }
}

// FLOATS = false: a launch of integer lanes only, whose kernels hold none
// of the float paths (they would raise its register count and spill)
template <bool FLOATS, typename F>
__device__ __forceinline__ void with_lane(const Lane& lane, F&& f) {
  if constexpr (!FLOATS) {
    switch (lane.op) {
      case kSum: with_int_kind(lane.kind, OpC<kSum>{}, f); break;
      case kMin: with_int_kind(lane.kind, OpC<kMin>{}, f); break;
      default: with_int_kind(lane.kind, OpC<kMax>{}, f); break;
    }
    return;
  }
  const bool is_float = lane.kind == kF32 || lane.kind == kF64;
  switch (lane.op) {
    case kSum: with_int_kind(lane.kind, OpC<kSum>{}, f); break;
    case kSumF: with_float_kind(lane.kind, OpC<kSumF>{}, f); break;
    case kMin:
      if (is_float) with_float_kind(lane.kind, OpC<kMin>{}, f);
      else with_int_kind(lane.kind, OpC<kMin>{}, f);
      break;
    default:
      if (is_float) with_float_kind(lane.kind, OpC<kMax>{}, f);
      else with_int_kind(lane.kind, OpC<kMax>{}, f);
      break;
  }
}

// Shared-memory layout common to both kernels: the lane descriptors, then
// the block's partials [group][lane].
__device__ __forceinline__ void load_lanes(const LaneParams& params,
                                           int num_lanes, int m,
                                           Lane* lane_s, long long* blk) {
  for (int j = threadIdx.x; j < num_lanes; j += blockDim.x) {
    lane_s[j] = params.lane[j];
  }
  __syncthreads();
  for (int j = threadIdx.x; j < m * num_lanes; j += blockDim.x) {
    blk[j] = lane_s[j % num_lanes].neutral;
  }
  __syncthreads();
}

// the block's partials to its row of the scratch buffer
__device__ __forceinline__ void flush(int cells, const long long* blk,
                                      long long* __restrict__ scratch) {
  __syncthreads();
  long long* row = scratch + static_cast<int64_t>(blockIdx.x) * cells;
  for (int j = threadIdx.x; j < cells; j += blockDim.x) row[j] = blk[j];
}

// ---- small domains: per-thread private partials ---------------------------

// One lane over the tile's rows: each thread takes rows tid, tid + 256,
// ... in batches of kBatch, issuing every load of a batch before its first
// shared-memory update, so the loads are in flight together.
template <typename T, int64_t OP>
__device__ __forceinline__ void tile_rows(Type<T> type, OpC<OP> op,
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
        v[b] = value(type, op, lane.values, row);
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

template <bool FLOATS>
__global__ void __launch_bounds__(kThreads)
accumulate_small_kernel(const int32_t* __restrict__ gid, int64_t n,
                        const __grid_constant__ LaneParams params,
                        int num_lanes, int m,
                        long long* __restrict__ scratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  Lane* lane_s = reinterpret_cast<Lane*>(smem);
  long long* blk = reinterpret_cast<long long*>(lane_s + num_lanes);
  long long* priv = blk + m * num_lanes;  // [group][thread]
  uint8_t* gid_s = reinterpret_cast<uint8_t*>(priv + m * kThreads);
  long long* mine = priv + threadIdx.x;
  load_lanes(params, num_lanes, m, lane_s, blk);

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
      with_lane<FLOATS>(lane, [&](auto type, auto op) {
        tile_rows(type, op, lane, base, rows, gid_s, mine);
      });
      __syncthreads();
      long long acc = lane.neutral;
      if (fold_g < m) {
        const long long* col = priv + fold_g * kThreads + fold_part;
#pragma unroll
        for (int q = 0; q < kThreads / 16; ++q) {
          acc = combine_rt<FLOATS>(lane.op, acc, col[q * 16]);
        }
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        acc = combine_rt<FLOATS>(lane.op, acc,
                                 __shfl_xor_sync(kFull, acc, off, 16));
      }
      if (fold_g < m && fold_part == 0) {
        long long* cell = blk + fold_g * num_lanes + l;
        *cell = combine_rt<FLOATS>(lane.op, *cell, acc);
      }
      __syncthreads();
    }
  }
  flush(m * num_lanes, blk, scratch);
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

// m is the window's width: a row of gid in [g0, g0 + m) is in its group
// gid - g0 (g0 = 0 and m the domain when the domain fits one launch)
template <int THREADS, bool FLOATS>
__global__ void __launch_bounds__(THREADS)
accumulate_large_kernel(const int32_t* __restrict__ gid, int64_t n,
                        const __grid_constant__ LaneParams params,
                        int num_lanes, int m, int g0,
                        long long* __restrict__ scratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  Lane* lane_s = reinterpret_cast<Lane*>(smem);
  long long* blk = reinterpret_cast<long long*>(lane_s + num_lanes);
  // tag[g]: the thread that last claimed group g (any warp of the block)
  uint16_t* tag = reinterpret_cast<uint16_t*>(blk + m * num_lanes);
  load_lanes(params, num_lanes, m, lane_s, blk);

  const int lane_id = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const uint16_t me = static_cast<uint16_t>(threadIdx.x);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * THREADS;
  // a block-uniform loop: the warp's collectives run converged, and the
  // float sums' barriers are reached by every thread
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * THREADS;
       base < n; base += stride) {
    const int64_t row = base + threadIdx.x;
    const bool in = row < n;
    const int32_t g = in ? gid[row] - g0 : -1;
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
      with_lane<FLOATS>(lane, [&](auto type, auto op_c) {
        constexpr int64_t OP = decltype(op_c)::value;
        long long v = lane.neutral;
        if (ok && (lane.valid == nullptr || lane.valid[row] != 0)) {
          v = value(type, op_c, lane.values, row);
        }
        // rank r ends holding the combine of ranks [r, count)
#pragma unroll
        for (int k = 0; k < 5; ++k) {
          if (k >= steps) break;
          const long long o = __shfl_sync(kFull, v, src[k]);
          if (rank + (1 << k) < count) v = combine<OP>(v, o);
        }
        long long* cell = blk + (ok ? g : 0) * num_lanes + l;
        if constexpr (OP == kSumF) {
          // warp after warp: the leaders of one warp are in distinct
          // groups, so each adds to its cell alone
          for (int w = 0; w < THREADS / 32; ++w) {
            if (w == warp && ok && rank == 0) {
              *cell = combine<kSumF>(*cell, v);
            }
            __syncthreads();
          }
        } else if (ok && rank == 0) {
          atomic_fold<OP>(cell, v);
        }
      });
    }
  }
  flush(m * num_lanes, blk, scratch);
}

// out[cell] = the decoded fold of scratch[0..blocks)[cell]: one block a
// cell, thread t folding rows t, t + 256, ... in order, then a fixed tree
// (the warp's shuffles, then warp 0's eight results in order), so that a
// few cells over many rows (planned q4: 792 rows of 18 cells) still
// spread their loads over many threads.
__global__ void __launch_bounds__(kThreads)
fold_kernel(const __grid_constant__ LaneParams params, int num_lanes,
            int cells, int blocks, const long long* __restrict__ scratch,
            long long* __restrict__ out) {
  __shared__ long long warp_acc[kThreads / 32];
  const int cell = blockIdx.x;
  const Lane& lane = params.lane[cell % num_lanes];
  long long acc = lane.neutral;
  for (int b = threadIdx.x; b < blocks; b += kThreads) {
    acc = combine_rt<true>(lane.op, acc,
                           scratch[static_cast<int64_t>(b) * cells + cell]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc = combine_rt<true>(lane.op, acc, __shfl_xor_sync(kFull, acc, off));
  }
  if ((threadIdx.x & 31) == 0) warp_acc[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    acc = warp_acc[0];
    for (int w = 1; w < kThreads / 32; ++w) {
      acc = combine_rt<true>(lane.op, acc, warp_acc[w]);
    }
    out[cell] = decode(lane, acc);
  }
}

size_t small_smem(int num_lanes, int m) {
  return static_cast<size_t>(num_lanes) * sizeof(Lane) +
         static_cast<size_t>(m) * num_lanes * sizeof(long long) +
         static_cast<size_t>(m) * kThreads * sizeof(long long) + kTile;
}

size_t large_smem(int num_lanes, int m) {
  return static_cast<size_t>(num_lanes) * sizeof(Lane) +
         static_cast<size_t>(m) * num_lanes * sizeof(long long) +
         static_cast<size_t>(m) * sizeof(uint16_t);
}

const void* kernel_for(int m, int threads, bool floats) {
  const bool wide = threads == kWideThreads;
  if (m <= kSmallM) {
    return floats ? reinterpret_cast<const void*>(accumulate_small_kernel<true>)
                  : reinterpret_cast<const void*>(accumulate_small_kernel<false>);
  }
  if (floats) {
    return wide ? reinterpret_cast<const void*>(
                      accumulate_large_kernel<kWideThreads, true>)
                : reinterpret_cast<const void*>(
                      accumulate_large_kernel<kThreads, true>);
  }
  return wide ? reinterpret_cast<const void*>(
                    accumulate_large_kernel<kWideThreads, false>)
              : reinterpret_cast<const void*>(
                    accumulate_large_kernel<kThreads, false>);
}

// Above 48 KB a kernel takes dynamic shared memory only after opting in.
int allow(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

int resident(const void* kernel, int threads, size_t smem, int* per_sm) {
  const int err = allow(kernel, smem);
  if (err != 0) return err;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, kernel, threads, smem));
}

}  // namespace

// The launch shape of num_lanes lanes over m groups (floats: any float
// lane among them): the block size (*threads) and how many such blocks
// one multiprocessor holds (*per_sm). The large kernel takes 1,024
// threads only when that keeps more warps resident than 256 does.
extern "C" int srjt_groupby_accumulate_shape(int32_t num_lanes, int32_t m,
                                             int32_t floats, int32_t* threads,
                                             int32_t* per_sm) {
  const bool small = m <= kSmallM;
  const size_t smem = small ? small_smem(num_lanes, m) : large_smem(num_lanes, m);
  if (num_lanes < 1 || num_lanes > kParamLanes || smem > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int narrow = 0;
  int err = resident(kernel_for(m, kThreads, floats != 0), kThreads, smem, &narrow);
  if (err != 0) return err;
  *threads = kThreads;
  *per_sm = narrow < 1 ? 1 : narrow;
  if (!small) {
    int wide = 0;
    err = resident(kernel_for(m, kWideThreads, floats != 0), kWideThreads,
                   smem, &wide);
    if (err != 0) return err;
    if (wide * kWideThreads > narrow * kThreads) {
      *threads = kWideThreads;
      *per_sm = wide;
    }
  }
  return 0;
}

// gid: device int32[n]; lanes: HOST int64[num_lanes, 5] (see Lane),
// 1 <= num_lanes <= kParamLanes; the window: groups [g0, g0 + m) (g0 = 0
// and m the domain when it fits one launch; a window needs m > kSmallM);
// floats and threads as given to and by srjt_groupby_accumulate_shape;
// scratch: device int64[blocks, m * num_lanes]; out: device int64[m,
// num_lanes], the window's rows of the result, each cell the 64-bit
// pattern of its result (a float lane's float64 bits, a uint64 lane's
// bits). m <= kSmallM takes the per-thread kernel, larger m the
// warp-aggregated one. Launches on ``stream`` and returns the first CUDA
// error.
extern "C" int srjt_groupby_accumulate(const void* gid, int64_t n,
                                       const void* lanes, int32_t num_lanes,
                                       int32_t m, int32_t g0, int32_t floats,
                                       int32_t threads, void* scratch,
                                       int32_t blocks, void* out,
                                       void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (num_lanes < 1 || num_lanes > kParamLanes || blocks < 1 || g0 < 0 ||
      (g0 > 0 && m <= kSmallM)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  LaneParams params{};
  memcpy(params.lane, lanes, static_cast<size_t>(num_lanes) * sizeof(Lane));
  const int32_t* g = static_cast<const int32_t*>(gid);
  long long* part = static_cast<long long*>(scratch);
  const bool small = m <= kSmallM;
  const size_t smem = small ? small_smem(num_lanes, m) : large_smem(num_lanes, m);
  const int block = small ? kThreads : threads;
  const void* kernel = kernel_for(m, block, floats != 0);
  const int err = allow(kernel, smem);
  if (err != 0) return err;
  void* small_args[] = {&g, &n, &params, &num_lanes, &m, &part};
  void* large_args[] = {&g, &n, &params, &num_lanes, &m, &g0, &part};
  cudaError_t e = cudaLaunchKernel(kernel, dim3(blocks), dim3(block),
                                   small ? small_args : large_args, smem, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int cells = m * num_lanes;
  fold_kernel<<<cells, kThreads, 0, s>>>(params, num_lanes, cells, blocks,
                                         part, static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}
