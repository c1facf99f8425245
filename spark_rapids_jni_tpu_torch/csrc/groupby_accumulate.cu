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
//   * any m an int32 gid can name (below).
//
// Bound on this card: bytes (each row's group id, and each lane's value
// and validity bytes, read once). Three kernels, by the domain:
// - Small domains (m <= kSmallM: planned q1, q12, q4): per-thread private
//   partials. Lanes outer, rows inner: a block walks tiles of kTile rows,
//   stages the tile's group ids in shared memory once, then runs each lane
//   over the tile (one warp-uniform switch per lane and tile, with_lane).
//   Every thread owns a column of m partials in shared memory, laid out
//   [group][thread] so a warp's updates never share a bank pair, updated
//   with a plain load and store; 16 threads per group then fold the 256
//   columns into the block's partials. Loads go kBatch rows at a time
//   ahead of their updates. (The first design sent every (row, lane)
//   through a 64-bit shared atomic, a compare-and-swap loop on sm_90a,
//   ATOMS.CAST.SPIN.64, and reached a fifth of the bound at q1; this
//   reaches about half.)
// - Larger domains one launch holds (the monthly rollup, q5, up to ~23,000
//   slots a lane): the block's partials in shared memory, rows outer,
//   lanes inner, in blocks of 256 or 1,024 threads, whichever keeps more
//   warps resident (q5's hot null slot, ~99.9 % of its rows, ran slower
//   in 1,024-thread blocks). A warp takes 32 rows at a time and tests
//   whether they are in 32 groups (each row writes its thread id into a
//   two-byte tag per group and reads it back), then whether they are all
//   in one (one compare: q5's warps); otherwise __match_any_sync finds the
//   groups. Each lane's values reduce over their rank order in as many
//   shuffle steps as the largest group needs, and one leader per group
//   updates the block's partials:
//   * the partials are lane-major (a lane's m cells together), so the
//     leaders of a warp, in distinct groups, hit different banks. Laid
//     out [group][lane], a group's cells at the rollup's 16 lanes span
//     128 bytes, so every leader of a lane hit one bank pair: each update
//     was a ~31-way bank conflict, and the rollup took 22.3-23.1 ms where
//     its lanes split by kind took 1.0-2.2 ms each (PERF.md);
//   * integer sums are native 32-bit shared atomicAdds on the cell's low
//     and high words (planes of their own), the carry found from the low
//     word's old value: exact in any order, no CAS loop;
//   * min/max read the cell first and take the 64-bit CAS loop only when
//     the row would win (rarely, past a block's first rows);
//   * float sums commit warp after warp, each warp waiting for its turn on
//     a counter in shared memory instead of 32 block barriers per 1,024
//     rows; the order, and so the bits, are those of the barriers.
//   Each block writes its partials to its row of a scratch buffer, and
//   fold_kernel folds the rows of each cell in a fixed tree.
// - Past one launch's shared memory (m = 100,001, SF10's supplier keys):
//   one pass over the rows, the partials in global memory (out itself:
//   100,001 x 8 distinct lanes is 6.4 MB, which stays in the 50 MB L2),
//   updated with native 64-bit global atomics (atomicAdd, and atomicMin/
//   atomicMax on the order key; reading a min/max cell first measured no
//   faster). The distinct test hashes groups into 4,096 tags. A warp keeps
//   a hot group (kRunRows of its 32 rows) as its run, its partials private
//   in shared memory while the group keeps appearing, so one group does
//   not queue every warp at one L2 address. The leaders' values wait in
//   shared memory and go out row by row, one op after another, so a
//   warp's atomics cover adjacent cells of a few rows: a row's atomics
//   each on its own took 6.5 ms, row by row 4.4 (about 3.8 of the 6.5 ms
//   were atomics: with them cut the kernel took 2.7). Float sums are the
//   exception: their order must be fixed, so the wrapper sends them
//   through windows of groups [g0, g0 + w), a launch of the large kernel
//   each.
// - A launch of integer lanes only takes kernels compiled without the
//   float paths (FLOATS = false): with them the small kernel needed 54
//   registers, or spilled at 40, and planned q1's A took 1.86-1.98 ms
//   against 1.55 before the float paths existed (PERF.md).
// Tried and dropped on the card (PERF.md): loading a chunk of 8 lanes of
// a row before folding any (64-106 registers, slower everywhere), an L2
// prefetch of the next rows, two 32-row sets a warp, a division-free
// commit and 8,192 tags (no change), more blocks an SM by launch bounds
// (spills). With its loads cut the one-pass kernel took 0.5 ms less and
// with its atomics cut 0.15 ms less: the rest is per-row, per-lane work.
// The lane descriptors travel in the launch's parameters, so a launch
// makes no host-to-device copy and the card does not wait on the host.
// Each shape's time beside its bound, plain version and library call is
// in PERF.md's kernel tables.
// Dynamic shared memory per block: 40 bytes a lane plus m * L partials
// (8 bytes each); the small kernel adds m * 256 private partials and the
// tile's 8,192 one-byte group ids, the large kernel a 16-byte turn counter
// and m two-byte tags (m: the window's width); the one-pass kernel 40
// bytes and a run cell per warp a lane, beside ~38 KB of static tags,
// staged values and lane order.
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

// ---- larger domains: the warp's groups ------------------------------------

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

// How a warp's 32 rows fall into groups. Rows of one group combine over
// their rank order: step k adds rank r + 2^k into rank r, so rank 0 (the
// group's leader) ends holding the whole group in as many steps as the
// warp's largest group needs (none when the rows are in 32 groups).
struct WarpGroups {
  int rank;    // among the warp's rows of this row's group
  int count;   // rows of the warp in this row's group
  int big;     // rows of the warp's largest group (rows in no group aside)
  int steps;   // shuffle steps: ceil(log2(big))
  int src[5];  // the lane that step k reads
};

// distinct: the warp's rows are known to be in 32 different groups (rows
// in no group aside); otherwise __match_any_sync finds the groups.
__device__ __forceinline__ WarpGroups warp_groups(bool ok, int g,
                                                  bool distinct,
                                                  int lane_id) {
  WarpGroups w{0, 1, 1, 0, {lane_id, lane_id, lane_id, lane_id, lane_id}};
  if (distinct) return w;
  const int key = ok ? g : -1;
  if (__all_sync(kFull, key == __shfl_sync(kFull, key, 0))) {
    // one set (a hot group, q5's null slot): ranks are lanes, no match
    w.rank = lane_id;
    w.count = 32;
    w.big = ok ? 32 : 1;
    w.steps = ok ? 5 : 0;
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      if (lane_id + (1 << k) < 32) w.src[k] = lane_id + (1 << k);
    }
    return w;
  }
  {
    // rows in no group form one more set, whose leader writes nothing
    const unsigned peers = __match_any_sync(kFull, key);
    w.rank = __popc(peers & ((1u << lane_id) - 1u));
    w.count = __popc(peers);
    w.big = __reduce_max_sync(kFull, ok ? w.count : 1);
    w.steps = 32 - __clz(w.big - 1);
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      const int r = w.rank + (1 << k);
      if (k < w.steps && r < w.count) w.src[k] = nth_set_bit(peers, r);
    }
  }
  return w;
}

// rank r ends holding the combine of ranks [r, count) of its group
template <int64_t OP>
__device__ __forceinline__ long long warp_reduce(long long v,
                                                 const WarpGroups& w) {
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    if (k >= w.steps) break;  // steps is warp-uniform
    const long long o = __shfl_sync(kFull, v, w.src[k]);
    if (w.rank + (1 << k) < w.count) v = combine<OP>(v, o);
  }
  return v;
}

// the lane's word for this row, its neutral where the row is in no group
// or invalid; the value and validity loads do not wait on each other
template <typename T, int64_t OP>
__device__ __forceinline__ long long row_word(Type<T> type, OpC<OP> op_c,
                                              const Lane& lane, bool ok,
                                              int64_t row) {
  const long long v = ok ? value(type, op_c, lane.values, row) : 0;
  const bool valid = ok && (lane.valid == nullptr || lane.valid[row] != 0);
  return valid ? v : lane.neutral;
}

// ---- larger domains, one launch: the block's partials in shared memory ----
//
// Lane-major: lane l's m cells start at blk + l * m, so the leaders of one
// warp (distinct groups) update cells in different banks. A sum lane keeps
// its cells as two planes of uint32 (the m low words, then the m high
// words); a min/max or float-sum lane keeps m int64 words.

constexpr int kTurnBytes = 16;  // the float sums' turn counter, 16-aligned

__device__ __forceinline__ void large_init(const Lane* lane_s, int num_lanes,
                                           int m, long long* blk) {
  for (int j = threadIdx.x; j < m * num_lanes; j += blockDim.x) {
    const int l = j / m;
    const int g = j - l * m;
    const Lane& lane = lane_s[l];
    long long* cells = blk + static_cast<int64_t>(l) * m;
    if (lane.op == kSum) {
      unsigned* word = reinterpret_cast<unsigned*>(cells);
      const unsigned long long u = static_cast<unsigned long long>(lane.neutral);
      word[g] = static_cast<unsigned>(u);
      word[m + g] = static_cast<unsigned>(u >> 32);
    } else {
      cells[g] = lane.neutral;
    }
  }
  __syncthreads();
}

// the block's partials to its row of the scratch buffer, [group][lane]
__device__ __forceinline__ void large_flush(const Lane* lane_s, int num_lanes,
                                            int m, const long long* blk,
                                            long long* __restrict__ scratch) {
  __syncthreads();
  const int cells = m * num_lanes;
  long long* row = scratch + static_cast<int64_t>(blockIdx.x) * cells;
  for (int j = threadIdx.x; j < cells; j += blockDim.x) {
    const int g = j / num_lanes;
    const int l = j - g * num_lanes;
    const long long* lane_cells = blk + static_cast<int64_t>(l) * m;
    if (lane_s[l].op == kSum) {
      const unsigned* word = reinterpret_cast<const unsigned*>(lane_cells);
      row[j] = static_cast<long long>(
          (static_cast<unsigned long long>(word[m + g]) << 32) | word[g]);
    } else {
      row[j] = lane_cells[g];
    }
  }
}

// A wrapping int64 sum as native 32-bit shared atomics on the cell's low
// and high words: the high word's add goes first, not waiting; the low
// word's old value tells whether this add wrapped it (old + lo < old), and
// the carry is one more add to the high word. Every wrap of the low word
// is counted once, by the add that caused it, so the int64 total is exact
// in any order of the adds.
__device__ __forceinline__ void shared_add(long long* cells, int m, int g,
                                           long long v) {
  unsigned* word = reinterpret_cast<unsigned*>(cells);
  const unsigned long long u = static_cast<unsigned long long>(v);
  const unsigned lo = static_cast<unsigned>(u);
  const unsigned hi = static_cast<unsigned>(u >> 32);
  if (hi != 0) atomicAdd(word + m + g, hi);
  if (lo != 0) {
    const unsigned old = atomicAdd(word + g, lo);
    if (old + lo < old) atomicAdd(word + m + g, 1u);
  }
}

// A 64-bit shared min/max is a compare-and-swap loop on sm_90a; past a
// block's first rows almost no row wins, so read the cell first. A stale
// read is an older value of a cell that only moves toward the winner, so
// it can only send a row to the atomic that needs none, never skip one.
template <int64_t OP>
__device__ __forceinline__ void shared_minmax(long long* cell, long long v) {
  const long long cur = *reinterpret_cast<volatile long long*>(cell);
  if (OP == kMin ? v < cur : v > cur) {
    if constexpr (OP == kMin) {
      atomicMin(cell, v);
    } else {
      atomicMax(cell, v);
    }
  }
}

// Float sums add in a fixed order: iteration by iteration, lane by lane,
// warp 0 to the last. A warp waits for its turn (the count of commits
// before its own), adds its leaders' values and passes the turn on; no
// block-wide barrier, so the warps not at a commit run ahead to their next
// loads. The order is that of a block barrier per warp, and so the bits.
__device__ __forceinline__ void turn_wait(const unsigned* turn,
                                          unsigned ticket) {
  while (*reinterpret_cast<const volatile unsigned*>(turn) != ticket) {
  }
  __threadfence_block();
}

__device__ __forceinline__ void turn_pass(unsigned* turn, unsigned ticket) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) {
    __threadfence_block();
    *reinterpret_cast<volatile unsigned*>(turn) = ticket + 1;
  }
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
  unsigned* turn = reinterpret_cast<unsigned*>(smem);
  Lane* lane_s = reinterpret_cast<Lane*>(smem + kTurnBytes);
  long long* blk = reinterpret_cast<long long*>(lane_s + num_lanes);
  // tag[g]: the thread that last claimed group g (any warp of the block)
  uint16_t* tag = reinterpret_cast<uint16_t*>(
      blk + static_cast<int64_t>(m) * num_lanes);
  for (int j = threadIdx.x; j < num_lanes; j += THREADS) {
    lane_s[j] = params.lane[j];
  }
  if (threadIdx.x == 0) *turn = 0;
  __syncthreads();
  large_init(lane_s, num_lanes, m, blk);

  const int lane_id = threadIdx.x & 31;
  const uint16_t me = static_cast<uint16_t>(threadIdx.x);
  unsigned ticket = threadIdx.x >> 5;  // this warp's next float-sum turn
  const int64_t stride = static_cast<int64_t>(gridDim.x) * THREADS;
  // a block-uniform loop: every warp takes every float-sum turn
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * THREADS;
       base < n; base += stride) {
    const int64_t row = base + threadIdx.x;
    const int32_t g = row < n ? gid[row] - g0 : -1;
    const bool ok = g >= 0 && g < m;
    // Are the warp's rows in distinct groups? Each claims its group's
    // tag; two rows of one group cannot both read their own claim back,
    // so "all read their own" proves it (another warp's claim in between
    // only sends the warp down the exact path).
    if (ok) tag[g] = me;
    __syncwarp();
    const bool distinct = __all_sync(kFull, !ok || tag[g] == me);
    const WarpGroups wg = warp_groups(ok, g, distinct, lane_id);
    const bool lead = ok && wg.rank == 0;
    for (int l = 0; l < num_lanes; ++l) {
      const Lane lane = lane_s[l];
      with_lane<FLOATS>(lane, [&](auto type, auto op_c) {
        constexpr int64_t OP = decltype(op_c)::value;
        const long long v =
            warp_reduce<OP>(row_word(type, op_c, lane, ok, row), wg);
        long long* cells = blk + static_cast<int64_t>(l) * m;
        if constexpr (OP == kSumF) {
          // the leaders of one warp are in distinct groups: each adds to
          // its cell alone
          turn_wait(turn, ticket);
          if (lead) cells[g] = combine<kSumF>(cells[g], v);
          turn_pass(turn, ticket);
          ticket += THREADS / 32;
        } else if (lead) {
          if constexpr (OP == kSum) {
            shared_add(cells, m, g, v);
          } else {
            shared_minmax<OP>(cells + g, v);
          }
        }
      });
    }
  }
  large_flush(lane_s, num_lanes, m, blk, scratch);
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

// ---- domains past shared memory: one pass, partials in global memory ------
//
// out[m, L] holds the partials themselves (m = 100,001 x 9 lanes is 7.2 MB,
// which stays in the 50 MB L2): integer sums take a native 64-bit global
// atomicAdd, min/max a native 64-bit global atomicMin/atomicMax on the
// order key. Float-sum lanes do not come here (the wrapper sends them to
// the windows of the large kernel, whose order is fixed).

constexpr int kOnePassThreads = 256;
constexpr int kTags = 4096;   // hashed distinct-groups tags, 8 KB a block
constexpr int kRunRows = 8;   // a group with this many of a warp's 32 rows
                              // becomes the warp's run

// Native 64-bit global atomics (REDG.E.ADD.64, REDG.E.MIN.S64, ...): a
// min/max update is one fire-and-forget RED, so it is not read first
// (reading first measured no faster: PERF.md)
template <int64_t OP>
__device__ __forceinline__ void global_fold(long long* cell, long long v) {
  if constexpr (OP == kSum) {
    atomicAdd(reinterpret_cast<unsigned long long*>(cell),
              static_cast<unsigned long long>(v));
  } else if constexpr (OP == kMin) {
    atomicMin(cell, v);
  } else {
    atomicMax(cell, v);
  }
}

__device__ __forceinline__ void global_fold_rt(int64_t op, long long* cell,
                                               long long v) {
  switch (op) {
    case kSum: global_fold<kSum>(cell, v); break;
    case kMin: global_fold<kMin>(cell, v); break;
    default: global_fold<kMax>(cell, v); break;
  }
}

// the warp's run (its partials of one hot group, private to the warp) into
// out: integer sums and min/max do not depend on the order of their terms
__device__ __forceinline__ void flush_run(const Lane* lane_s, int num_lanes,
                                          const long long* run, int g,
                                          long long* out) {
  __syncwarp();
  for (int l = threadIdx.x & 31; l < num_lanes; l += 32) {
    global_fold_rt(lane_s[l].op, out + static_cast<int64_t>(g) * num_lanes + l,
                   run[l]);
  }
  __syncwarp();
}

constexpr int kStageLanes = 12;  // lanes a warp stages before committing
constexpr int kStageRow = kStageLanes + 1;  // padded: rows in other banks

// A warp's staged values, row by row: items (staged row r, lane
// order[j]) of the lanes order[0, count) of one op, so that consecutive
// threads update adjacent cells of a row with one kind of atomic.
template <int64_t OP>
__device__ __forceinline__ void commit_staged(const long long* stage,
                                              const int* stage_g,
                                              const uint8_t* order, int count,
                                              int num_lanes, long long* out) {
  if (count == 0) return;
  const int lane_id = threadIdx.x & 31;
  int r = lane_id / count, j = lane_id - r * count;
  const int dr = 32 / count, dj = 32 - dr * count;
  for (int i = lane_id; i < 32 * count; i += 32) {
    const int g = stage_g[r];
    if (g >= 0) {
      global_fold<OP>(out + static_cast<int64_t>(g) * num_lanes + order[j],
                      stage[r * kStageRow + j]);
    }
    r += dr;
    j += dj;
    if (j >= count) {
      j -= count;
      ++r;
    }
  }
}

// A warp takes 32 rows at a time and reads gid and each lane once. Its
// leaders update out with global atomics, except for the warp's run: a
// hot group (kRunRows or more of the warp's rows) whose partials the warp
// keeps in shared memory while the group appears among its rows, so one
// group, or one holding most rows, does not queue every warp at one L2
// address. The leaders' values wait in shared memory, kStageLanes lanes
// at a time, and go out row by row, one op after another: consecutive
// threads update a row's adjacent cells, so a warp's atomics touch a few
// sectors, not 32 (a row's atomics one at a time took 6.5 ms at
// m = 100,001, row by row 4.4: PERF.md).
template <bool FLOATS>
__global__ void __launch_bounds__(kOnePassThreads)
accumulate_one_pass_kernel(const int32_t* __restrict__ gid, int64_t n,
                           const __grid_constant__ LaneParams params,
                           int num_lanes, int m,
                           long long* __restrict__ out) {
  constexpr int kWarps = kOnePassThreads / 32;
  __shared__ uint16_t tag[kTags];
  __shared__ long long stage[kWarps][32 * kStageRow];
  __shared__ int stage_g[kWarps][32];  // a staged row's group, or -1
  // the lanes in op order (sums, mins, maxs) and where each op starts
  __shared__ uint8_t order[kParamLanes];
  __shared__ int op_start[4];
  extern __shared__ __align__(16) unsigned char smem[];
  Lane* lane_s = reinterpret_cast<Lane*>(smem);
  long long* runs = reinterpret_cast<long long*>(lane_s + num_lanes);
  for (int j = threadIdx.x; j < num_lanes; j += kOnePassThreads) {
    lane_s[j] = params.lane[j];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int k = 0;
    for (int op = kSum; op <= kMax; ++op) {
      op_start[op] = k;
      for (int l = 0; l < num_lanes; ++l) {
        if (lane_s[l].op == op) order[k++] = static_cast<uint8_t>(l);
      }
    }
    op_start[3] = k;
  }
  __syncthreads();

  const int lane_id = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const uint16_t me = static_cast<uint16_t>(threadIdx.x);
  long long* run = runs + warp * num_lanes;
  long long* my_stage = stage[warp] + lane_id * kStageRow;
  int run_g = -1;  // warp-uniform
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kOnePassThreads;
  // a warp-uniform loop
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kOnePassThreads +
                      warp * 32;
       base < n; base += stride) {
    const int64_t row = base + lane_id;
    const int32_t g = row < n ? gid[row] : -1;
    const bool ok = g >= 0 && g < m;
    // the large kernel's distinct test over hashed tags: two groups that
    // share a tag only send the warp down the exact path
    const int h = g & (kTags - 1);
    if (ok) tag[h] = me;
    __syncwarp();
    const bool distinct = __all_sync(kFull, !ok || tag[h] == me);
    const WarpGroups wg = warp_groups(ok, g, distinct, lane_id);
    if (!__any_sync(kFull, ok && g == run_g)) {
      if (run_g >= 0) {
        flush_run(lane_s, num_lanes, run, run_g, out);
        run_g = -1;
      }
      if (wg.big >= kRunRows) {
        const unsigned who =
            __ballot_sync(kFull, ok && wg.rank == 0 && wg.count == wg.big);
        run_g = __shfl_sync(kFull, g, __ffs(who) - 1);
        for (int l = lane_id; l < num_lanes; l += 32) {
          run[l] = lane_s[l].neutral;
        }
        __syncwarp();
      }
    }
    const bool lead = ok && wg.rank == 0;
    const bool to_run = lead && g == run_g;
    stage_g[warp][lane_id] = lead && !to_run ? g : -1;
    const bool staged = __any_sync(kFull, lead && !to_run);
    // the lanes in op order, kStageLanes at a time
    for (int b = 0; b < num_lanes; b += kStageLanes) {
      const int nb = min(kStageLanes, num_lanes - b);
      for (int j = 0; j < nb; ++j) {
        const int l = order[b + j];
        const Lane& lane = lane_s[l];
        with_lane<FLOATS>(lane, [&](auto type, auto op_c) {
          constexpr int64_t OP = decltype(op_c)::value;
          if constexpr (OP != kSumF) {
            const long long v =
                warp_reduce<OP>(row_word(type, op_c, lane, ok, row), wg);
            if (to_run) run[l] = combine<OP>(run[l], v);
            my_stage[j] = v;
          }
        });
      }
      __syncwarp();
      if (!staged) continue;  // every leader is in the run
      // this batch's share of each op's lanes
      const int e = b + nb;
      const int s0 = max(op_start[kSum], b), s1 = min(op_start[kMin], e);
      const int n0 = max(op_start[kMin], b), n1 = min(op_start[kMax], e);
      const int x0 = max(op_start[kMax], b), x1 = min(op_start[3], e);
      commit_staged<kSum>(stage[warp] + (s0 - b), stage_g[warp], order + s0,
                          max(s1 - s0, 0), num_lanes, out);
      commit_staged<kMin>(stage[warp] + (n0 - b), stage_g[warp], order + n0,
                          max(n1 - n0, 0), num_lanes, out);
      commit_staged<kMax>(stage[warp] + (x0 - b), stage_g[warp], order + x0,
                          max(x1 - x0, 0), num_lanes, out);
      __syncwarp();
    }
  }
  if (run_g >= 0) flush_run(lane_s, num_lanes, run, run_g, out);
}

// every cell of out[m, L] to its lane's neutral key
__global__ void __launch_bounds__(kThreads)
init_cells_kernel(const __grid_constant__ LaneParams params, int num_lanes,
                  int64_t cells, long long* __restrict__ out) {
  for (int64_t c = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       c < cells; c += static_cast<int64_t>(gridDim.x) * kThreads) {
    out[c] = params.lane[c % num_lanes].neutral;
  }
}

// every cell's order key back to its value's 64-bit pattern
__global__ void __launch_bounds__(kThreads)
decode_cells_kernel(const __grid_constant__ LaneParams params, int num_lanes,
                    int64_t cells, long long* __restrict__ out) {
  for (int64_t c = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       c < cells; c += static_cast<int64_t>(gridDim.x) * kThreads) {
    out[c] = decode(params.lane[c % num_lanes], out[c]);
  }
}

size_t small_smem(int num_lanes, int m) {
  return static_cast<size_t>(num_lanes) * sizeof(Lane) +
         static_cast<size_t>(m) * num_lanes * sizeof(long long) +
         static_cast<size_t>(m) * kThreads * sizeof(long long) + kTile;
}

size_t large_smem(int num_lanes, int m) {
  return kTurnBytes + static_cast<size_t>(num_lanes) * sizeof(Lane) +
         static_cast<size_t>(m) * num_lanes * sizeof(long long) +
         static_cast<size_t>(m) * sizeof(uint16_t);
}

// the lane descriptors and each warp's run
size_t one_pass_smem(int num_lanes) {
  return static_cast<size_t>(num_lanes) *
         (sizeof(Lane) + kOnePassThreads / 32 * sizeof(long long));
}

const void* one_pass_kernel(bool floats) {
  return floats ? reinterpret_cast<const void*>(accumulate_one_pass_kernel<true>)
                : reinterpret_cast<const void*>(accumulate_one_pass_kernel<false>);
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

// The one-pass kernel's block size (*threads) and how many of its blocks
// one multiprocessor holds (*per_sm) for num_lanes lanes (floats: a float
// min/max lane among them).
extern "C" int srjt_groupby_accumulate_one_pass_shape(int32_t num_lanes,
                                                      int32_t floats,
                                                      int32_t* threads,
                                                      int32_t* per_sm) {
  if (num_lanes < 1 || num_lanes > kParamLanes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int resident_blocks = 0;
  const int err = resident(one_pass_kernel(floats != 0), kOnePassThreads,
                           one_pass_smem(num_lanes), &resident_blocks);
  if (err != 0) return err;
  *threads = kOnePassThreads;
  *per_sm = resident_blocks < 1 ? 1 : resident_blocks;
  return 0;
}

// One pass over the rows for any m: gid: device int32[n] in [0, m] (m: no
// group); lanes: HOST int64[num_lanes, 5] (see Lane), no float sum among
// them; out: device int64[m, num_lanes], each cell the 64-bit pattern of
// its result. Three launches on ``stream``: the neutrals, the rows (blocks
// of kOnePassThreads), and the order keys decoded where a lane has any.
// Returns the first CUDA error.
extern "C" int srjt_groupby_accumulate_one_pass(const void* gid, int64_t n,
                                                const void* lanes,
                                                int32_t num_lanes, int32_t m,
                                                int32_t floats, int32_t blocks,
                                                void* out, void* stream) {
  if (num_lanes < 1 || num_lanes > kParamLanes || blocks < 1 || m < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  LaneParams params{};
  memcpy(params.lane, lanes, static_cast<size_t>(num_lanes) * sizeof(Lane));
  bool keys = false;  // a lane whose cells hold order keys
  for (int l = 0; l < num_lanes; ++l) {
    const Lane& lane = params.lane[l];
    if (lane.op == kSumF) return static_cast<int>(cudaErrorInvalidValue);
    keys |= lane.op != kSum && (lane.kind == kU64 || lane.kind == kF32 ||
                                lane.kind == kF64);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long* o = static_cast<long long*>(out);
  const int64_t cells = static_cast<int64_t>(m) * num_lanes;
  const int fill = static_cast<int>(
      cells / kThreads + 1 < 4096 ? cells / kThreads + 1 : 4096);
  init_cells_kernel<<<fill, kThreads, 0, s>>>(params, num_lanes, cells, o);
  if (n > 0) {
    const void* kernel = one_pass_kernel(floats != 0);
    const size_t smem = one_pass_smem(num_lanes);
    const int err = allow(kernel, smem);
    if (err != 0) return err;
    const int32_t* g = static_cast<const int32_t*>(gid);
    void* args[] = {&g, &n, &params, &num_lanes, &m, &o};
    const cudaError_t e = cudaLaunchKernel(kernel, dim3(blocks),
                                           dim3(kOnePassThreads), args, smem, s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (keys) {
    decode_cells_kernel<<<fill, kThreads, 0, s>>>(params, num_lanes, cells, o);
  }
  return static_cast<int>(cudaGetLastError());
}
