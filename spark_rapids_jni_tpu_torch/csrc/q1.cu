// Fused TPC-H q1 for Hopper (sm_90a): the whole query in one pass.
//
// Replaces the Pallas kernel spark_rapids_jni_tpu/ops/pallas/q1.py
// (_q1_partials_fn, body _q1_kernel): the shipdate filter, group slots
// from the declared flag domains, the derived disc_price and charge, and
// per-slot sums, in one streaming pass over lineitem.
//
// What differs from the TPU kernel:
// - it reads the stored columns as they are (four int64 decimals, two
//   int8 flags, the int32 shipdate): no int32 cast pass and no padding of
//   the row count to 2048;
// - charge = price * (100 - disc) * (100 + tax) is computed per row in
//   native int64 (at most ~1.1e11 on TPC-H data, wrapping like the plain
//   version's int64 tensors elsewhere), so the 12- and 16-bit limb lanes
//   go;
// - there is no atomic per row: each thread sums its rows into private
//   partials in shared memory, and a block folds them into the output at
//   its end.
//
// Slot rules (ops/pallas/q1.py:100-109): rows past the shipdate cutoff go
// to slot 6, kept rows whose flags lie outside the declared domains to
// slot 7, the rest to returnflag_code * 2 + linestatus_code.
//
// Bound on this card: bytes (38 bytes read per row). The first design
// kept 8 slots x 6 sums in registers and added every row's values to all
// of them under a predicate per slot: 125 registers (2 blocks of 256 a
// SM), one row's loads in flight per thread, then ~100 integer
// instructions before the next row's loads, and a block fold through
// 64-bit shared atomicAdd, which sm_90a compiles to a compare-and-swap
// loop (ATOMS.CAST.SPIN.64, 48 of them). It ran at 0.36 of the bound.
//
// This design:
// - each thread owns a column of 8 x 6 int64 partials in shared memory,
//   laid out [slot][sum][thread] (384 bytes a thread, 48 KB a block of
//   128; 4 blocks, 16 warps, a SM), so a warp's 32 updates of one sum
//   fall on 32 consecutive words whatever their slots: no bank pair is
//   shared and no atomic is needed. A row costs 6 load-add-store pairs on
//   its own slot's column;
// - a thread takes kBatch rows of a chunk (rows base + b * kThreads +
//   tid, so every warp load is one coalesced run) and issues all of
//   their loads before its first update, so kBatch rows are in flight per
//   thread rather than one;
// - the grid is persistent: as many blocks as fit on the card
//   (cudaOccupancyMaxActiveBlocksPerMultiprocessor), each striding over
//   the chunks;
// - at its end a block folds the 128 columns with shuffles, one warp per
//   (slot, sum) cell, and adds each non-zero cell to the output with one
//   global 64-bit atomicAdd (REDG.E.ADD.64 in the SASS: no CAS loop).
// Measured on the H100 at SF10 (PERF.md section 6): 0.76 ms in the
// kernel, 0.9 of the byte bound (the first design: 1.77 ms). ptxas: 80
// registers, no spills. Variants measured in the same call, none faster
// beyond the spread between runs: 8 rows a batch (124 registers), 256
// threads a block (96 KB), 16-byte loads of row pairs where every column
// is aligned for them; and a warp-level reduction per slot (a ballot per
// slot, 16-bit limbs summed by __reduce_add_sync, sums in registers),
// three times slower: counted from its source, it issues some ten warp
// instructions a row against about two here.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSlots = 8;
constexpr int kSums = 6;  // count, qty, price, disc, disc_price, charge
constexpr int kCells = kSlots * kSums;
constexpr int kThreads = 128;
constexpr int kBatch = 4;                     // rows in flight per thread
constexpr int kChunk = kThreads * kBatch;     // rows per block step
constexpr size_t kSmem = sizeof(unsigned long long) * kCells * kThreads;
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Q1Params {
  int32_t cutoff;
  int32_t rf0, rf1, rf2;  // returnflag domain, sorted
  int32_t ls0, ls1;       // linestatus domain, sorted
};

struct Columns {
  const long long* __restrict__ qty;
  const long long* __restrict__ price;
  const long long* __restrict__ disc;
  const long long* __restrict__ tax;
  const int8_t* __restrict__ rf;
  const int8_t* __restrict__ ls;
  const int32_t* __restrict__ ship;
};

__device__ __forceinline__ int slot_of(int32_t ship, int r, int l,
                                       const Q1Params& p) {
  const int rfc = r == p.rf0 ? 0 : r == p.rf1 ? 1 : r == p.rf2 ? 2 : -1;
  const int lsc = l == p.ls0 ? 0 : l == p.ls1 ? 1 : -1;
  if (ship > p.cutoff) return 6;
  return (rfc < 0 || lsc < 0) ? 7 : rfc * 2 + lsc;
}

// One chunk: rows base + b * kThreads + threadIdx.x for b < kBatch. All
// loads first, then the updates of this thread's partials. Unsigned
// arithmetic: int64 products and sums wrap as the plain version's do.
template <bool kTail>
__device__ __forceinline__ void chunk(const Columns& c, int64_t base,
                                      int64_t n, const Q1Params& p,
                                      unsigned long long* mine) {
  unsigned long long q[kBatch], pr[kBatch], d[kBatch], tx[kBatch];
  int32_t sh[kBatch];
  int r[kBatch], l[kBatch];
#pragma unroll
  for (int b = 0; b < kBatch; ++b) {
    const int64_t i = base + b * kThreads + threadIdx.x;
    if (!kTail || i < n) {
      q[b] = c.qty[i];
      pr[b] = c.price[i];
      d[b] = c.disc[i];
      tx[b] = c.tax[i];
      sh[b] = c.ship[i];
      r[b] = c.rf[i];
      l[b] = c.ls[i];
    }
  }
#pragma unroll
  for (int b = 0; b < kBatch; ++b) {
    if (kTail && base + b * kThreads + threadIdx.x >= n) break;
    const unsigned long long dp = pr[b] * (100ull - d[b]);
    const unsigned long long ch = dp * (100ull + tx[b]);
    unsigned long long* cell =
        mine + slot_of(sh[b], r[b], l[b], p) * kSums * kThreads;
    cell[0 * kThreads] += 1;
    cell[1 * kThreads] += q[b];
    cell[2 * kThreads] += pr[b];
    cell[3 * kThreads] += d[b];
    cell[4 * kThreads] += dp;
    cell[5 * kThreads] += ch;
  }
}

__global__ void __launch_bounds__(kThreads, 4)
q1_kernel(const Columns c, int64_t n, const Q1Params p,
          unsigned long long* __restrict__ out) {
  extern __shared__ unsigned long long part[];  // [slot][sum][thread]
  unsigned long long* mine = part + threadIdx.x;
#pragma unroll
  for (int j = 0; j < kCells; ++j) mine[j * kThreads] = 0;

  const int64_t chunks = (n + kChunk - 1) / kChunk;
  for (int64_t k = blockIdx.x; k < chunks; k += gridDim.x) {
    const int64_t base = k * kChunk;
    if (base + kChunk <= n) {
      chunk<false>(c, base, n, p, mine);
    } else {
      chunk<true>(c, base, n, p, mine);
    }
  }

  // fold: warp w sums cells w, w + 4, ... over the block's 128 columns
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int cell = threadIdx.x >> 5; cell < kCells;
       cell += kThreads / 32) {
    const unsigned long long* col = part + cell * kThreads;
    unsigned long long x = 0;
#pragma unroll
    for (int j = 0; j < kThreads / 32; ++j) x += col[j * 32 + lane];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      x += __shfl_xor_sync(kFull, x, off);
    }
    if (lane == 0 && x != 0) atomicAdd(out + cell, x);
  }
}

}  // namespace

// Columns are device pointers of n rows (any element alignment); out:
// device int64[8, 6], zeroed by the caller. Launches on ``stream`` and
// returns the first CUDA error.
extern "C" int srjt_q1_partials(const void* qty, const void* price,
                                const void* disc, const void* tax,
                                const void* rf, const void* ls,
                                const void* ship, int64_t n, int32_t cutoff,
                                const int32_t* rf_domain,
                                const int32_t* ls_domain, void* out,
                                int32_t sms, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const Q1Params p{cutoff,       rf_domain[0], rf_domain[1],
                   rf_domain[2], ls_domain[0], ls_domain[1]};
  const Columns c{static_cast<const long long*>(qty),
                  static_cast<const long long*>(price),
                  static_cast<const long long*>(disc),
                  static_cast<const long long*>(tax),
                  static_cast<const int8_t*>(rf),
                  static_cast<const int8_t*>(ls),
                  static_cast<const int32_t*>(ship)};
  cudaError_t err;
  if (kSmem > 48 * 1024) {
    err = cudaFuncSetAttribute(q1_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, q1_kernel,
                                                      kThreads, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) per_sm = 1;
  const int64_t want = (n + kChunk - 1) / kChunk;
  const int64_t cap = static_cast<int64_t>(sms) * per_sm;
  const int blocks = static_cast<int>(want < cap ? want : cap);
  q1_kernel<<<blocks, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      c, n, p, static_cast<unsigned long long*>(out));
  return static_cast<int>(cudaGetLastError());
}
