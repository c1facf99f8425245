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
//   native int64 (at most ~1.1e11), so the 12- and 16-bit limb lanes go;
// - each thread keeps its 8 slots x 6 sums in registers, adding every
//   row's values under a predicate per slot instead of indexing by slot,
//   so there is no atomic per row at all. The partials are reduced by
//   warp shuffles, then in shared memory, then folded into the output
//   with one global atomic per (slot, sum) per block.
//
// Slot rules (ops/pallas/q1.py:100-109): rows past the shipdate cutoff go
// to slot 6, kept rows whose flags lie outside the declared domains to
// slot 7, the rest to returnflag_code * 2 + linestatus_code.
//
// Bound on this card: bytes (38 bytes read per row); the ~50 predicated
// int64 adds per row stay below the memory time.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSlots = 8;
constexpr int kSums = 6;  // count, qty, price, disc, disc_price, charge
constexpr int kThreads = 256;

struct Q1Params {
  int32_t cutoff;
  int32_t rf0, rf1, rf2;  // returnflag domain, sorted
  int32_t ls0, ls1;       // linestatus domain, sorted
};

__global__ void __launch_bounds__(kThreads)
q1_kernel(const long long* __restrict__ qty,
          const long long* __restrict__ price,
          const long long* __restrict__ disc,
          const long long* __restrict__ tax,
          const int8_t* __restrict__ rf, const int8_t* __restrict__ ls,
          const int32_t* __restrict__ ship, int64_t n, Q1Params p,
          long long* __restrict__ out) {
  long long acc[kSlots][kSums];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
#pragma unroll
    for (int k = 0; k < kSums; ++k) acc[s][k] = 0;
  }

  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    const bool keep = ship[i] <= p.cutoff;
    const int r = rf[i];
    const int l = ls[i];
    const int rfc = r == p.rf0 ? 0 : r == p.rf1 ? 1 : r == p.rf2 ? 2 : -1;
    const int lsc = l == p.ls0 ? 0 : l == p.ls1 ? 1 : -1;
    const bool miss = rfc < 0 || lsc < 0;
    const int slot = keep ? (miss ? 7 : rfc * 2 + lsc) : 6;

    const long long q = qty[i];
    const long long pr = price[i];
    const long long d = disc[i];
    const long long dp = pr * (100 - d);
    const long long ch = dp * (100 + tax[i]);
    const long long v[kSums] = {1, q, pr, d, dp, ch};
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const bool hit = slot == s;
#pragma unroll
      for (int k = 0; k < kSums; ++k) acc[s][k] += hit ? v[k] : 0;
    }
  }

  __shared__ long long block_sums[kSlots * kSums];
  for (int j = threadIdx.x; j < kSlots * kSums; j += blockDim.x) {
    block_sums[j] = 0;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
#pragma unroll
    for (int k = 0; k < kSums; ++k) {
      long long x = acc[s][k];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        x += __shfl_down_sync(0xffffffffu, x, off);
      }
      if (lane == 0 && x != 0) {
        atomicAdd(reinterpret_cast<unsigned long long*>(
                      &block_sums[s * kSums + k]),
                  static_cast<unsigned long long>(x));
      }
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < kSlots * kSums; j += blockDim.x) {
    const long long x = block_sums[j];
    if (x != 0) {
      atomicAdd(reinterpret_cast<unsigned long long*>(out + j),
                static_cast<unsigned long long>(x));
    }
  }
}

}  // namespace

// Columns are device pointers of n rows; out: device int64[8, 6], zeroed
// by the caller. Launches on ``stream`` and returns cudaGetLastError().
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
  const int64_t want = (n + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sms) * 8;
  const int blocks = static_cast<int>(want < cap ? want : cap);
  q1_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(qty), static_cast<const long long*>(price),
      static_cast<const long long*>(disc), static_cast<const long long*>(tax),
      static_cast<const int8_t*>(rf), static_cast<const int8_t*>(ls),
      static_cast<const int32_t*>(ship), n, p, static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}
