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
//   version's.
// - Each lane is a descriptor (values pointer or null for the constant 1,
//   validity pointer or null for "all valid", element kind, op, neutral),
//   and the kernel applies the validity itself: no masked copy of a
//   column is materialized.
// - The TPU grid ran its blocks in order and carried nothing across them;
//   here a grid-stride loop feeds per-block partials in shared memory
//   (m*L int64, at most 2048 entries = 16 KB), which are folded into the
//   output with one global atomic per (group, lane) per block.
//
// Bound on this card: bytes. Each row reads its group id and each lane's
// value and validity bytes once; the shared-memory atomics are the likely
// limit instead, because a query such as TPC-H q1 has only a handful of
// live groups, so the 32 threads of a warp mostly hit the same few
// addresses. That contention is measured, not designed away, here.

#include <cstdint>
#include <cuda_runtime.h>

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

__device__ __forceinline__ long long load_value(const Lane& lane, int64_t i) {
  switch (lane.kind) {
    case kI8: return static_cast<const int8_t*>(lane.values)[i];
    case kI16: return static_cast<const int16_t*>(lane.values)[i];
    case kI32: return static_cast<const int32_t*>(lane.values)[i];
    case kI64: return static_cast<const long long*>(lane.values)[i];
    case kU8: return static_cast<const uint8_t*>(lane.values)[i];
    case kU16: return static_cast<const uint16_t*>(lane.values)[i];
    case kU32: return static_cast<const uint32_t*>(lane.values)[i];
    case kU64:
      return static_cast<long long>(
          static_cast<const unsigned long long*>(lane.values)[i]);
    default: return 1;
  }
}

__device__ __forceinline__ void fold(long long* slot, int64_t op,
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

__global__ void __launch_bounds__(256)
accumulate_kernel(const int32_t* __restrict__ gid, int64_t n,
                  const Lane* __restrict__ lanes, int num_lanes, int m,
                  long long* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  Lane* lane_s = reinterpret_cast<Lane*>(smem);
  long long* part = reinterpret_cast<long long*>(
      smem + static_cast<size_t>(num_lanes) * sizeof(Lane));
  const int cells = m * num_lanes;

  for (int j = threadIdx.x; j < num_lanes; j += blockDim.x) {
    lane_s[j] = lanes[j];
  }
  __syncthreads();
  for (int j = threadIdx.x; j < cells; j += blockDim.x) {
    part[j] = lane_s[j % num_lanes].neutral;
  }
  __syncthreads();

  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    const int g = gid[i];
    if (g < 0 || g >= m) continue;  // m: the row joins no group
    long long* row = part + static_cast<int64_t>(g) * num_lanes;
    for (int l = 0; l < num_lanes; ++l) {
      const Lane& lane = lane_s[l];
      if (lane.valid != nullptr && lane.valid[i] == 0) continue;
      const long long v = load_value(lane, i);
      if (lane.op == kSum && v == 0) continue;
      fold(row + l, lane.op, v);
    }
  }
  __syncthreads();

  // the output starts at each lane's neutral, so a partial that is still
  // neutral has nothing to add
  for (int j = threadIdx.x; j < cells; j += blockDim.x) {
    const Lane& lane = lane_s[j % num_lanes];
    const long long v = part[j];
    if (v != lane.neutral) fold(out + j, lane.op, v);
  }
}

}  // namespace

// gid: int32[n]; lanes: device int64[num_lanes, 5] (see Lane); out: device
// int64[m, num_lanes], filled by the caller with each lane's neutral.
// Launches on ``stream`` and returns cudaGetLastError().
extern "C" int srjt_groupby_accumulate(const void* gid, int64_t n,
                                       const void* lanes, int32_t num_lanes,
                                       int32_t m, void* out, int32_t sms,
                                       void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const size_t smem = static_cast<size_t>(num_lanes) * sizeof(Lane) +
                      static_cast<size_t>(m) * num_lanes * sizeof(long long);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        accumulate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  constexpr int kThreads = 256;
  const int64_t want = (n + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sms) * 8;
  const int blocks = static_cast<int>(want < cap ? want : cap);
  accumulate_kernel<<<blocks, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(gid), n, static_cast<const Lane*>(lanes),
      num_lanes, m, static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}
