// Join probe for Hopper (sm_90a).
//
// Replaces the Pallas kernel spark_rapids_jni_tpu/ops/pallas/hash_probe.py
// (probe_lo_hi, body _probe_kernel): for every probe key p over the sorted,
// sentinel-padded build keys, lo = #(build < p) and hi = #(build <= p), which
// are searchsorted's left and right insertion points.
//
// What differs from the TPU kernel:
// - The TPU kernel streamed every build key from SMEM past each probe tile
//   (O(build) compares per probe), so it capped the build at 2048 int32
//   keys and fell back above that (build_too_large) or for wider keys
//   (key_width). Here the build stays in device memory and one thread per
//   probe key runs two searches over it: a binary search for the lower
//   bound over [0, m), then a galloping search for the upper bound over
//   [lo, m): probe lo, lo+2, lo+5, ... (the step doubling) until a key
//   above p or the end, then bisect the last step. No cap, no fallback.
// - Why gallop: bisecting [lo, m) starts at (lo + m) / 2, an address that
//   differs for every probe, so each of its ~log2(m) steps misses the
//   cache (measured: twice the time of the searchsorted pair). Galloping
//   starts at lo, where the first search just ended: a probe with no
//   match reads one key, a unique match three, all on the same line.
// - One template serves int32 keys (rank-encoded joins) and int64 keys
//   (every other integer key; the wrapper maps uint64 by a sign-bit flip).
// - 64-bit indices throughout, a grid-stride loop over the probes.
//
// Bound on this card: bytes in the ideal, latency in practice. The least
// traffic is reading each probe key and the build once and writing lo and
// hi (about 1.56 GB for TPC-H q3's second join at SF10: 60M int64 probes,
// 15M int64 build keys). But each step of the lower-bound search is a
// dependent load at a data-dependent address: the top levels of the
// search tree stay in the 50 MB L2, the last levels of a 120 MB build miss
// on almost every probe, and nothing overlaps one step with the next
// within a thread. Expect several times the byte bound. Sorting or
// bucketing the probes, or staging the upper tree in shared memory, are
// left for later.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <typename K>
__global__ void __launch_bounds__(256)
probe_kernel(const K* __restrict__ build, int64_t m,
             const K* __restrict__ probe, int64_t n,
             long long* __restrict__ lo_out, long long* __restrict__ hi_out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    const K p = probe[i];
    int64_t lo = 0;
    int64_t hi = m;
    while (lo < hi) {  // first index whose key is not below p
      const int64_t mid = lo + ((hi - lo) >> 1);
      if (build[mid] < p) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    lo_out[i] = lo;
    // first index in [lo, m) whose key is above p: gallop, then bisect;
    // the keys the gallop passes (up to its new lo) are all <= p
    int64_t step = 1;
    hi = lo;
    while (hi < m && build[hi] <= p) {
      lo = hi + 1;
      hi = lo + step;
      step <<= 1;
    }
    if (hi > m) hi = m;
    while (lo < hi) {
      const int64_t mid = lo + ((hi - lo) >> 1);
      if (build[mid] <= p) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    hi_out[i] = lo;
  }
}

}  // namespace

// build: device K[m], sorted ascending; probe: device K[n]; key_bits: 32 or
// 64 (K = int32_t or int64_t); lo, hi: device int64[n]. Launches on
// ``stream`` and returns cudaGetLastError().
extern "C" int srjt_hash_probe(const void* build, int64_t m, const void* probe,
                               int64_t n, int32_t key_bits, void* lo, void* hi,
                               int32_t sms, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (key_bits != 32 && key_bits != 64) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int kThreads = 256;
  const int64_t want = (n + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sms) * 16;
  const int blocks = static_cast<int>(want < cap ? want : cap);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (key_bits == 32) {
    probe_kernel<int32_t><<<blocks, kThreads, 0, s>>>(
        static_cast<const int32_t*>(build), m,
        static_cast<const int32_t*>(probe), n, static_cast<long long*>(lo),
        static_cast<long long*>(hi));
  } else {
    probe_kernel<long long><<<blocks, kThreads, 0, s>>>(
        static_cast<const long long*>(build), m,
        static_cast<const long long*>(probe), n, static_cast<long long*>(lo),
        static_cast<long long*>(hi));
  }
  return static_cast<int>(cudaGetLastError());
}
