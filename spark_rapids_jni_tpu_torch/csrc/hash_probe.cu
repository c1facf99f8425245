// Join probe for Hopper (sm_90a).
//
// Replaces the Pallas kernel spark_rapids_jni_tpu/ops/pallas/hash_probe.py
// (probe_lo_hi, body _probe_kernel): for every probe key p over the sorted,
// sentinel-padded build keys, lo = #(build < p) and hi = #(build <= p), which
// are searchsorted's left and right insertion points.
//
// What differs from the TPU kernel: the TPU kernel streamed every build key
// from SMEM past each probe tile (O(build) compares per probe), so it capped
// the build at 2048 int32 keys and fell back above that (build_too_large) or
// for wider keys (key_width). Here the build stays in device memory and is
// searched through a small index, with no cap and no fallback. One template
// serves int32 keys (rank-encoded joins) and int64 keys (every other integer
// key; the wrapper maps uint64 by a sign-bit flip).
//
// What bounds it on this card. At TPC-H q3's joins most of the build is the
// null sentinel (the key type's max): at SF10, join 2's build is 15,000,000
// slots of which about 0.94M hold keys, and join 1's 1,500,000 of which
// about 0.3M do. The searched part (7.5 MB and 2.4 MB) lives in the 50 MB
// L2, so a probe is bound by L2 and L1 traffic and by the latency of its
// dependent loads, not by HBM. The first design, a bisection of [0, m) per
// probe key, made ~24 dependent 8-byte reads at scattered addresses, each
// moving a 32-byte sector.
//
// The design, three launches on one stream:
// 1. sentinel_start: one block finds s = #(build < max) by a 1024-way
//    search (3-4 rounds of one read per thread). Keys at [s, m) all equal
//    the max, so a probe p < max has lo, hi <= s, and p == max has lo = s,
//    hi = m. Only [0, s) is indexed.
// 2. build_levels: an implicit index over [0, s) whose lines are one
//    32-byte L2 sector: F = 4 int64 or 8 int32 keys (the fanout). Level k
//    holds c_k = ceil(s / F^k) keys, L_k[j] = build[min(F^k (j+1) - 1,
//    s - 1)] (the last key of each F^k block), padded with the max to a
//    whole line. Levels go up until one holds at most kTopKeys keys: that
//    is the top, level t (t = 0 when s <= kTopKeys). Every level is a
//    strided gather from the build, so all are written in one grid.
// 3. probe: each block copies the top level into shared memory (16,384
//    keys, 128 KB for int64: one 1024-thread block per SM). A probe
//    bisects the top there, then reads one line per lower level and
//    counts its keys below p: j <- F j + #(line < p). The bottom line is
//    the build's own, and the same read gives #(line <= p), so hi costs
//    nothing unless the whole line is <= p (a duplicate run that crosses
//    the line); then it gallops from the line's end (reads at +0, +2, +5,
//    ..., the step doubling) and bisects the last step.
// The warp reads its 32 probes' lines together (warp_scan_lines): two
// lanes read a line with one 16-byte load each, 16 lines per instruction,
// and ballots count the keys for the probe that owns each line. At q3's
// join 2 (s ~ 0.94M) the top is level 3 (~14.7K keys) and a probe reads
// three sectors from L2.
// Measured on the H100 (PERF.md): each thread reading its own 128-byte
// line with eight 16-byte loads was no faster than the bisection, since a
// warp instruction then touched 32 lines and the L1 takes one cycle per
// line; 128-byte lines read by the warp together halved the time; sector
// lines and the 16K-key top (one global level fewer) took off another
// third. What remains is the top's bisection in shared memory (14
// dependent steps, bank conflicts once the warp's probes spread) and the
// three dependent sector reads.
// The index lives in a scratch buffer the wrapper allocates, sized for
// s = m since s is known only on the device: under a third of the build's
// bytes for int64 keys (sum of 4^-k), a seventh for int32.
// ptxas (-Xptxas -v, build.log), both key types: probe_kernel 32 registers,
// 128 KB (int64) or 64 KB (int32) of dynamic shared memory plus 128 bytes
// static, and a 256-byte stack frame for the level sizes, read only while
// the block sets up; build_levels_kernel 40 registers and the same frame;
// sentinel_start_kernel 22 registers. No spills.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLineBytes = 32;      // bytes per index line: one L2 sector
constexpr int64_t kTopKeys = 16384; // keys of the top level in shared memory
constexpr int kMaxLevels = 16;     // 16^15 > 2^59 keys: never reached
constexpr int64_t kHeader = 128;   // bytes before level 1: s as int64
constexpr int kThreads = 256;       // threads of the index-building blocks
constexpr int kProbeThreads = 1024; // one probe block per SM: 128 KB top
constexpr unsigned kFull = 0xFFFFFFFFu;

template <typename K> __host__ __device__ constexpr K key_max();
template <> __host__ __device__ constexpr int32_t key_max<int32_t>() {
  return INT32_MAX;
}
template <> __host__ __device__ constexpr long long key_max<long long>() {
  return INT64_MAX;
}

__host__ __device__ inline int64_t ceil_div(int64_t a, int64_t b) {
  return (a + b - 1) / b;
}

// keys per line, the index's fanout: 4 int64 or 8 int32 keys
template <typename K> constexpr int kLine = kLineBytes / sizeof(K);

// Level sizes c_0 = s, c_{k+1} = ceil(c_k / line), up to the first level
// of at most kTopKeys keys; returns that top level t.
__host__ __device__ inline int level_sizes(int64_t s, int line,
                                           int64_t (&size)[kMaxLevels]) {
  int t = 0;
  size[0] = s;
  while (size[t] > kTopKeys && t + 1 < kMaxLevels) {
    size[t + 1] = ceil_div(size[t], line);
    ++t;
  }
  return t;
}

// Byte offset of level k >= 1 in the index buffer. Each level has room for
// the largest s (= m) rounded up to whole lines, and starts on a 128-byte
// boundary, so every line is aligned.
__host__ __device__ inline int64_t level_offset(int64_t m, int key_bytes,
                                                int k) {
  const int line = kLineBytes / key_bytes;
  int64_t size[kMaxLevels];
  level_sizes(m, line, size);
  int64_t off = kHeader;
  for (int i = 1; i < k; ++i) {
    off += ceil_div(ceil_div(size[i], line) * kLineBytes, 128) * 128;
  }
  return off;
}

template <typename K>
__global__ void __launch_bounds__(1024)
sentinel_start_kernel(const K* __restrict__ build, int64_t m,
                      int64_t* __restrict__ header) {
  // the answer lies in [lo, hi]; every thread reads one evenly spaced key
  // a round, and the count below the max narrows the range to one step
  int64_t lo = 0;
  int64_t hi = m;
  while (lo < hi) {
    const int64_t step = ceil_div(hi - lo, blockDim.x);
    const int64_t idx = lo + static_cast<int64_t>(threadIdx.x) * step;
    const int below = __syncthreads_count(idx < hi &&
                                          build[idx] < key_max<K>());
    const int64_t new_lo = below > 0 ? lo + (below - 1) * step + 1 : lo;
    const int64_t cut = lo + static_cast<int64_t>(below) * step;
    hi = cut < hi ? cut : hi;
    lo = new_lo;
  }
  if (threadIdx.x == 0) *header = lo;
}

template <typename K>
__global__ void __launch_bounds__(kThreads)
build_levels_kernel(const K* __restrict__ build, int64_t m,
                    unsigned char* __restrict__ index) {
  constexpr int line = kLine<K>;
  const int64_t s = *reinterpret_cast<const int64_t*>(index);
  int64_t size[kMaxLevels];
  const int t = level_sizes(s, line, size);
  int64_t total = 0;
  for (int k = 1; k <= t; ++k) total += ceil_div(size[k], line) * line;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       e < total; e += stride) {
    int k = 1;
    int64_t j = e;
    int64_t span = line;  // line^k build keys under each level-k key
    while (j >= ceil_div(size[k], line) * line) {
      j -= ceil_div(size[k], line) * line;
      ++k;
      span *= line;
    }
    K* level = reinterpret_cast<K*>(index +
                                    level_offset(m, sizeof(K), k));
    if (j < size[k]) {
      const int64_t last = (j + 1) * span - 1;
      level[j] = build[last < s - 1 ? last : s - 1];
    } else {
      level[j] = key_max<K>();
    }
  }
}

// Geometry of the warp's cooperative line reads: a line is read by
// kLanesPerLine lanes with one 16-byte load each, kLinesPerStep lines per
// warp instruction, so the 32 probes of a warp take kSteps instructions a
// level (32-byte lines: 2 lanes a line, 16 lines a step, 2 steps).
template <typename K>
struct Lines {
  static constexpr int kKeysPerLane = 16 / sizeof(K);
  static constexpr int kLanesPerLine = kLine<K> / kKeysPerLane;
  static constexpr int kLinesPerStep = 32 / kLanesPerLine;
  static constexpr int kSteps = 32 / kLinesPerStep;
};

__device__ __forceinline__ void load16(const long long* src,
                                       long long (&v)[2]) {
  const longlong2 x = __ldg(reinterpret_cast<const longlong2*>(src));
  v[0] = x.x;
  v[1] = x.y;
}

__device__ __forceinline__ void load16(const int32_t* src, int32_t (&v)[4]) {
  const int4 x = __ldg(reinterpret_cast<const int4*>(src));
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}

// Every lane of the warp holds a probe p and the index j of the line of
// ``level`` it descends to (j < 0: no line). The warp reads the 32 lines
// together: in step ``it`` the lanes of team g read, 16 bytes each, the
// line of the probe in lane it * kLinesPerStep + g and compare its keys
// with that probe's key, and ballots give each owner its counts. So a warp
// instruction touches kLinesPerStep whole lines, not 32 scattered ones.
// Keys at or past ``limit`` count as the max. Returns this lane's
// #(line < p) in lt and, with kBoth, #(line <= p) in le.
template <typename K, bool kBoth>
__device__ __forceinline__ void warp_scan_lines(const K* __restrict__ level,
                                                int64_t limit, int64_t j, K p,
                                                int& lt, int& le) {
  using L = Lines<K>;
  const int lane = threadIdx.x & 31;
  const int team = lane / L::kLanesPerLine;
  const int part = lane % L::kLanesPerLine;
  const int my_step = lane / L::kLinesPerStep;
  const unsigned my_team = ((1u << L::kLanesPerLine) - 1u)
                           << ((lane % L::kLinesPerStep) * L::kLanesPerLine);
  lt = 0;
  le = 0;
#pragma unroll
  for (int it = 0; it < L::kSteps; ++it) {
    const int owner = it * L::kLinesPerStep + team;
    const int64_t oj = __shfl_sync(kFull, j, owner);
    const K op = __shfl_sync(kFull, p, owner);
    const int64_t first = oj * kLine<K> + part * L::kKeysPerLane;
    K key[L::kKeysPerLane];
    if (oj >= 0 && first + L::kKeysPerLane <= limit) {
      load16(level + first, key);
    } else {
#pragma unroll
      for (int q = 0; q < L::kKeysPerLane; ++q) {
        key[q] = (oj >= 0 && first + q < limit) ? level[first + q]
                                                : key_max<K>();
      }
    }
    int n_lt = 0;
    int n_le = 0;
#pragma unroll
    for (int q = 0; q < L::kKeysPerLane; ++q) {
      n_lt += __popc(__ballot_sync(kFull, key[q] < op) & my_team);
      if (kBoth) n_le += __popc(__ballot_sync(kFull, key[q] <= op) & my_team);
    }
    if (it == my_step) {
      lt = n_lt;
      le = n_le;
    }
  }
}

// first index in [a, b) of the shared-memory keys not below p (strict:
// above p), else b
template <typename K>
__device__ __forceinline__ int bisect(const K* keys, int a, int b, K p,
                                      bool strict) {
  while (a < b) {
    const int mid = (a + b) >> 1;
    const K k = keys[mid];
    if (strict ? k <= p : k < p) {
      a = mid + 1;
    } else {
      b = mid;
    }
  }
  return a;
}

// first index in [from, s) whose key is above p, given build[from - 1] <= p:
// gallop (from, from+2, from+5, ..., the step doubling), then bisect
template <typename K>
__device__ int64_t gallop_above(const K* __restrict__ build, int64_t s,
                                int64_t from, K p) {
  int64_t a = from;
  int64_t h = from;
  int64_t step = 1;
  while (h < s && build[h] <= p) {
    a = h + 1;
    h = a + step;
    step <<= 1;
  }
  if (h > s) h = s;
  while (a < h) {
    const int64_t mid = a + ((h - a) >> 1);
    if (build[mid] <= p) {
      a = mid + 1;
    } else {
      h = mid;
    }
  }
  return a;
}

template <typename K>
__global__ void __launch_bounds__(kProbeThreads)
probe_kernel(const K* __restrict__ build, int64_t m,
             const unsigned char* __restrict__ index,
             const K* __restrict__ probe, int64_t n,
             long long* __restrict__ lo_out, long long* __restrict__ hi_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  K* top = reinterpret_cast<K*>(smem);
  __shared__ const K* level_s[kMaxLevels];

  const int64_t s = *reinterpret_cast<const int64_t*>(index);
  int64_t size[kMaxLevels];
  // the same for every thread; the warp reduction tells the compiler so,
  // and the level loop around the warp's collective line reads is then
  // known to be convergent (no WARPSYNC.COLLECTIVE fallback in the SASS)
  const int t = __reduce_max_sync(kFull, level_sizes(s, kLine<K>, size));
  const int tid = static_cast<int>(threadIdx.x);
  if (tid <= t) {
    level_s[tid] = tid == 0 ? build
                            : reinterpret_cast<const K*>(
                                  index + level_offset(m, sizeof(K), tid));
  }
  __syncthreads();
  const int ct = static_cast<int>(size[t]);
  const K* top_src = level_s[t];
  for (int i = threadIdx.x; i < ct; i += blockDim.x) top[i] = top_src[i];
  __syncthreads();

  // a block takes 256 consecutive probes at a time: the loop bound and
  // the level count are uniform, so every lane joins each line read
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kProbeThreads;
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kProbeThreads;
       base < n; base += stride) {
    const int64_t i = base + tid;
    const bool in = i < n;
    const K p = in ? probe[i] : key_max<K>();
    int64_t lo = s;  // p == max: the sentinel tail and any key at the max
    int64_t hi = m;
    int64_t j = -1;  // the line this probe descends to, once found
    if (p != key_max<K>()) {
      if (t == 0) {  // the whole of [0, s) is in shared memory
        lo = bisect(top, 0, ct, p, false);
        hi = bisect(top, static_cast<int>(lo), ct, p, true);
      } else {
        j = bisect(top, 0, ct, p, false);
        if (j == ct) {  // every key of [0, s) is below p
          lo = s;
          hi = s;
          j = -1;
        }
      }
    }
    int lt;
    int le;
    for (int k = t - 1; k >= 1; --k) {
      warp_scan_lines<K, false>(level_s[k], INT64_MAX, j, p, lt, le);
      if (j >= 0) j = j * kLine<K> + lt;
    }
    if (t >= 1) {
      warp_scan_lines<K, true>(build, m, j, p, lt, le);
      if (j >= 0) {
        const int64_t b = j * kLine<K>;
        lo = b + lt;
        hi = le == kLine<K> ? gallop_above(build, s, b + kLine<K>, p)
                            : b + le;
      }
    }
    if (in) {
      lo_out[i] = lo;
      hi_out[i] = hi;
    }
  }
}

template <typename K>
int launch(const K* build, int64_t m, const K* probe, int64_t n,
           unsigned char* index, long long* lo, long long* hi, int sms,
           cudaStream_t stream) {
  sentinel_start_kernel<K><<<1, 1024, 0, stream>>>(
      build, m, reinterpret_cast<int64_t*>(index));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  constexpr int line = kLine<K>;
  int64_t size[kMaxLevels];
  const int levels = level_sizes(m, line, size);  // the most any s <= m needs
  int64_t most = 0;
  for (int k = 1; k <= levels; ++k) most += ceil_div(size[k], line) * line;
  if (most > 0) {
    const int64_t cap = static_cast<int64_t>(sms) * 8;
    const int64_t want = ceil_div(most, kThreads);
    build_levels_kernel<K><<<static_cast<int>(want < cap ? want : cap),
                             kThreads, 0, stream>>>(build, m, index);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }

  const size_t smem = static_cast<size_t>(kTopKeys) * sizeof(K);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(probe_kernel<K>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, probe_kernel<K>, kProbeThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) per_sm = 1;
  const int64_t cap = static_cast<int64_t>(sms) * per_sm;
  const int64_t want = ceil_div(n, kProbeThreads);
  probe_kernel<K><<<static_cast<int>(want < cap ? want : cap), kProbeThreads,
                    smem, stream>>>(build, m, index, probe, n, lo, hi);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bytes of the index scratch buffer for a build of m keys of key_bits
// (32 or 64) bits: a 128-byte header, then levels 1.. for the largest s.
extern "C" int64_t srjt_hash_probe_index_bytes(int64_t m, int32_t key_bits) {
  int64_t size[kMaxLevels];
  const int levels = level_sizes(m, kLineBytes * 8 / key_bits, size);
  return level_offset(m, key_bits / 8, levels + 1);
}

// build: device K[m], sorted ascending; probe: device K[n]; key_bits: 32 or
// 64 (K = int32_t or int64_t); index: device scratch of
// srjt_hash_probe_index_bytes(m, key_bits) bytes, 128-byte aligned (build
// 16-byte aligned); lo, hi: device int64[n]. Launches on ``stream`` and
// returns the first CUDA error of its three launches.
extern "C" int srjt_hash_probe(const void* build, int64_t m, const void* probe,
                               int64_t n, int32_t key_bits, void* index,
                               void* lo, void* hi, int32_t sms,
                               void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned char* idx = static_cast<unsigned char*>(index);
  long long* lo_p = static_cast<long long*>(lo);
  long long* hi_p = static_cast<long long*>(hi);
  if (key_bits == 32) {
    return launch(static_cast<const int32_t*>(build), m,
                  static_cast<const int32_t*>(probe), n, idx, lo_p, hi_p,
                  sms, s);
  }
  if (key_bits == 64) {
    return launch(static_cast<const long long*>(build), m,
                  static_cast<const long long*>(probe), n, idx, lo_p, hi_p,
                  sms, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
