// Column -> row byte interleave for Hopper (sm_90a).
//
// Replaces the Pallas kernel spark_rapids_jni_tpu/ops/pallas/
// row_transpose.py (assemble_rows, body _make_kernel): builds the packed
// row image of the reference's RowConversion format — each column's
// little-endian bytes at its static start, one validity byte per 8
// columns after the last column (bit col % 8 of byte col / 8), zero
// alignment gaps and a zero pad to the 8-byte row boundary.
//
// What differs from the TPU kernel:
// - it reads the column storage and the bool validity directly; the
//   TPU path first materialized every column's byte piece, cast to int32,
//   and a packed validity piece;
// - the design is the original CUDA one (row_conversion.cu's
//   copy_from_fixed_width_columns): a block stages 128 rows in shared
//   memory, one thread per row writes that row's fields with typed stores
//   and packs its validity byte(s), then the block copies its tile — a
//   contiguous run of the output — with 16-byte stores.
//
// Rows of up to 1536 bytes (MAX_ROW_SIZE) run that kernel: 128 rows x
// 1536 bytes = 192 KiB of the 227 KiB a block may use. Wider rows take
// one of two more kernels:
// - up to 227 KiB a row: the same staging, with as many rows a block as
//   the 227 KiB hold (a 1,632-byte row: 128; a 65,000-byte row: 3). A
//   thread takes 8 columns of one row (one validity byte), neighbouring
//   threads the same columns of neighbouring rows, so a warp's loads
//   share sectors. A tile no longer starts at a multiple of 16 bytes of
//   the output (65,000-byte rows), so a block copies its tile out with
//   16-byte stores where its start is 16-byte aligned and 8-byte ones
//   where it is not (a row is a multiple of 8 bytes);
// - wider still: no row fits in shared memory, so the threads write
//   each field straight to the output with a typed store, after one
//   memset has zeroed every gap and pad.
//
// Bound on this card: bytes (each column byte read once, each row byte
// written once).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 128;  // rows per block, one thread each
constexpr int kMaxRow = 1536;      // widest row of the 128-row kernel
constexpr int kMaxSmem = 232448;   // opt-in dynamic shared memory, sm_90
constexpr int kWideThreads = 512;  // the wide kernels' block

// One column; the wrapper writes these as int64[ncols, 4] rows.
struct ColDesc {
  const void* data;
  const uint8_t* valid;  // null: every row valid
  int64_t start;         // byte offset in the row, aligned to size
  int64_t size;          // 1, 2, 4, 8 or 16 bytes
};
static_assert(sizeof(ColDesc) == 32, "ColDesc must match the wrapper's int64[4]");

// one field's bytes of row i at dst
__device__ __forceinline__ void put_field(const ColDesc& d, int64_t i,
                                          unsigned char* dst) {
  switch (d.size) {
    case 1:
      *dst = static_cast<const uint8_t*>(d.data)[i];
      break;
    case 2:
      *reinterpret_cast<uint16_t*>(dst) =
          static_cast<const uint16_t*>(d.data)[i];
      break;
    case 4:
      *reinterpret_cast<uint32_t*>(dst) =
          static_cast<const uint32_t*>(d.data)[i];
      break;
    case 8:
      *reinterpret_cast<unsigned long long*>(dst) =
          static_cast<const unsigned long long*>(d.data)[i];
      break;
    default: {  // 16: a DECIMAL128 limb pair; the row base is only
                // 8-aligned, so two 8-byte stores
      const unsigned long long* src =
          static_cast<const unsigned long long*>(d.data) + 2 * i;
      unsigned long long* dst8 = reinterpret_cast<unsigned long long*>(dst);
      dst8[0] = src[0];
      dst8[1] = src[1];
    }
  }
}

// columns [8 * grp, 8 * grp + 8) of row i into the row image at row:
// each field and the group's validity byte
__device__ __forceinline__ void put_group(const ColDesc* __restrict__ cols,
                                          int ncols, int grp, int64_t i,
                                          int vld_base, unsigned char* row) {
  const int c0 = 8 * grp;
  const int c1 = c0 + 8 < ncols ? c0 + 8 : ncols;
  unsigned vbits = 0;
  for (int c = c0; c < c1; ++c) {
    const ColDesc d = cols[c];
    put_field(d, i, row + d.start);
    const bool ok = d.valid == nullptr || d.valid[i] != 0;
    vbits |= (ok ? 1u : 0u) << (c - c0);
  }
  row[vld_base + grp] = static_cast<unsigned char>(vbits);
}

__global__ void __launch_bounds__(kRows)
assemble_rows_kernel(const ColDesc* __restrict__ cols, int ncols, int64_t n,
                     int row_size, int vld_base, uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char tile[];
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kRows;
  const int nr = static_cast<int>(n - r0 < kRows ? n - r0 : kRows);
  const int tile_bytes = nr * row_size;  // row_size is a multiple of 8

  // zero the tile: alignment gaps and the trailing row pad stay zero
  uint2* tile8 = reinterpret_cast<uint2*>(tile);
  for (int j = threadIdx.x; j < tile_bytes / 8; j += blockDim.x) {
    tile8[j] = make_uint2(0u, 0u);
  }
  __syncthreads();

  if (threadIdx.x < nr) {
    const int64_t i = r0 + threadIdx.x;
    unsigned char* row = tile + threadIdx.x * row_size;
    unsigned vbits = 0;
    for (int c = 0; c < ncols; ++c) {
      const ColDesc d = cols[c];
      put_field(d, i, row + d.start);
      const bool ok = d.valid == nullptr || d.valid[i] != 0;
      vbits |= (ok ? 1u : 0u) << (c & 7);
      if ((c & 7) == 7 || c == ncols - 1) {
        row[vld_base + (c >> 3)] = static_cast<unsigned char>(vbits);
        vbits = 0;
      }
    }
  }
  __syncthreads();

  // the tile is a contiguous run of the output (r0 * row_size is a
  // multiple of 1024): 16-byte stores, then an 8-byte tail if any
  uint8_t* dst = out + r0 * row_size;
  const int n16 = tile_bytes / 16;
  for (int j = threadIdx.x; j < n16; j += blockDim.x) {
    reinterpret_cast<uint4*>(dst)[j] = reinterpret_cast<const uint4*>(tile)[j];
  }
  if ((tile_bytes & 15) != 0 && threadIdx.x == 0) {
    const int last = tile_bytes / 8 - 1;
    reinterpret_cast<uint2*>(dst)[last] = tile8[last];
  }
}

// Rows wider than kMaxRow: `rows` rows a block (as many as kMaxSmem
// holds), a thread per 8 columns of a row.
__global__ void __launch_bounds__(kWideThreads)
assemble_wide_kernel(const ColDesc* __restrict__ cols, int ncols, int64_t n,
                     int row_size, int vld_base, int rows,
                     uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char tile[];
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rows;
  const int nr = static_cast<int>(n - r0 < rows ? n - r0 : rows);
  const int tile_bytes = nr * row_size;  // a multiple of 8

  uint2* tile8 = reinterpret_cast<uint2*>(tile);
  for (int j = threadIdx.x; j < tile_bytes / 8; j += blockDim.x) {
    tile8[j] = make_uint2(0u, 0u);
  }
  __syncthreads();

  // item = group * nr + row: neighbouring threads read the same columns
  // of neighbouring rows
  const int groups = (ncols + 7) / 8;
  for (int it = threadIdx.x; it < groups * nr; it += blockDim.x) {
    const int r = it % nr;
    put_group(cols, ncols, it / nr, r0 + r, vld_base, tile + r * row_size);
  }
  __syncthreads();

  uint8_t* dst = out + r0 * row_size;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    const int n16 = tile_bytes / 16;
    for (int j = threadIdx.x; j < n16; j += blockDim.x) {
      reinterpret_cast<uint4*>(dst)[j] =
          reinterpret_cast<const uint4*>(tile)[j];
    }
    if ((tile_bytes & 15) != 0 && threadIdx.x == 0) {
      const int last = tile_bytes / 8 - 1;
      reinterpret_cast<uint2*>(dst)[last] = tile8[last];
    }
  } else {
    for (int j = threadIdx.x; j < tile_bytes / 8; j += blockDim.x) {
      reinterpret_cast<uint2*>(dst)[j] = tile8[j];
    }
  }
}

// Rows wider than kMaxSmem: each (row, 8 columns) item straight to the
// output, already zeroed; items = group * n + row as above.
__global__ void __launch_bounds__(kWideThreads)
assemble_direct_kernel(const ColDesc* __restrict__ cols, int ncols,
                       int64_t n, int64_t row_size, int vld_base,
                       uint8_t* __restrict__ out) {
  const int64_t items = static_cast<int64_t>((ncols + 7) / 8) * n;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t it = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
       it < items; it += stride) {
    const int64_t i = it % n;
    put_group(cols, ncols, static_cast<int>(it / n), i, vld_base,
              out + i * row_size);
  }
}

}  // namespace

// cols: device int64[ncols, 4] (see ColDesc); out: device uint8[n, row_size],
// 16-byte aligned; row_size a multiple of 8. Rows of up to kMaxRow bytes
// take the 128-row kernel, rows of up to kMaxSmem the wide one, wider
// rows the direct one. Launches on ``stream`` and returns the first CUDA
// error.
extern "C" int srjt_assemble_rows(const void* cols, int32_t ncols, int64_t n,
                                  int64_t row_size, int32_t vld_base,
                                  void* out, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const ColDesc* c = static_cast<const ColDesc*>(cols);
  uint8_t* o = static_cast<uint8_t*>(out);
  if (row_size > kMaxSmem) {
    const cudaError_t err = cudaMemsetAsync(out, 0, n * row_size, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int64_t items = static_cast<int64_t>((ncols + 7) / 8) * n;
    const int64_t want = (items + kWideThreads - 1) / kWideThreads;
    const unsigned blocks = static_cast<unsigned>(want < 65536 ? want : 65536);
    assemble_direct_kernel<<<blocks, kWideThreads, 0, s>>>(
        c, ncols, n, row_size, vld_base, o);
    return static_cast<int>(cudaGetLastError());
  }
  const int size = static_cast<int>(row_size);
  const bool wide = size > kMaxRow;
  const int rows = wide ? (kMaxSmem / size < kRows ? kMaxSmem / size : kRows)
                        : kRows;
  const size_t smem = static_cast<size_t>(rows) * size;
  const void* kernel = wide ? reinterpret_cast<const void*>(assemble_wide_kernel)
                            : reinterpret_cast<const void*>(assemble_rows_kernel);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t blocks = (n + rows - 1) / rows;
  if (wide) {
    assemble_wide_kernel<<<static_cast<unsigned>(blocks), kWideThreads, smem,
                           s>>>(c, ncols, n, size, vld_base, rows, o);
  } else {
    assemble_rows_kernel<<<static_cast<unsigned>(blocks), kRows, smem, s>>>(
        c, ncols, n, size, vld_base, o);
  }
  return static_cast<int>(cudaGetLastError());
}
