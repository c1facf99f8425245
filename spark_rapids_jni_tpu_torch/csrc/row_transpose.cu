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
// The row cap follows from the staging: 128 rows x 1536 bytes = 192 KiB
// of the 227 KiB a block may use, so rows up to MAX_ROW_SIZE (1536) run
// here; the wrapper refuses wider ones (reason row_too_wide) by raising.
//
// Bound on this card: bytes (each column byte read once, each row byte
// written once).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 128;  // rows per block, one thread each

// One column; the wrapper writes these as int64[ncols, 4] rows.
struct ColDesc {
  const void* data;
  const uint8_t* valid;  // null: every row valid
  int64_t start;         // byte offset in the row, aligned to size
  int64_t size;          // 1, 2, 4, 8 or 16 bytes
};
static_assert(sizeof(ColDesc) == 32, "ColDesc must match the wrapper's int64[4]");

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
      unsigned char* dst = row + d.start;
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
                    // 8-aligned in the tile, so two 8-byte stores
          const unsigned long long* src =
              static_cast<const unsigned long long*>(d.data) + 2 * i;
          unsigned long long* dst8 = reinterpret_cast<unsigned long long*>(dst);
          dst8[0] = src[0];
          dst8[1] = src[1];
        }
      }
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

}  // namespace

// cols: device int64[ncols, 4] (see ColDesc); out: device uint8[n, row_size],
// 16-byte aligned. Launches on ``stream`` and returns cudaGetLastError().
extern "C" int srjt_assemble_rows(const void* cols, int32_t ncols, int64_t n,
                                  int32_t row_size, int32_t vld_base,
                                  void* out, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const size_t smem = static_cast<size_t>(kRows) * row_size;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        assemble_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t blocks = (n + kRows - 1) / kRows;
  assemble_rows_kernel<<<static_cast<unsigned>(blocks), kRows, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const ColDesc*>(cols), ncols, n, row_size, vld_base,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
