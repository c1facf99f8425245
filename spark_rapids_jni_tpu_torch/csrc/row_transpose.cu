// Column -> row byte interleave for Hopper (sm_90a).
//
// Replaces the Pallas kernel spark_rapids_jni_tpu/ops/pallas/
// row_transpose.py (assemble_rows, body _make_kernel): builds the packed
// row image of the reference's RowConversion format — each column's
// little-endian bytes at its static start, one validity byte per 8
// columns after the last column (bit col % 8 of byte col / 8), zero
// alignment gaps and a zero pad to the 8-byte row boundary.
//
// What differs from the TPU kernel: it reads the column storage and the
// bool validity directly; the TPU path first materialized every column's
// byte piece, cast to int32, and a packed validity piece.
//
// Bound on this card: bytes (each column byte and validity bool read
// once, each row byte written once). Two kernels:
//
// - assemble_rows_kernel, rows of up to 1536 bytes (MAX_ROW_SIZE): the
//   original CUDA design (row_conversion.cu's
//   copy_from_fixed_width_columns). A block stages 128 rows in shared
//   memory (192 KiB at 1536 bytes), one thread per row writes that row's
//   fields with typed stores and packs its validity byte(s), then the
//   block copies its tile, a contiguous run of the output, with 16-byte
//   stores. 0.77 of the byte bound on SF10 lineitem (on an NVIDIA H100
//   80GB HBM3 at 700.00 W, as every time below).
//
// - assemble_tiled_kernel, any wider row. Staging whole rows held the
//   earlier wide design at 0.24 and 0.018 of the bound at 1,632- and
//   65,000-byte rows: 128 such rows fill 204 KB (one block a SM, its
//   zero, gather and copy-out phases serialised), a thread kept about
//   one 8-byte load in flight (a load, then its store to shared memory),
//   every (row, column) item read its 32-byte descriptor from global
//   memory, and at 65,000 bytes each of the 6,667 blocks of 3 rows
//   walked all 8,000 descriptors. Past 227 KB a row it zeroed the whole
//   output first. So a block now takes TILE_ROWS (32) rows of one
//   segment of the row image, laid out by row_transpose.tile_plan: data
//   segments of whole 16-byte blocks of the data area, validity segments
//   of 8-byte words after it (the validity bytes, the pad and any field
//   that ends in the first of those words), each block within 48 KB of
//   shared memory so that four share a SM and one's loads overlap
//   another's stores. A block
//   1. reads its segment's descriptors into shared memory, once;
//   2. stages each of its columns' 32 values (contiguous in the column)
//      and each validity column's 32 bools with cp.async, 16 bytes a
//      copy where the source and length allow it, else 8 or 4, else
//      element copies: all of a tile's loads in flight together, a warp
//      a column;
//   3. packs the tile's validity bytes;
//   4. assembles each 8-byte word of its row segments from the staged
//      fields (each staged at the bank of its 16-byte block of the row,
//      so a warp's lanes read distinct banks), found through one packed
//      int32 descriptor a word (lanes reading the 32-byte column
//      descriptors instead were 16-way bank conflicts: 4.98 ms against
//      3.25-3.30 at 1,632-byte rows), and writes it: two words a 16-byte
//      store where the output address allows, else one 8-byte store (a
//      row is a multiple of 8 bytes).
//   Every output byte is written once, by one word's store: no memset.
//   0.62-0.65 of the byte bound at 1,632- and 65,000-byte rows.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 128;  // rows per block, one thread each
constexpr int kMaxRow = 1536;      // widest row of the 128-row kernel
constexpr int kTileThreads = 256;  // the tiled kernel's block
constexpr int kTileWarps = kTileThreads / 32;

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

// ---- the tiled kernel --------------------------------------------------------

// One column of the tiled kernel; the wrapper writes these as int32[8].
struct TileCol {
  const void* data;
  const uint8_t* valid;  // null: every row valid
  int32_t start, size;   // byte offset in the row (aligned to size), bytes
  int32_t data_off;      // its staged rows in its data segment's block
  int32_t valid_off;     // its staged bools in its validity segment's block
};
static_assert(sizeof(TileCol) == 32, "TileCol must match the wrapper's int32[8]");

// One segment of the row image; int32[8] after the columns.
struct Segment {
  int32_t word_begin, word_end;  // row bytes [8 * word_begin, 8 * word_end)
  int32_t c0, c1;                // the columns whose fields lie in it
  int32_t v0, v1;                // its validity bytes (columns 8 v0 ..)
  int32_t packed_off;            // the tile's packed validity bytes
  int32_t info_off;              // TileCol[c1 - c0], ValidCol[], words
};
static_assert(sizeof(Segment) == 32, "Segment must match the wrapper's int32[8]");

struct ValidCol {
  const uint8_t* valid;
  int32_t off, unused;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// bytes [src, src + bytes) to dst (16-byte aligned) by one warp's lanes
__device__ __forceinline__ void stage(unsigned char* dst,
                                      const unsigned char* src, int bytes,
                                      int lane) {
  const unsigned a = static_cast<unsigned>(reinterpret_cast<uintptr_t>(src)) |
                     static_cast<unsigned>(bytes);
  if ((a & 15) == 0) {
    for (int i = 16 * lane; i < bytes; i += 16 * 32) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       smem_addr(dst + i)), "l"(src + i));
    }
  } else if ((a & 7) == 0) {
    for (int i = 8 * lane; i < bytes; i += 8 * 32) {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                       smem_addr(dst + i)), "l"(src + i));
    }
  } else if ((a & 3) == 0) {
    for (int i = 4 * lane; i < bytes; i += 4 * 32) {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                       smem_addr(dst + i)), "l"(src + i));
    }
  } else if ((a & 1) == 0) {  // 1- and 2-byte columns off 4 bytes
    for (int i = 2 * lane; i < bytes; i += 2 * 32) {
      *reinterpret_cast<uint16_t*>(dst + i) =
          *reinterpret_cast<const uint16_t*>(src + i);
    }
  } else {
    for (int i = lane; i < bytes; i += 32) dst[i] = src[i];
  }
}

// A word's descriptor (int32, one a word of the segment, so a warp's
// lanes read neighbouring ones): kind in bits 0-1, then
// - kOneField: the shared-memory offset of the 8-byte field that fills
//   the word (row r at + 8 r);
// - kHalfField: that of the half of a 16-byte field in it (+ 16 r);
// - kGeneral: the first column that starts in it (nc: none), the
//   fields walked from there, then its validity bytes.
constexpr int kOneField = 0, kHalfField = 1, kGeneral = 2;

// The 8-byte word of row r at row byte pos (word w of the segment): its
// fields from the staged columns, its validity bytes from the packed
// tile, zero in gaps and pad.
__device__ __forceinline__ uint64_t row_word(
    const unsigned char* smem, const TileCol* dcol, const int32_t* wdesc,
    int nc, int w, int pos, int r, int vld_base, int vld_end, int v0,
    const unsigned char* packed, int pstride) {
  const int d = wdesc[w];
  if ((d & 3) == kOneField) {
    return *reinterpret_cast<const uint64_t*>(smem + (d >> 2) + 8 * r);
  }
  if ((d & 3) == kHalfField) {
    return *reinterpret_cast<const uint64_t*>(smem + (d >> 2) + 16 * r);
  }
  uint64_t v = 0;
  for (int i = d >> 2; i < nc; ++i) {
    const int start = dcol[i].start;
    if (start >= pos + 8) break;
    const unsigned char* s = smem + dcol[i].data_off;
    switch (dcol[i].size) {
      case 1:
        v |= static_cast<uint64_t>(s[r]) << (8 * (start - pos));
        break;
      case 2:
        v |= static_cast<uint64_t>(reinterpret_cast<const uint16_t*>(s)[r])
             << (8 * (start - pos));
        break;
      default:  // 4; an 8- or 16-byte field has a word of its own
        v |= static_cast<uint64_t>(reinterpret_cast<const uint32_t*>(s)[r])
             << (8 * (start - pos));
    }
  }
  const int b0 = pos > vld_base ? pos : vld_base;
  const int b1 = pos + 8 < vld_end ? pos + 8 : vld_end;
  for (int b = b0; b < b1; ++b) {
    v |= static_cast<uint64_t>(packed[r * pstride + (b - vld_base - v0)])
         << (8 * (b - pos));
  }
  return v;
}

// Block x: rows [tile * rows, +rows) of segment x % nseg, tile = x / nseg:
// neighbouring blocks take the segments of the same rows, so the blocks
// in flight write whole rows (a choice, not a measured one: the other
// order, a segment's tiles together, is untested).
__global__ void __launch_bounds__(kTileThreads)
assemble_tiled_kernel(const TileCol* __restrict__ cols,
                      const Segment* __restrict__ segs, int ncols, int nseg,
                      int rows, int64_t n, int64_t row_size, int vld_base,
                      uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Segment sg = segs[blockIdx.x % nseg];
  const int64_t r0 = static_cast<int64_t>(blockIdx.x / nseg) * rows;
  const int nr = static_cast<int>(n - r0 < rows ? n - r0 : rows);
  const int nc = sg.c1 - sg.c0;
  const int vc0 = 8 * sg.v0;
  const int vc1 = 8 * sg.v1 < ncols ? 8 * sg.v1 : ncols;
  const int nvc = vc1 > vc0 ? vc1 - vc0 : 0;
  const int nwords = sg.word_end - sg.word_begin;
  const int seg0 = 8 * sg.word_begin;
  TileCol* dcol = reinterpret_cast<TileCol*>(smem + sg.info_off);
  ValidCol* vcol = reinterpret_cast<ValidCol*>(dcol + nc);
  int32_t* wdesc = reinterpret_cast<int32_t*>(vcol + nvc);

  // 1. the segment's descriptors; no field in any word yet
  for (int i = tid; i < nc; i += kTileThreads) dcol[i] = cols[sg.c0 + i];
  for (int i = tid; i < nvc; i += kTileThreads) {
    vcol[i] = ValidCol{cols[vc0 + i].valid, cols[vc0 + i].valid_off, 0};
  }
  for (int w = tid; w < nwords; w += kTileThreads) wdesc[w] = nc << 2 | kGeneral;
  __syncthreads();

  // 2. the tile's fields and bools in flight together, a warp an array;
  //    meanwhile each word's descriptor, from the first field in it
  for (int a = warp; a < nc + nvc; a += kTileWarps) {
    if (a < nc) {
      const int size = dcol[a].size;
      stage(smem + dcol[a].data_off,
            static_cast<const unsigned char*>(dcol[a].data) + r0 * size,
            nr * size, lane);
    } else if (vcol[a - nc].valid != nullptr) {
      stage(smem + vcol[a - nc].off, vcol[a - nc].valid + r0, nr, lane);
    }
  }
  for (int i = tid; i < nc; i += kTileThreads) {
    const int s = dcol[i].start - seg0, size = dcol[i].size;
    const int prev = i == 0 ? -1 : dcol[i - 1].start + dcol[i - 1].size - seg0;
    for (int w = s / 8; 8 * w < s + size; ++w) {
      if (prev > 8 * w) continue;  // an earlier field starts the word
      const int half = 8 * (w - s / 8);
      wdesc[w] = size == 8    ? dcol[i].data_off << 2 | kOneField
                 : size == 16 ? (dcol[i].data_off + half) << 2 | kHalfField
                              : i << 2 | kGeneral;
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // 3. the packed validity bytes, [row][byte]: a lane a row, so the
  //    bools it reads are neighbours and the bytes it writes fall in
  //    distinct banks
  const int nvb = sg.v1 - sg.v0;
  const int pstride = 4 * (((nvb + 3) / 4) | 1);  // tile_plan's packed_stride
  unsigned char* packed = smem + sg.packed_off;
  for (int it = tid; it < nvb * nr; it += kTileThreads) {
    const int b = it / nr, r = it - b * nr;
    const int k1 = 8 * b + 8 < nvc ? 8 * b + 8 : nvc;
    unsigned bits = 0;
    for (int k = 8 * b; k < k1; ++k) {
      const bool ok = vcol[k].valid == nullptr || smem[vcol[k].off + r] != 0;
      bits |= (ok ? 1u : 0u) << (k - 8 * b);
    }
    packed[r * pstride + b] = static_cast<unsigned char>(bits);
  }
  __syncthreads();

  // 4. each row segment's words: a thread takes the 16-byte block of
  //    the output that holds words w0 and w0 + 1, neighbouring threads
  //    neighbouring blocks of one row
  const int vld_end = vld_base + (ncols + 7) / 8;
  const int per_row = (nwords + 2) / 2;
  for (int it = tid; it < nr * per_row; it += kTileThreads) {
    const int r = it / per_row, j = it - r * per_row;
    const int64_t gw = (r0 + r) * (row_size / 8) + sg.word_begin;
    const int w0 = 2 * j - static_cast<int>(gw & 1);
    const int wa = w0 < 0 ? 0 : w0;  // this segment's words in the block
    const int wb = w0 + 1 < nwords ? w0 + 1 : nwords - 1;
    uint64_t* dst = reinterpret_cast<uint64_t*>(out) + gw;
    const uint64_t a = wa <= wb
        ? row_word(smem, dcol, wdesc, nc, wa, seg0 + 8 * wa, r, vld_base,
                   vld_end, sg.v0, packed, pstride)
        : 0;
    if (wa < wb) {
      const uint64_t b = row_word(smem, dcol, wdesc, nc, wb, seg0 + 8 * wb, r,
                                  vld_base, vld_end, sg.v0, packed, pstride);
      *reinterpret_cast<ulonglong2*>(dst + wa) = make_ulonglong2(a, b);
    } else if (wa == wb) {
      dst[wa] = a;
    }
  }
}

}  // namespace

// cols: device int64[ncols, 4] (see ColDesc); out: device uint8[n, row_size],
// 16-byte aligned; row_size a multiple of 8, at most kMaxRow (wider rows
// take srjt_assemble_rows_tiled). Launches on ``stream`` and returns the
// first CUDA error.
extern "C" int srjt_assemble_rows(const void* cols, int32_t ncols, int64_t n,
                                  int64_t row_size, int32_t vld_base,
                                  void* out, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (row_size > kMaxRow) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int size = static_cast<int>(row_size);
  const size_t smem = static_cast<size_t>(kRows) * size;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        assemble_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t blocks = (n + kRows - 1) / kRows;
  assemble_rows_kernel<<<static_cast<unsigned>(blocks), kRows, smem, s>>>(
      static_cast<const ColDesc*>(cols), ncols, n, size, vld_base,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// desc: device int32[8 * ncols + 8 * nseg], the TileCols then the
// Segments of row_transpose.tile_plan; rows, smem: the plan's rows a block
// and shared memory a block; out: device uint8[n, row_size], 16-byte
// aligned, row_size a multiple of 8. Launches on ``stream`` and returns
// the first CUDA error.
extern "C" int srjt_assemble_rows_tiled(const void* desc, int32_t ncols,
                                        int32_t nseg, int32_t rows,
                                        int32_t smem, int64_t n,
                                        int64_t row_size, int32_t vld_base,
                                        void* out, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const int64_t blocks = (n + rows - 1) / rows * nseg;
  if (nseg < 1 || rows < 1 || blocks > 0x7FFFFFFF) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        assemble_tiled_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const TileCol* c = static_cast<const TileCol*>(desc);
  assemble_tiled_kernel<<<static_cast<unsigned>(blocks), kTileThreads, smem,
                          s>>>(c, reinterpret_cast<const Segment*>(c + ncols),
                               ncols, nseg, rows, n, row_size, vld_base,
                               static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
