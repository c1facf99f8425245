/* Declarations of the two functions of zstd's stable API that the native
 * readers (src/native/src/parquet_reader.cpp) call. Used only to compile
 * those sources where the system carries zstd's runtime library
 * (libzstd.so.1) but not its development header; the library linked is
 * the system's own. */
#ifndef SRJT_ZSTD_DECLARATIONS_H
#define SRJT_ZSTD_DECLARATIONS_H

#include <stddef.h>

#ifdef __cplusplus
extern "C" {
#endif

size_t ZSTD_decompress(void* dst, size_t dstCapacity, const void* src,
                       size_t compressedSize);
unsigned ZSTD_isError(size_t code);

#ifdef __cplusplus
}
#endif

#endif
