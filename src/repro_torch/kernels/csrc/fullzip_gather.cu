// Full-zip fixed-stride gather for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/fullzip_gather.py,
// fullzip_gather_pallas: out[i] = zipped[rows[i]] over an (n_rows, stride)
// uint8 buffer of zipped [control word | value bytes] rows, with int32 row
// ids (duplicates allowed).  On the TPU each grid step DMAs one row, the
// scalar-prefetched row ids acting as a block table.
//
// What bounds it: bytes.  It does no arithmetic beyond addressing; it reads
// each requested row and writes it once.
//
// Design: one warp per output row; the warp loads its row id and its 32
// lanes copy the row together, neighbouring lanes on neighbouring addresses,
// so each row is read and written in full coalesced transactions.  When the
// stride and both base pointers are multiples of 16 bytes (the main path's
// 1536-byte embedding rows), each lane moves 16 bytes per access; otherwise
// (strides such as 33 or 129) it moves single bytes.  The wrapper checks that
// every row id is in range before the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
fullzip_gather_kernel(const uint8_t* __restrict__ zipped,
                      const int32_t* __restrict__ rows,
                      uint8_t* __restrict__ out, int n_take, int stride,
                      bool vec16) {
  const int i = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (i >= n_take) return;
  const uint8_t* src = zipped + static_cast<size_t>(rows[i]) * stride;
  uint8_t* dst = out + static_cast<size_t>(i) * stride;
  if (vec16) {
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    for (int k = lane; k < (stride >> 4); k += 32) d[k] = s[k];
  } else {
    for (int k = lane; k < stride; k += 32) dst[k] = src[k];
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int fullzip_gather_launch(const void* zipped, const void* rows, void* out,
                                     int n_take, int stride, void* stream) {
  if (n_take <= 0 || stride <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec16 = stride % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(zipped) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int blocks = (n_take + kWarpsPerBlock - 1) / kWarpsPerBlock;
  fullzip_gather_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(zipped), static_cast<const int32_t*>(rows),
      static_cast<uint8_t*>(out), n_take, stride, vec16);
  return static_cast<int>(cudaGetLastError());
}
