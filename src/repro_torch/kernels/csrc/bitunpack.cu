// Bit-unpack for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/bitunpack.py, bitunpack_pallas:
// value j of a little-endian stream of `bits`-wide values (1 <= bits <= 32)
// packed into uint32 words is (w0 >> sh) | (w1 << (32 - sh)) masked to
// `bits`, where bitpos = j * bits (uint32 arithmetic), w0 = words[bitpos /
// 32], w1 = the next word and sh = bitpos % 32.  On the TPU each grid step
// unpacks an (64, 128) tile of 8,192 values from 256 * bits words.
//
// What bounds it: bytes.  It reads n * bits / 8 bytes of words and writes
// 4 * n bytes of values, with a handful of integer operations per value.
// One thread per value with 4-byte stores (the first port) spent its time
// issuing load and store instructions and scheduling blocks, not moving
// bytes.
//
// Design: each thread unpacks a run of 4 consecutive values and writes them
// with one 16-byte store, consecutive threads on consecutive stores (the
// output is a fresh allocation; the entry point refuses one that is not
// 16-byte aligned).  A run's 4 * bits bits and the word after them lie in at
// most 5 words, which the thread loads once each (4-byte loads: `words` may
// be a view whose base is only 4-byte aligned; neighbouring threads share
// words, so a warp's loads coalesce), each index clamped to the stream's
// last word, so no load passes its end.  The last run writes its tail,
// where n is not a multiple of 4, value by value.  One block per 1,024
// values: persistent blocks walking the runs grid-stride, and warps staging
// their span of words in shared memory, both measured slower on the card.
// The two source words are joined by __funnelshift_r, which equals the TPU
// kernel's shift-or with hi = 0 at sh = 0; at bits = 32 the mask is
// 0xFFFFFFFF.  A run whose bit positions wrap past 2**32 (a stream of more
// than 512 MB) reads each value's two words by the reference's indices.

#include <cstdint>
#include <cuda_runtime.h>

#include "device_guard.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
bitunpack_kernel(const uint32_t* __restrict__ words, uint32_t* __restrict__ out,
                 long long n, uint32_t n_words, int bits) {
  const uint32_t last = n_words - 1;
  const uint32_t ubits = static_cast<uint32_t>(bits);
  const uint32_t mask = bits >= 32 ? 0xffffffffu : (1u << bits) - 1u;
  const long long j = 4 * (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x);
  if (j < n) {
    const uint32_t b0 = static_cast<uint32_t>(j) * ubits;  // uint32, as the reference
    const uint32_t wa = b0 >> 5;
    const uint32_t sh0 = b0 & 31u;
    uint32_t v[4];
    if (b0 <= 0xffffffffu - 4u * ubits) {
      // the four values' words, through the one after the last value's
      // first word: at most 5
      const uint32_t nw = ((sh0 + 3u * ubits) >> 5) + 2u;
      uint32_t a[5];
#pragma unroll
      for (uint32_t i = 0; i < 5; ++i) a[i] = i < nw ? __ldg(words + min(wa + i, last)) : 0u;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t rel = sh0 + k * ubits;
        const uint32_t x = rel >> 5;  // 0..3
        const uint32_t lo = x == 0 ? a[0] : x == 1 ? a[1] : x == 2 ? a[2] : a[3];
        const uint32_t hi = x == 0 ? a[1] : x == 1 ? a[2] : x == 2 ? a[3] : a[4];
        v[k] = __funnelshift_r(lo, hi, rel & 31u) & mask;
      }
    } else {  // bit positions wrap past 2**32 inside this run
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t bp = b0 + k * ubits;
        const uint32_t w = bp >> 5;
        v[k] = __funnelshift_r(__ldg(words + min(w, last)), __ldg(words + min(w + 1, last)),
                               bp & 31u) & mask;
      }
    }
    if (j + 4 <= n) {
      *reinterpret_cast<uint4*>(out + j) = make_uint4(v[0], v[1], v[2], v[3]);
    } else {
      for (int k = 0; k < n - j; ++k) out[j + k] = v[k];
    }
  }
}

}  // namespace

// Launch on `stream` of `device`, a thread per run of 4 values.  Returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for arguments
// the kernel does not take, more values than 2**31 - 1 blocks cover and an
// output not 16-byte aligned included.
extern "C" int bitunpack_launch(const void* words, void* out, long long n, int n_words,
                                int bits, int device, void* stream) {
  const long long grid = n > 0 ? (n + 4LL * kThreads - 1) / (4LL * kThreads) : 0;
  if (n <= 0 || n_words <= 0 || bits < 1 || bits > 32 || grid > 0x7fffffffLL ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  DeviceGuard guard(device);
  bitunpack_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<uint32_t*>(out), n,
      static_cast<uint32_t>(n_words), bits);
  return static_cast<int>(cudaGetLastError());
}
