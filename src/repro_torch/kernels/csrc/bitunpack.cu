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
//
// Design: one thread per output value, consecutive threads on consecutive
// values, so the stores are coalesced and neighbouring threads read the
// same or adjacent words (served from L1).  The two source words are joined
// by __funnelshift_r, which equals the TPU kernel's shift-or with hi = 0 at
// sh = 0, as miniblock_decode.cu does; at bits = 32 the mask is 0xFFFFFFFF.
// Both word indices clamp to the stream's last word, as the reference's
// gathers do (w + 1 is clamped explicitly at src/repro/kernels/bitunpack.py:38).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
bitunpack_kernel(const uint32_t* __restrict__ words, uint32_t* __restrict__ out,
                 long long n, uint32_t n_words, int bits) {
  const long long j = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (j >= n) return;
  const uint32_t bitpos = static_cast<uint32_t>(j) * static_cast<uint32_t>(bits);
  const uint32_t last = n_words - 1;
  const uint32_t w = bitpos >> 5;
  const uint32_t w0 = words[min(w, last)];
  const uint32_t w1 = words[min(w + 1, last)];
  const uint32_t mask = bits >= 32 ? 0xffffffffu : (1u << bits) - 1u;
  out[j] = __funnelshift_r(w0, w1, bitpos & 31u) & mask;
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int bitunpack_launch(const void* words, void* out, long long n, int n_words,
                                int bits, void* stream) {
  if (n <= 0 || n_words <= 0 || bits < 1 || bits > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  bitunpack_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<uint32_t*>(out), n,
      static_cast<uint32_t>(n_words), bits);
  return static_cast<int>(cudaGetLastError());
}
