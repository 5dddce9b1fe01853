// Mini-block chunk decode for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/miniblock_decode.py,
// miniblock_decode_pallas (kernel body _kernel, helper _extract).  Per chunk:
// unpack the bit-packed repetition and definition level streams (static
// widths, 0 = absent), mark valid = (def == 0) & (j < n_entries), give each
// valid entry the value slot cumsum(valid) - 1, extract vpe little-endian
// values per valid entry at slot * bits, add the frame-of-reference and write
// fill at nulls.  Outputs: rep, def (C, tile) int32; vals (C, tile * vpe)
// int32.
//
// What bounds it: bytes.  Each chunk reads at most 32 KiB of packed words and
// writes 4 bytes per output slot, with a handful of integer operations per
// slot, far below the card's integer rate, so the outputs written to device
// memory set the pace.
//
// Design: one CTA per chunk (the TPU grid's one step per chunk).  The
// chunk's packed words are staged once in shared memory (a chunk is at most
// 32 KiB by the format's 12-bit word count), so the scattered field reads of
// the unpack hit shared memory, not device memory.  The value slots come
// from a block-wide exclusive scan over the validity flags, one round of
// blockDim entries at a time (warp ballot + popcount, then a shuffle scan of
// the warp totals), kept in shared memory (4 bytes per entry, at most 16
// KiB).  Outputs are written straight to device memory by consecutive
// threads, so every store is coalesced; the value tile is never staged, since
// tile * vpe can reach 1 << 17 values.  Fields that straddle two words use
// __funnelshift_r, which equals the TPU kernel's (w0 >> sh) | (w1 << (32 -
// sh)) with hi = 0 at sh == 0; the second word index clamps to the row's last
// word as the TPU kernel's take does.  The FoR add is done in uint32 and
// reinterpreted, i.e. int32 arithmetic with wrap-around, as on the TPU.

#include <cstdint>
#include <cuda_runtime.h>

#include "device_guard.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr size_t kMaxSmem = 227 * 1024;

__device__ __forceinline__ uint32_t extract(const uint32_t* words, uint32_t n_words,
                                            uint32_t bitpos, uint32_t mask) {
  const uint32_t last = n_words - 1;
  const uint32_t w = bitpos >> 5;
  const uint32_t w0 = words[min(w, last)];
  const uint32_t w1 = words[min(w + 1, last)];
  return __funnelshift_r(w0, w1, bitpos & 31u) & mask;
}

__global__ void __launch_bounds__(kThreads)
miniblock_decode_kernel(const uint32_t* __restrict__ rep_words,
                        const uint32_t* __restrict__ def_words,
                        const uint32_t* __restrict__ val_words,
                        const int32_t* __restrict__ params,
                        int32_t* __restrict__ out_rep,
                        int32_t* __restrict__ out_def,
                        int32_t* __restrict__ out_val,
                        int RW, int DW, int VW, int rep_bits, int def_bits,
                        int vpe, int tile, int fill) {
  extern __shared__ uint32_t smem[];
  __shared__ int s_warp[kWarps];
  uint32_t* s_rep = smem;
  uint32_t* s_def = s_rep + (rep_bits ? RW : 0);
  uint32_t* s_val = s_def + (def_bits ? DW : 0);
  int32_t* s_slot = reinterpret_cast<int32_t*>(s_val + VW);

  const size_t c = blockIdx.x;
  const int n = params[c * 3 + 0];
  const uint32_t bits = static_cast<uint32_t>(params[c * 3 + 1]);
  const uint32_t ref = static_cast<uint32_t>(params[c * 3 + 2]);

  if (rep_bits)
    for (int i = threadIdx.x; i < RW; i += kThreads) s_rep[i] = rep_words[c * RW + i];
  if (def_bits)
    for (int i = threadIdx.x; i < DW; i += kThreads) s_def[i] = def_words[c * DW + i];
  for (int i = threadIdx.x; i < VW; i += kThreads) s_val[i] = val_words[c * VW + i];
  __syncthreads();

  const uint32_t rep_mask = rep_bits ? (1u << rep_bits) - 1u : 0u;
  const uint32_t def_mask = def_bits ? (1u << def_bits) - 1u : 0u;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int running = 0;  // valid entries in earlier rounds (the same in every thread)
  for (int base = 0; base < tile; base += kThreads) {
    const int j = base + threadIdx.x;
    const bool active = j < tile;
    const bool in_range = j < n;
    uint32_t r = 0, d = 0;
    if (in_range && active) {
      if (rep_bits) r = extract(s_rep, RW, static_cast<uint32_t>(j) * rep_bits, rep_mask);
      if (def_bits) d = extract(s_def, DW, static_cast<uint32_t>(j) * def_bits, def_mask);
    }
    const bool valid = active && in_range && d == 0;
    if (active) {
      out_rep[c * tile + j] = static_cast<int32_t>(r);
      out_def[c * tile + j] = static_cast<int32_t>(d);
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, valid);
    const int prefix = __popc(ballot & ((1u << lane) - 1u));
    if (lane == 0) s_warp[warp] = __popc(ballot);
    __syncthreads();
    if (warp == 0) {
      int v = lane < kWarps ? s_warp[lane] : 0;
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += t;
      }
      if (lane < kWarps) s_warp[lane] = v;  // inclusive scan of warp totals
    }
    __syncthreads();
    if (active) s_slot[j] = valid ? running + (warp ? s_warp[warp - 1] : 0) + prefix : -1;
    running += s_warp[kWarps - 1];
    __syncthreads();  // s_warp is rewritten by the next round
  }

  const uint32_t vmask = bits >= 32u ? 0xffffffffu : (1u << bits) - 1u;
  const int nv = tile * vpe;
  for (int k = threadIdx.x; k < nv; k += kThreads) {
    const int e = k / vpe;
    const int s = s_slot[e];
    int32_t o = fill;
    if (s >= 0) {
      const uint32_t slot = static_cast<uint32_t>(s) * vpe + static_cast<uint32_t>(k - e * vpe);
      o = static_cast<int32_t>(extract(s_val, VW, slot * bits, vmask) + ref);
    }
    out_val[c * nv + k] = o;
  }
}

}  // namespace

// Launch on `stream` of `device`; returns cudaGetLastError() (0 on success).
extern "C" int miniblock_decode_launch(const void* rep_words, const void* def_words,
                                       const void* val_words, const void* params,
                                       void* out_rep, void* out_def, void* out_val,
                                       int C, int RW, int DW, int VW, int rep_bits,
                                       int def_bits, int vpe, int tile, int fill,
                                       int device, void* stream) {
  if (C <= 0 || RW <= 0 || DW <= 0 || VW <= 0 || vpe <= 0 || tile <= 0 ||
      rep_bits < 0 || rep_bits > 31 || def_bits < 0 || def_bits > 31)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(uint32_t) *
      (static_cast<size_t>(rep_bits ? RW : 0) + (def_bits ? DW : 0) + VW + tile);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  DeviceGuard guard(device);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        miniblock_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  miniblock_decode_kernel<<<C, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(rep_words), static_cast<const uint32_t*>(def_words),
      static_cast<const uint32_t*>(val_words), static_cast<const int32_t*>(params),
      static_cast<int32_t*>(out_rep), static_cast<int32_t*>(out_def),
      static_cast<int32_t*>(out_val), RW, DW, VW, rep_bits, def_bits, vpe, tile, fill);
  return static_cast<int>(cudaGetLastError());
}
