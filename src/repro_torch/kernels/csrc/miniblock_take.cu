// Requested entries of mini-block chunks for Hopper (sm_90a).
//
// Replaces no TPU kernel.  The JAX package decodes every fetched chunk whole
// (src/repro/kernels/miniblock_decode.py, miniblock_decode_pallas) and then
// selects the requested rows on the host.  A random take of a few hundred
// rows fetches a few hundred chunks of up to 4,096 entries, so that decode
// writes, copies back and walks about a thousand entries for every one that
// was asked for.  Where a column has no repetition levels (a flat primitive
// or a fixed-size list, nullable or not), the repetition index already gives
// each row's place: row r of chunk c is entry r - rows_before[c].  This
// kernel takes those places and decodes only the requested entries.
//
// Inputs: the packed definition-level and value word rows and the (C, 3)
// [n_entries, value bits, FoR reference] params that miniblock_decode takes,
// and one int32 a requested entry, (j << 12) | e: entry e of chunk j.
// Output: (R, width) int32, each row's vpe values (fill at a null) and, where
// def_bits > 0, its definition level in the last column.  A pair outside its
// chunk (j not in [0, C), or e not below n_entries) reads fill everywhere
// and definition level -1.
//
// What bounds it: launch and latency.  A row reads a few words and writes
// 4 * (vpe + 1) bytes; a date take's fragment asks for ~42 rows, so the
// whole launch is a handful of CTAs and its time is the launch and one
// chain of dependent loads.  Design: one warp a row, eight rows a CTA.
// - The row's value slot is the count of valid (def == 0) entries before e.
//   The warp splits the def words before e among its lanes and counts their
//   zero fields, as miniblock_decode counts a slice's prefix: for
//   power-of-two widths word by word (each field's bits folded onto its
//   lowest bit, masked, __popc), other widths field by field; then one
//   __reduce_add_sync.  Without a def stream the slot is e.
// - Lanes k < vpe extract value k at (slot * vpe + k) * bits with
//   __funnelshift_r and add the frame of reference in uint32 (int32
//   arithmetic with wrap-around), exactly as miniblock_decode does; word
//   indices clamp to the row's last word as its loads do.

#include <cstdint>
#include <cuda_runtime.h>

#include "device_guard.cuh"

namespace {

constexpr int kRowsPerBlock = 8;  // one warp a row
constexpr int kEntryBits = 12;    // e < 4,096, the format's per-chunk ceiling

__device__ __forceinline__ uint32_t field(const uint32_t* __restrict__ words, uint32_t last,
                                          uint32_t bitpos, uint32_t mask) {
  const uint32_t w = bitpos >> 5;
  const uint32_t w0 = __ldg(words + min(w, last));
  const uint32_t w1 = __ldg(words + min(w + 1, last));
  return __funnelshift_r(w0, w1, bitpos & 31u) & mask;
}

// Each bits-wide field's bits folded onto its lowest bit (bits a power of
// two below 32); the caller masks the lowest bits.
__device__ __forceinline__ uint32_t fold(uint32_t w, int bits) {
  for (int s = 1; s < bits; s <<= 1) w |= w >> s;
  return w;
}

__global__ void __launch_bounds__(32 * kRowsPerBlock)
miniblock_take_kernel(const uint32_t* __restrict__ def_words,
                      const uint32_t* __restrict__ val_words,
                      const int32_t* __restrict__ params,
                      const int32_t* __restrict__ pairs,
                      int32_t* __restrict__ out,
                      int C, long long R, int DW, int VW, int def_bits, int vpe,
                      int fill, int width) {
  const long long r = static_cast<long long>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  if (r >= R) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  const int p = __ldg(pairs + r);
  const int j = p >> kEntryBits;  // arithmetic shift: a negative pair is out of range
  const int e = p & ((1 << kEntryBits) - 1);
  int32_t* o = out + r * width;
  if (j < 0 || j >= C || e >= __ldg(params + 3 * static_cast<size_t>(j))) {
    for (int k = lane; k < vpe; k += 32) o[k] = fill;
    if (def_bits && lane == 0) o[vpe] = -1;
    return;
  }
  const uint32_t bits = static_cast<uint32_t>(__ldg(params + 3 * static_cast<size_t>(j) + 1));
  const uint32_t ref = static_cast<uint32_t>(__ldg(params + 3 * static_cast<size_t>(j) + 2));
  const uint32_t* vrow = val_words + static_cast<size_t>(j) * VW;
  const uint32_t vlast = VW - 1;

  int slot = e;
  uint32_t d = 0;
  if (def_bits) {
    const uint32_t* drow = def_words + static_cast<size_t>(j) * DW;
    const uint32_t dlast = DW - 1;
    const uint32_t dmask = (1u << def_bits) - 1u;
    const uint32_t bp = static_cast<uint32_t>(e) * def_bits;
    int before = 0;
    if ((def_bits & (def_bits - 1)) == 0) {
      uint32_t low = 0;
      for (int b = 0; b < 32; b += def_bits) low |= 1u << b;
      const uint32_t whole = bp >> 5, rem = bp & 31u;  // fields never straddle words
      for (uint32_t i = lane; i < whole; i += 32)
        before += 32 / def_bits -
                  __popc(fold(__ldg(drow + min(i, dlast)), def_bits) & low);
      if (lane == 0 && rem) {
        const uint32_t part = fold(__ldg(drow + min(whole, dlast)), def_bits) & low &
                              ((1u << rem) - 1u);
        before += static_cast<int>(rem) / def_bits - __popc(part);
      }
    } else {
      for (int i = lane; i < e; i += 32)
        before += field(drow, dlast, static_cast<uint32_t>(i) * def_bits, dmask) == 0u;
    }
    slot = __reduce_add_sync(0xffffffffu, before);
    d = field(drow, dlast, bp, dmask);
  }

  const uint32_t vmask = bits >= 32u ? 0xffffffffu : (1u << bits) - 1u;
  for (int k = lane; k < vpe; k += 32) {
    const uint32_t at = (static_cast<uint32_t>(slot) * vpe + k) * bits;
    o[k] = d == 0u ? static_cast<int32_t>(field(vrow, vlast, at, vmask) + ref) : fill;
  }
  if (def_bits && lane == 0) o[vpe] = static_cast<int32_t>(d);
}

}  // namespace

// Launch on `stream` of `device`: R requested entries of C chunks, one warp
// each.  Returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue
// for arguments the kernel does not take.
extern "C" int miniblock_take_launch(const void* def_words, const void* val_words,
                                     const void* params, const void* pairs, void* out,
                                     int C, long long R, int DW, int VW, int def_bits,
                                     int vpe, int fill, int device, void* stream) {
  if (C <= 0 || C > (1 << (31 - kEntryBits)) || R <= 0 || DW <= 0 || VW <= 0 ||
      def_bits < 0 || def_bits > 31 || vpe <= 0 || vpe > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (R + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  DeviceGuard guard(device);
  miniblock_take_kernel<<<static_cast<unsigned>(blocks), 32 * kRowsPerBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(def_words), static_cast<const uint32_t*>(val_words),
      static_cast<const int32_t*>(params), static_cast<const int32_t*>(pairs),
      static_cast<int32_t*>(out), C, R, DW, VW, def_bits, vpe, fill,
      vpe + (def_bits ? 1 : 0));
  return static_cast<int>(cudaGetLastError());
}
