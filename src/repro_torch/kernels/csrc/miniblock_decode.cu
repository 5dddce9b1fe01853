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
// What bounds it: bytes.  A chunk reads at most 32 KiB of packed words and
// writes 4 bytes per output slot, with a handful of integer operations per
// slot, far below the card's integer rate, so the outputs written to device
// memory set the pace.  At the main path's shapes (a few hundred chunks of
// about 3,000 entries) the whole launch is one or two waves of CTAs, so what
// kept the first port from streaming its stores was each CTA's serial chain
// before its first store: staging the whole chunk, then a scan of 512
// entries a round with three barriers a round.
//
// Design: each chunk is cut into independent slices (1,024 entries at vpe
// = 1, from ops.miniblock_plan), one CTA each, so a chunk's slices run side
// by side and CTAs drift out of phase: one CTA's stores cover another's
// loads.  Nothing passes between CTAs.
// - A slice's first value slot is the count of valid entries before it.
//   Slices start at multiples of 256 entries, so the prefix is whole words
//   of the def stream whatever def_bits is.  For power-of-two widths the
//   CTA counts zero fields word by word (each field's bits folded onto its
//   lowest bit, masked, __popc); other widths go field by field.
//   ref.miniblock_slice_slots is the plain version of this count.
// - Each thread owns two runs of 4 consecutive entries, a CTA width apart,
//   so each run's 16-byte level stores are consecutive across the warp.
//   Level fields come straight from device memory (read-only path; a run of
//   power-of-two fields up to 8 bits is one word) before n_entries is known,
//   and the level outputs are stored before the scan, which needs none of
//   them.  One block-wide scan of both runs' valid counts, packed in one
//   int (warp __shfl_up_sync, one barrier, one pass over the warp totals),
//   gives every run its first slot.
// - vpe = 1 (its own instantiation, capped at 40 registers for occupancy):
//   a run's valid entries own consecutive slots, so it reads one span of at
//   most 5 value words and writes its values as one 16-byte store, with no
//   second barrier.
// - vpe > 1: each entry's first slot goes into a slot table in shared
//   memory (4 bytes an entry of the slice); after a second barrier the
//   values go out as 16-byte stores of 4 consecutive outputs, consecutive
//   threads on consecutive stores, each value's two words read from device
//   memory by the read-only path.  No main-path column has vpe > 1, and no
//   measured shape has shown that staging the value words in shared memory
//   pays, so none are staged.
// Fields that straddle two words use __funnelshift_r, which equals the TPU
// kernel's (w0 >> sh) | (w1 << (32 - sh)) with hi = 0 at sh == 0; word
// indices clamp to the row's last word as the TPU kernel's take does.  The
// FoR add is done in uint32 and reinterpreted, i.e. int32 arithmetic with
// wrap-around, as on the TPU.

#include <cstdint>
#include <cuda_runtime.h>

#include "device_guard.cuh"

namespace {

constexpr int kRun = 4;                     // entries per run
constexpr int kRuns = 2;                    // runs per thread
constexpr int kSliceAlign = 32 * kRun * kRuns;  // slices are whole warps' runs
constexpr int kMaxSlice = 1024;             // entries per CTA, at most
constexpr int kMaxThreads = kMaxSlice / (kRun * kRuns);
constexpr int kMaxWarps = kMaxThreads / 32;
// at most 40 registers a thread, so an SM holds 12 CTAs of 128 threads (the
// main path's 1,024-entry slices) where 48 would leave it 10
constexpr int kMinBlocks = 65536 / (40 * kMaxThreads);

__device__ __forceinline__ uint32_t field(const uint32_t* __restrict__ words, uint32_t last,
                                          uint32_t bitpos, uint32_t mask) {
  const uint32_t w = bitpos >> 5;
  const uint32_t w0 = __ldg(words + min(w, last));
  const uint32_t w1 = __ldg(words + min(w + 1, last));
  return __funnelshift_r(w0, w1, bitpos & 31u) & mask;
}

// The kRun fields of entries j0.. of a level stream of `bits`-wide fields
// (0 = absent: all 0).  A run of power-of-two fields up to 8 bits lies in
// one word (j0 is a multiple of kRun), so it takes one load.
__device__ __forceinline__ void run_fields(const uint32_t* __restrict__ words, uint32_t last,
                                           int j0, int bits, uint32_t mask, uint32_t* out) {
  const uint32_t bp = static_cast<uint32_t>(j0) * bits;
  if (bits == 0) {
#pragma unroll
    for (int i = 0; i < kRun; ++i) out[i] = 0u;
  } else if (bits <= 8 && (bits & (bits - 1)) == 0) {
    const uint32_t w = __ldg(words + min(bp >> 5, last));
#pragma unroll
    for (int i = 0; i < kRun; ++i) out[i] = (w >> ((bp & 31u) + i * bits)) & mask;
  } else {
#pragma unroll
    for (int i = 0; i < kRun; ++i) out[i] = field(words, last, bp + i * bits, mask);
  }
}

// Zero fields of a word of bits-wide fields (bits a power of two below 32).
__device__ __forceinline__ int zero_fields(uint32_t w, int bits, uint32_t low) {
  for (int s = 1; s < bits; s <<= 1) w |= w >> s;
  return 32 / bits - __popc(w & low);
}

// The values of a run at vpe = 1: its valid entries own consecutive slots
// from `offset`, so the run reads one span of at most 5 words (its values
// and the word after them), or field by field where values are wider than
// 32 bits.  One 16-byte store.
__device__ __forceinline__ void run_values(const uint32_t* __restrict__ vrow, uint32_t vlast,
                                           int j0, int n, const uint32_t* d, int count,
                                           int offset, uint32_t bits, uint32_t vmask,
                                           uint32_t ref, int fill, int32_t* out) {
  int32_t o[kRun];
  uint32_t bp = static_cast<uint32_t>(offset) * bits;
  if (bits <= 32u && count) {
    const uint32_t wa = bp >> 5;
    const uint32_t nw = (((bp & 31u) + (count - 1) * bits) >> 5) + 2;
    uint32_t a[5];
#pragma unroll
    for (uint32_t i = 0; i < 5; ++i) a[i] = i < nw ? __ldg(vrow + min(wa + i, vlast)) : 0u;
    uint32_t rel = bp & 31u;
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      const bool valid = j0 + i < n && d[i] == 0u;
      const uint32_t x = rel >> 5;  // 0..3
      const uint32_t lo = x == 0 ? a[0] : x == 1 ? a[1] : x == 2 ? a[2] : a[3];
      const uint32_t hi = x == 0 ? a[1] : x == 1 ? a[2] : x == 2 ? a[3] : a[4];
      o[i] = valid ? static_cast<int32_t>((__funnelshift_r(lo, hi, rel & 31u) & vmask) + ref)
                   : fill;
      rel += valid ? bits : 0u;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      const bool valid = j0 + i < n && d[i] == 0u;
      o[i] = valid ? static_cast<int32_t>(field(vrow, vlast, bp, vmask) + ref) : fill;
      bp += valid ? bits : 0u;
    }
  }
  *reinterpret_cast<int4*>(out) = make_int4(o[0], o[1], o[2], o[3]);
}

// kOne: vpe == 1, compiled apart so that the vpe > 1 path's registers do
// not weigh on the main path's occupancy
template <bool kOne>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
miniblock_decode_kernel(const uint32_t* __restrict__ rep_words,
                        const uint32_t* __restrict__ def_words,
                        const uint32_t* __restrict__ val_words,
                        const int32_t* __restrict__ params,
                        int32_t* __restrict__ out_rep,
                        int32_t* __restrict__ out_def,
                        int32_t* __restrict__ out_val,
                        int RW, int DW, int VW, int rep_bits, int def_bits,
                        int vpe, int tile, int fill, int slice, int slices) {
  extern __shared__ int32_t s_slot[];  // vpe > 1: each entry's slot, -1 at nulls
  __shared__ int s_count[kMaxWarps];
  __shared__ int s_before[kMaxWarps];

  const size_t c = blockIdx.x / slices;
  const int start = (blockIdx.x % slices) * slice;
  const int end = min(start + slice, tile);
  const int t = threadIdx.x, T = blockDim.x;
  const int lane = t & 31, warp = t >> 5;
  const int n = __ldg(params + c * 3 + 0);
  const uint32_t bits = static_cast<uint32_t>(__ldg(params + c * 3 + 1));
  const uint32_t ref = static_cast<uint32_t>(__ldg(params + c * 3 + 2));
  const uint32_t* rrow = rep_words + c * RW;
  const uint32_t* drow = def_words + c * DW;
  const uint32_t* vrow = val_words + c * VW;
  const uint32_t rlast = RW - 1, dlast = DW - 1, vlast = VW - 1;
  const uint32_t rmask = rep_bits ? (1u << rep_bits) - 1u : 0u;
  const uint32_t dmask = def_bits ? (1u << def_bits) - 1u : 0u;

  // this thread's runs: entries j0(q) = start + kRun * (t + q * T), so each
  // run's stores are consecutive across the warp.  The level words are
  // loaded before n is known (indices clamp, so every load is in bounds)
  uint32_t r[kRuns][kRun], d[kRuns][kRun];
#pragma unroll
  for (int q = 0; q < kRuns; ++q) {
    const int j0 = start + kRun * (t + q * T);
    run_fields(rrow, rlast, j0, rep_bits, rmask, r[q]);
    run_fields(drow, dlast, j0, def_bits, dmask, d[q]);
  }

  // valid entries before the slice (they count only when an entry of the
  // slice lies below n, and then all of them do)
  int before = 0;
  if (!def_bits) {
    before = t == 0 ? start : 0;
  } else if ((def_bits & (def_bits - 1)) == 0) {
    uint32_t low = 0;
    for (int b = 0; b < 32; b += def_bits) low |= 1u << b;
    const int words = start / 32 * def_bits;
    for (int i = t; i < words; i += T)
      before += zero_fields(__ldg(drow + min(static_cast<uint32_t>(i), dlast)), def_bits, low);
  } else {
    for (int j = t; j < start; j += T)
      before += field(drow, dlast, static_cast<uint32_t>(j) * def_bits, dmask) == 0u;
  }
  if (n <= start) before = 0;

  // mask past n, count the valid entries, and store the level outputs,
  // which need no slot, before the scan
  int count[kRuns], packed = 0;
#pragma unroll
  for (int q = 0; q < kRuns; ++q) {
    const int j0 = start + kRun * (t + q * T);
    count[q] = 0;
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      const bool in = j0 + i < n;
      r[q][i] = in ? r[q][i] : 0u;
      d[q][i] = in ? d[q][i] : 0u;
      count[q] += (in && d[q][i] == 0u) ? 1 : 0;
    }
    if (j0 < end) {
      const size_t o = c * tile + j0;
      *reinterpret_cast<int4*>(out_rep + o) = make_int4(r[q][0], r[q][1], r[q][2], r[q][3]);
      *reinterpret_cast<int4*>(out_def + o) = make_int4(d[q][0], d[q][1], d[q][2], d[q][3]);
    } else {
      count[q] = 0;
    }
    packed += count[q] << (16 * q);  // a slice's counts stay below 2**16
  }

  // one block-wide exclusive scan of both runs' counts, packed in one int
  int incl = packed;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  before = __reduce_add_sync(0xffffffffu, before);
  if (lane == 31) {
    s_count[warp] = incl;
    s_before[warp] = before;
  }
  __syncthreads();
  int excl = incl - packed, totals = 0, base = 0;
  for (int w = 0; w < (T >> 5); ++w) {
    const int v = s_count[w];
    excl += w < warp ? v : 0;
    totals += v;
    base += s_before[w];
  }
  // run q's first slot: the slice's base, the runs 0 of every thread (for
  // q = 1), and the same runs of the threads before this one
  int offset[kRuns];
#pragma unroll
  for (int q = 0; q < kRuns; ++q)
    offset[q] = base + (q ? (totals & 0xffff) : 0) + ((excl >> (16 * q)) & 0xffff);

  const uint32_t vmask = bits >= 32u ? 0xffffffffu : (1u << bits) - 1u;
  if (kOne) {  // no second barrier
#pragma unroll
    for (int q = 0; q < kRuns; ++q) {
      const int j0 = start + kRun * (t + q * T);
      if (j0 < end)
        run_values(vrow, vlast, j0, n, d[q], count[q], offset[q], bits, vmask, ref, fill,
                   out_val + c * tile + j0);
    }
    return;
  }

  // vpe > 1: the slot table
#pragma unroll
  for (int q = 0; q < kRuns; ++q) {
    const int e0 = kRun * (t + q * T);
    int s = offset[q];
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      const bool valid = start + e0 + i < n && d[q][i] == 0u;
      s_slot[e0 + i] = valid ? s++ : -1;
    }
  }
  __syncthreads();

  // 16-byte stores of 4 consecutive outputs, consecutive threads on
  // consecutive stores
  const int groups = (end - start) * vpe / 4;
  int32_t* vout = out_val + (c * tile + start) * static_cast<size_t>(vpe);
  for (int g = t; g < groups; g += T) {
    int e = 4 * g / vpe;
    int k = 4 * g - e * vpe;
    int32_t o[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int sl = s_slot[e];
      o[i] = fill;
      if (sl >= 0) {
        const uint32_t bp = (static_cast<uint32_t>(sl) * vpe + k) * bits;
        const uint32_t w = bp >> 5;
        const uint32_t lo = __ldg(vrow + min(w, vlast));
        const uint32_t hi = __ldg(vrow + min(w + 1, vlast));
        o[i] = static_cast<int32_t>((__funnelshift_r(lo, hi, bp & 31u) & vmask) + ref);
      }
      if (++k == vpe) {
        k = 0;
        ++e;
      }
    }
    *reinterpret_cast<int4*>(vout + 4 * g) = make_int4(o[0], o[1], o[2], o[3]);
  }
}

}  // namespace

// Launch on `stream` of `device` with the plan of ops.miniblock_plan:
// `slice` entries per CTA (kRun * kRuns per thread).
// Returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue for
// arguments or a plan the kernel does not take, outputs not 16-byte aligned
// included.
extern "C" int miniblock_decode_launch(const void* rep_words, const void* def_words,
                                       const void* val_words, const void* params,
                                       void* out_rep, void* out_def, void* out_val,
                                       int C, int RW, int DW, int VW, int rep_bits,
                                       int def_bits, int vpe, int tile, int fill,
                                       int slice, int device, void* stream) {
  if (C <= 0 || RW <= 0 || DW <= 0 || VW <= 0 || vpe <= 0 || tile <= 0 ||
      tile % 128 || static_cast<long long>(tile) * vpe > (1 << 17) ||
      rep_bits < 0 || rep_bits > 31 || def_bits < 0 || def_bits > 31 ||
      slice < kSliceAlign || slice > kMaxSlice || slice % kSliceAlign)
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t align = reinterpret_cast<uintptr_t>(out_rep) |
      reinterpret_cast<uintptr_t>(out_def) | reinterpret_cast<uintptr_t>(out_val);
  if (align % 16) return static_cast<int>(cudaErrorInvalidValue);
  const long long slices = (tile + slice - 1) / slice;
  const long long blocks = slices * C;
  // the slot table, at most 4 KB
  const size_t smem = vpe > 1 ? sizeof(int32_t) * static_cast<size_t>(slice) : 0;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  DeviceGuard guard(device);
  auto kernel = vpe == 1 ? miniblock_decode_kernel<true> : miniblock_decode_kernel<false>;
  kernel<<<static_cast<unsigned>(blocks), slice / (kRun * kRuns), smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(rep_words), static_cast<const uint32_t*>(def_words),
      static_cast<const uint32_t*>(val_words), static_cast<const int32_t*>(params),
      static_cast<int32_t*>(out_rep), static_cast<int32_t*>(out_def),
      static_cast<int32_t*>(out_val), RW, DW, VW, rep_bits, def_bits, vpe, tile, fill,
      slice, static_cast<int>(slices));
  return static_cast<int>(cudaGetLastError());
}
