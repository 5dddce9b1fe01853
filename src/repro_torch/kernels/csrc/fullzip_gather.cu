// Full-zip fixed-stride gather for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/fullzip_gather.py,
// fullzip_gather_pallas: out[i] = zipped[rows[i]] over an (n_rows, stride)
// uint8 buffer of zipped [control word | value bytes] rows, with int32 row
// ids (duplicates allowed).  On the TPU each grid step DMAs one row, the
// scalar-prefetched row ids acting as a block table.
//
// What bounds it: bytes.  It does no arithmetic beyond addressing; it reads
// each requested row and writes it once.  At 3.35 TB/s the card needs about
// 20 KB in flight per SM, more than warps copying through registers keep in
// flight when each lane's load waits for its store.
//
// Design: persistent one-warp blocks, a few per SM (ops.fullzip_plan sizes
// the grid and picks the route; both routes are swept alike).
//   * bulk route (stride and both base pointers multiples of 16 bytes: the
//     main path's 1,536-byte embedding rows).  The output is cut into units
//     of up to 32 whole rows that fit a 16 KB shared-memory slot, or 16 KB
//     chunks of one row where a row is larger than a slot.  Each block fills
//     its ring with a fixed first share, then draws units from a ticket
//     counter, so none idles while another still has a queue (with every
//     unit split up front, the slowest blocks set the end of a large
//     gather).  The counter belongs to the launch: the caller passes 8
//     bytes of device memory that no other running launch can hold (the
//     wrapper takes a fresh block from PyTorch's stream-ordered caching
//     allocator on the launch's stream), and the launcher zeroes it on that
//     stream just before the kernel, so a CUDA graph captures the memset
//     with the kernel.
//     A ring of kStages slots keeps up to kStages units of loads in flight:
//     each lane issues one 1-D bulk copy (cp.async.bulk, the TMA engine) of
//     its row into the slot, counted on the slot's mbarrier by expect_tx;
//     the next unit's ticket and row ids are fetched one issue ahead.  When
//     the slot is full, lane 0 writes it out with one bulk store (a unit's
//     output rows are contiguous) and waits for that store to have read the
//     slot (cp.async.bulk.wait_group.read) before the slot is loaded again.
//     No data passes through registers; both copies carry an L2
//     evict-first hint.
//   * register route (any other stride or alignment, e.g. strides 1, 33,
//     129 or a sliced zipped view).  The launcher picks the widest word (16,
//     8, 4, 2 or 1 bytes) that divides the stride and both base pointers, so
//     every row is whole words and there is no ragged tail.  Each lane loads
//     up to kUnroll words of its row into registers before it stores any.
// The launcher checks every row id is in range before the launch.  The C
// entry point takes the device index and sets it only when it differs from
// the current one, so the Python side needs no device guard per launch.

#include <cstdint>
#include <cuda_runtime.h>

#include "device_guard.cuh"

namespace {

constexpr int kStageBytes = 16384;  // one ring slot
constexpr int kStages = 4;          // slots per block
constexpr int kMaxRowsPerUnit = 32; // one row per lane
constexpr int kUnroll = 8;          // register route: words in flight per lane
constexpr int kRouteBulk = 0, kRouteRegister = 1;
// unit j + kStages - 1 is loaded before unit j is waited for
static_assert(kStages >= 2, "the bulk ring refills one unit behind");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// The gathered rows are read once and written once: both copies ask L2 to
// evict their lines first, so the stream does not push out other data.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "{\n .reg .b64 pol;\n"
      " createpolicy.fractional.L2::evict_first.b64 pol, 1.0;\n"
      " cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1], %2, [%3], pol;\n}\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile(
      "{\n .reg .b64 pol;\n"
      " createpolicy.fractional.L2::evict_first.b64 pol, 1.0;\n"
      " cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint [%0], [%1], %2, pol;\n}\n" ::"l"(
          dst),
      "r"(smem_addr(src)), "r"(bytes)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// One unit of the bulk route: `r` output rows from `i0`, bytes [off, off +
// len) of each (len = stride and off = 0 unless a row spans several slots).
struct Unit {
  int64_t i0;
  int r;
  int64_t off;
  uint32_t len;
};

__device__ __forceinline__ Unit unit_at(int64_t u, int64_t n_take, int64_t stride) {
  Unit U;
  if (stride <= kStageBytes) {
    const int rpu = min(static_cast<int64_t>(kMaxRowsPerUnit), kStageBytes / stride);
    U.i0 = u * rpu;
    U.r = static_cast<int>(min(static_cast<int64_t>(rpu), n_take - U.i0));
    U.off = 0;
    U.len = static_cast<uint32_t>(stride);
  } else {
    const int64_t cpr = (stride + kStageBytes - 1) / kStageBytes;
    U.i0 = u / cpr;
    U.r = 1;
    U.off = (u % cpr) * kStageBytes;
    U.len = static_cast<uint32_t>(min(static_cast<int64_t>(kStageBytes), stride - U.off));
  }
  return U;
}

// Work tickets of the bulk route: units after each block's first share are
// drawn from `next_unit`, zeroed for this launch alone, so a block that runs
// ahead takes more of them.  Every block draws until one draw fails.
__global__ void __launch_bounds__(32)
gather_bulk_kernel(const uint8_t* __restrict__ zipped, const int32_t* __restrict__ rows,
                   uint8_t* __restrict__ out, int64_t n_take, int64_t stride, int64_t n_units,
                   unsigned long long* __restrict__ next_unit) {
  extern __shared__ __align__(128) uint8_t ring[];
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ int64_t unit_in[kStages];  // the unit each slot holds (lane 0's)
  const int lane = threadIdx.x;
  if (lane == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();

  // Block b first fills its ring with units b, b + grid, ... (their row ids
  // loaded at once); the units after grid * kStages are drawn from the
  // ticket counter.  Each issue of a drawn unit then draws the next one and
  // loads the lane's row id of it, so no issue waits on a global load or an
  // atomic.
  const int64_t first_drawn = static_cast<int64_t>(gridDim.x) * kStages;
  auto draw = [&]() -> int64_t {
    unsigned long long t = 0;
    if (lane == 0) t = atomicAdd(next_unit, 1ULL);
    return first_drawn + static_cast<int64_t>(__shfl_sync(0xffffffffu, t, 0));
  };
  auto row_of = [&](int64_t u) -> int32_t {
    if (u >= n_units) return 0;
    const Unit U = unit_at(u, n_take, stride);
    return lane < U.r ? rows[U.i0 + lane] : 0;
  };
  int64_t issued = 0;
  auto issue = [&](int64_t u, int64_t row) {
    const int s = static_cast<int>(issued++ % kStages);
    const Unit U = unit_at(u, n_take, stride);
    if (lane == 0) {
      unit_in[s] = u;
      mbar_expect_tx(&full[s], U.len * U.r);
    }
    __syncwarp();
    if (lane < U.r)
      bulk_load(ring + s * kStageBytes + lane * U.len, zipped + row * stride + U.off, U.len,
                &full[s]);
  };
  int32_t first_rows[kStages];
#pragma unroll
  for (int s = 0; s < kStages; ++s) first_rows[s] = row_of(blockIdx.x + s * int64_t{gridDim.x});
#pragma unroll
  for (int s = 0; s < kStages; ++s) {
    const int64_t u = blockIdx.x + s * int64_t{gridDim.x};
    if (u < n_units) issue(u, first_rows[s]);
  }
  // the draw waits for its atomic: only after the loads are on their way
  int64_t next = draw();
  int32_t next_row = row_of(next);
  auto issue_drawn = [&]() {
    issue(next, next_row);
    next = draw();
    next_row = row_of(next);
  };

  for (int64_t j = 0; j < issued; ++j) {
    const int s = static_cast<int>(j % kStages);
    mbar_wait(&full[s], static_cast<uint32_t>((j / kStages) & 1));
    if (lane == 0) {
      const Unit U = unit_at(unit_in[s], n_take, stride);
      bulk_store(out + U.i0 * stride + U.off, ring + s * kStageBytes, U.len * U.r);
    }
    // refill the slot of unit j - 1 (issued == j - 1 + kStages) once its
    // store has read it
    if (j >= 1 && next < n_units) {
      if (lane == 0) asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
      __syncwarp();
      issue_drawn();
    }
  }
  if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

template <typename W>
__global__ void __launch_bounds__(32)
gather_register_kernel(const uint8_t* __restrict__ zipped, const int32_t* __restrict__ rows,
                       uint8_t* __restrict__ out, int64_t n_take, int64_t stride) {
  const int lane = threadIdx.x;
  const int64_t words = stride / static_cast<int64_t>(sizeof(W));
  for (int64_t i = blockIdx.x; i < n_take; i += gridDim.x) {
    const W* src = reinterpret_cast<const W*>(zipped + static_cast<int64_t>(rows[i]) * stride);
    W* dst = reinterpret_cast<W*>(out + i * stride);
    for (int64_t base = 0; base < words; base += 32 * kUnroll) {
      W v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t w = base + u * 32 + lane;
        if (w < words) v[u] = src[w];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t w = base + u * 32 + lane;
        if (w < words) dst[w] = v[u];
      }
    }
  }
}

}  // namespace

// Launch on `stream` of `device`; returns the first CUDA error (0 on
// success).  `route` is 0 (bulk: stride and both pointers multiples of 16)
// or 1 (register, `word` bytes per access dividing the stride and both
// pointers); `grid` is the number of persistent blocks (ops.fullzip_plan);
// `counter` (bulk route only, else null) is 8 bytes of device memory that
// no launch which may run at the same time holds: it is zeroed on `stream`
// before the kernel and is the launch's work-ticket counter.
extern "C" int fullzip_gather_launch(const void* zipped, const void* rows, void* out,
                                     long long n_take, long long stride, int route, int word,
                                     int grid, void* counter, int device, void* stream) {
  if (n_take <= 0 || stride <= 0 || grid <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t align = reinterpret_cast<uintptr_t>(zipped) | reinterpret_cast<uintptr_t>(out) |
                          static_cast<uintptr_t>(stride);
  DeviceGuard guard(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* z = static_cast<const uint8_t*>(zipped);
  const int32_t* r = static_cast<const int32_t*>(rows);
  uint8_t* o = static_cast<uint8_t*>(out);
  if (route == kRouteBulk) {
    if (align % 16 != 0) return static_cast<int>(cudaErrorMisalignedAddress);
    static bool smem_set[64] = {};
    if (device < 0 || device >= 64) return static_cast<int>(cudaErrorInvalidDevice);
    const int smem = kStages * kStageBytes;
    if (!smem_set[device]) {
      cudaError_t e = cudaFuncSetAttribute(gather_bulk_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return static_cast<int>(e);
      smem_set[device] = true;
    }
    const int64_t n_units =
        stride <= kStageBytes
            ? (n_take + min(static_cast<long long>(kMaxRowsPerUnit), kStageBytes / stride) - 1) /
                  min(static_cast<long long>(kMaxRowsPerUnit), kStageBytes / stride)
            : n_take * ((stride + kStageBytes - 1) / kStageBytes);
    unsigned long long* next_unit = static_cast<unsigned long long*>(counter);
    if (next_unit == nullptr || reinterpret_cast<uintptr_t>(next_unit) % 8 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t e = cudaMemsetAsync(next_unit, 0, sizeof(*next_unit), s);
    if (e != cudaSuccess) return static_cast<int>(e);
    gather_bulk_kernel<<<grid, 32, smem, s>>>(z, r, o, n_take, stride, n_units, next_unit);
  } else if (route == kRouteRegister) {
    if (word <= 0 || word > 16 || (word & (word - 1)) || align % word != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    switch (word) {
      case 16: gather_register_kernel<uint4><<<grid, 32, 0, s>>>(z, r, o, n_take, stride); break;
      case 8: gather_register_kernel<uint2><<<grid, 32, 0, s>>>(z, r, o, n_take, stride); break;
      case 4: gather_register_kernel<uint32_t><<<grid, 32, 0, s>>>(z, r, o, n_take, stride); break;
      case 2: gather_register_kernel<uint16_t><<<grid, 32, 0, s>>>(z, r, o, n_take, stride); break;
      default: gather_register_kernel<uint8_t><<<grid, 32, 0, s>>>(z, r, o, n_take, stride); break;
    }
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
