// Batched squared-L2 distance + deterministic top-k for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ivf_topk.py, ivf_topk_pallas:
// for Q queries against N candidates of dimension D (float32), distances
// d = (qq - 2 * q.c) + cc in IEEE fp32; candidates masked out for a query
// score (inf, sentinel); per query, the k smallest *distinct* (distance, id)
// pairs in lexicographic order, padded with (inf, 2^31 - 1).  That is what
// the TPU kernel's k masked-argmin sweeps compute: each sweep takes the
// smallest distance, the lowest id among equal distances, and removes every
// entry equal to that pair.  A NaN distance of an eligible candidate wins
// every sweep there and equals nothing, so the query's whole row reads
// (nan, sentinel); here a per-query flag reproduces that.
//
// What bounds it: bytes.  It reads the (N, D) candidate matrix once per group
// of up to 8 queries, the (Q, N) mask and the ids: about 1.62 GB at Q = 4,
// N = 1,048,576, D = 384 (0.48 ms at 3.35 TB/s), against 2 * Q * N * D =
// 3.2 GFLOP of fp32 products (0.048 ms at 67 TFLOP/s outside the tensor
// cores, which are not used: TF32 would break the rounding contract).
//
// Design.  The TPU kernel holds the whole candidate matrix in VMEM and sweeps
// it k times; the search path gives this kernel up to 1.6 GB, so it streams:
//   1. score pass: persistent blocks of 256 threads, about one per SM for
//      each group of up to 8 queries (QG, a template parameter), each owning
//      a contiguous range of 256-row tiles of candidates.  A ring of up to 4
//      shared-memory stages, filled by cp.async (16 bytes per lane where
//      D % 4 == 0 and the matrix is 16-byte aligned, else 4), holds 32-float
//      column chunks of the tile's rows and the same chunk of the group's
//      queries; the next stages load while one is scored.  Thread t owns row
//      t: it reads its chunk as 16-byte shared loads (rows padded to 36
//      floats, so the 8 lanes of a load phase hit 8 different bank quads)
//      and the query values as broadcasts, and keeps 4 partial dots per
//      query and 4 partial norms in registers across the chunks; no shuffles.
//      At a tile's last chunk each eligible (query, row) pair strictly less
//      than the query's running threshold (the k-th best distinct pair so
//      far) is appended to the query's survivor buffer in shared memory.
//      When a buffer could not take another tile, the block bitonic-sorts
//      the buffers, keeps the first k distinct pairs and lowers each
//      threshold to the k-th.  After its last tile the block emits one list
//      of k pairs per query (or, as the only block of its group, the final
//      rows).
//   2. merge passes, one CTA per (group of lists, query), until one list
//      per query is left (about 132 lists at k = 10 take one pass).  Of up
//      to 4,096 pairs (at least 4 lists of k), only those no greater than
//      the least k-th pair of a list can be selected; those are sorted and
//      the first k distinct kept.  A pair duplicated across blocks collapses
//      there, so the tie-break and the dedup survive the split.
// The launcher (ops.ivf_plan) sizes the grid, the survivor buffers (a power
// of two >= k + 256), the ring depth that fits beside them and the lists.
// Rounding: every product and sum goes through the _rn intrinsics, so nvcc's
// default -fmad=true cannot contract (qq - 2 * dot) into an FMA, and no
// TF32 or tensor-core product is used.  The order of the dot's and the
// norms' accumulation is the one free choice: 4 interleaved partial sums
// (element d goes to partial d % 4), combined pairwise.  It differs from
// PyTorch's and XLA's orders by about an ulp of the terms, so the winners of
// a near tie may differ from the plain version's.

#include <cstdint>
#include <cuda_runtime.h>

#include "device_guard.cuh"

namespace {

constexpr int kThreads = 256;             // score CTA; one candidate row each
constexpr int kTileRows = kThreads;       // rows per tile
constexpr int kChunk = 32;                // floats of a row per stage
constexpr int kRowStride = kChunk + 4;    // padded row, in floats
constexpr int kQMax = 8;                  // queries per group
constexpr int kStageFloats = kTileRows * kRowStride + kChunk * kQMax;
constexpr int kMinStages = 2, kMaxStages = 4;
constexpr int kSmemMax = 227 * 1024;      // dynamic + static per block
constexpr int kSort = 4096;               // pairs a merge CTA sorts at once
constexpr int kMergeThreads = 512;
constexpr int32_t kSentinel = 0x7fffffff;

__device__ __forceinline__ bool pair_less(float da, int32_t ia, float db, int32_t ib) {
  return da < db || (da == db && ia < ib);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sort `segs` segments of `n` pairs each (n a power of two), segment s at
// offset s * seg_stride, ascending by (distance, id).  Every thread of the
// block takes part.
__device__ void bitonic_sort(float* d, int32_t* id, int n, int segs, int seg_stride) {
  const int half = n >> 1;
  const int total = segs * half;
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < total; t += blockDim.x) {
        const int seg = t / half;
        const int r = t - seg * half;
        const int lo = 2 * stride * (r / stride) + (r % stride);
        const bool up = (lo & size) == 0;
        const int i = seg * seg_stride + lo;
        const int j = i + stride;
        const float di = d[i], dj = d[j];
        const int32_t ii = id[i], ij = id[j];
        if (up ? pair_less(dj, ij, di, ii) : pair_less(di, ii, dj, ij)) {
          d[i] = dj; d[j] = di;
          id[i] = ij; id[j] = ii;
        }
      }
      __syncthreads();
    }
  }
}

// One warp: write the first k distinct pairs of a sorted run of n pairs to
// out (which may be the run itself: a pair moves only down, to its rank),
// padded with (inf, sentinel) when `pad`.  Returns the number of distinct
// pairs written (at most k).
__device__ int emit_distinct(const float* d, const int32_t* id, int n, int k, float* out_d,
                             int32_t* out_i, bool pad) {
  const int lane = threadIdx.x & 31;
  int count = 0;  // warp-uniform
  for (int base = 0; base < n && count < k; base += 32) {
    const int r = base + lane;
    const float dv = r < n ? d[r] : 0.f;
    const int32_t iv = r < n ? id[r] : 0;
    const bool fresh = r < n && (r == 0 || dv != d[r - 1] || iv != id[r - 1]);
    const unsigned ballot = __ballot_sync(0xffffffffu, fresh);
    __syncwarp();  // every lane has read its pairs before any lane writes
    const int rank = count + __popc(ballot & ((1u << lane) - 1u));
    if (fresh && rank < k) {
      out_d[rank] = dv;
      out_i[rank] = iv;
    }
    count += __popc(ballot);
    __syncwarp();
  }
  count = min(count, k);
  if (pad) {
    for (int r = count + lane; r < k; r += 32) {
      out_d[r] = __int_as_float(0x7f800000);
      out_i[r] = kSentinel;
    }
  }
  __syncwarp();
  return count;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most stages - 2 groups are pending
__device__ __forceinline__ void cp_async_wait_ring(int stages) {
  if (stages >= 4) asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else if (stages == 3) asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Keep each query's first k distinct pairs of its buffer, sorted at its
// front, and lower its threshold to the k-th of them.
template <int QG>
__device__ void flush(float* buf_d, int32_t* buf_i, int buf, int nq, int k, int* cnt,
                      float* thr_d, int32_t* thr_i) {
  int most = 1;
  for (int j = 0; j < nq; ++j) most = max(most, cnt[j]);
  int n = 1;
  while (n < most) n <<= 1;
  for (int e = threadIdx.x; e < QG * n; e += blockDim.x) {
    const int j = e / n, p = e - j * n;
    if (j >= nq || p >= cnt[j]) {
      buf_d[j * buf + p] = __int_as_float(0x7f800000);
      buf_i[j * buf + p] = kSentinel;
    }
  }
  __syncthreads();
  bitonic_sort(buf_d, buf_i, n, nq, buf);
  for (int j = threadIdx.x >> 5; j < nq; j += blockDim.x >> 5) {
    float* d = buf_d + j * buf;
    int32_t* id = buf_i + j * buf;
    const int kept = emit_distinct(d, id, n, k, d, id, false);
    if ((threadIdx.x & 31) == 0) {
      cnt[j] = kept;
      if (kept == k) {
        thr_d[j] = d[k - 1];
        thr_i[j] = id[k - 1];
      }
    }
  }
  __syncthreads();
}

// A pass's lists: per query, n_lists lists of k pairs; pair p of list l of
// query q sits at (q * n_lists + l) * k + p of list_d (distances) and list_i
// (ids).  With one block per group (gridDim.x == 1) the block writes the
// final (Q, k) rows to list_d / list_i instead.
template <int QG, bool kVec16>
__global__ void __launch_bounds__(kThreads, 1)
ivf_score_kernel(const float* __restrict__ q, const float* __restrict__ c,
                 const int32_t* __restrict__ ids, const uint8_t* __restrict__ mask,
                 int32_t* __restrict__ nan_flags, float* __restrict__ list_d,
                 int32_t* __restrict__ list_i, int Q, int N, int D, int k, int tiles_per_block,
                 int buf, int stages) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float s_qq[kQMax], s_thr_d[kQMax];
  __shared__ int32_t s_thr_i[kQMax];
  __shared__ int s_cnt[kQMax], s_nan[kQMax];
  float* ring = smem;
  float* buf_d = smem + stages * kStageFloats;
  int32_t* buf_i = reinterpret_cast<int32_t*>(buf_d + QG * buf);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.y * QG;
  const int nq = min(QG, Q - q0);
  const int n_tiles = (N + kTileRows - 1) / kTileRows;
  const int t0 = blockIdx.x * tiles_per_block;
  const int t1 = min(n_tiles, t0 + tiles_per_block);
  const int n_chunks = (D + kChunk - 1) / kChunk;
  const int G = max(0, t1 - t0) * n_chunks;  // stages this block scores

  if (warp < nq) {
    const int j = warp;
    const float* qr = q + static_cast<size_t>(q0 + j) * D;
    float acc = 0.f;
    for (int t = lane; t < D; t += 32) {
      const float x = __ldg(qr + t);
      acc = __fadd_rn(acc, __fmul_rn(x, x));
    }
    acc = warp_sum(acc);
    if (lane == 0) s_qq[j] = acc;
  }
  if (tid < kQMax) {
    s_thr_d[tid] = __int_as_float(0x7f800000);
    s_thr_i[tid] = kSentinel;
    s_cnt[tid] = 0;
    s_nan[tid] = 0;
  }

  // stage g = (tile t0 + g / n_chunks, column chunk g % n_chunks)
  auto load = [&](int g) {
    if (g < G) {
      float* st = ring + (g % stages) * kStageFloats;
      const int row0 = (t0 + g / n_chunks) * kTileRows;
      const int d0 = (g % n_chunks) * kChunk;
      if (kVec16) {
#pragma unroll
        for (int m = 0; m < kTileRows * kChunk / 4 / kThreads; ++m) {
          const int e = tid + m * kThreads;
          const int r = e >> 3, col = d0 + (e & 7) * 4;
          const bool ok = row0 + r < N && col < D;
          cp_async16(st + r * kRowStride + (e & 7) * 4,
                     ok ? c + static_cast<size_t>(row0 + r) * D + col : c, ok);
        }
      } else {
#pragma unroll 4
        for (int m = 0; m < kTileRows * kChunk / kThreads; ++m) {
          const int e = tid + m * kThreads;
          const int r = e >> 5, col = d0 + (e & 31);
          const bool ok = row0 + r < N && col < D;
          cp_async4(st + r * kRowStride + (e & 31),
                    ok ? c + static_cast<size_t>(row0 + r) * D + col : c, ok);
        }
      }
      // the group's queries, transposed to [chunk column][query]
      const int dq = tid / kQMax, j = tid % kQMax;
      const bool ok = j < nq && d0 + dq < D;
      cp_async4(st + kTileRows * kRowStride + tid,
                ok ? q + static_cast<size_t>(q0 + j) * D + d0 + dq : q, ok);
    }
    cp_async_commit();  // an empty group keeps the count uniform
  };

  for (int g = 0; g < stages - 1; ++g) load(g);

  float dot[QG][4], cc[4];
  int32_t my_id = kSentinel;
  bool elig[QG];
  for (int g = 0; g < G; ++g) {
    cp_async_wait_ring(stages);
    __syncthreads();  // stage g landed; stage g - 1 is free for stage g + stages - 1
    load(g + stages - 1);
    const int ch = g % n_chunks;
    const int n = (t0 + g / n_chunks) * kTileRows + tid;
    if (ch == 0) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        cc[e] = 0.f;
#pragma unroll
        for (int j = 0; j < QG; ++j) dot[j][e] = 0.f;
      }
      // loaded now, used at the tile's last chunk
      my_id = n < N ? ids[n] : kSentinel;
#pragma unroll
      for (int j = 0; j < QG; ++j)
        elig[j] = n < N && j < nq &&
                  (mask == nullptr || mask[static_cast<size_t>(q0 + j) * N + n] != 0);
    }
    const float* st = ring + (g % stages) * kStageFloats;
    const float* qs = st + kTileRows * kRowStride;
#pragma unroll
    for (int f = 0; f < kChunk / 4; ++f) {
      const float4 x4 = reinterpret_cast<const float4*>(st + tid * kRowStride)[f];
      const float xs[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = xs[e];
        const float* qd = qs + (f * 4 + e) * kQMax;
        cc[e] = __fadd_rn(cc[e], __fmul_rn(x, x));
        if constexpr (QG >= 4) {
#pragma unroll
          for (int h = 0; h < QG / 4; ++h) {
            const float4 qv = reinterpret_cast<const float4*>(qd)[h];
            dot[4 * h + 0][e] = __fmaf_rn(qv.x, x, dot[4 * h + 0][e]);
            dot[4 * h + 1][e] = __fmaf_rn(qv.y, x, dot[4 * h + 1][e]);
            dot[4 * h + 2][e] = __fmaf_rn(qv.z, x, dot[4 * h + 2][e]);
            dot[4 * h + 3][e] = __fmaf_rn(qv.w, x, dot[4 * h + 3][e]);
          }
        } else {
#pragma unroll
          for (int j = 0; j < QG; ++j) dot[j][e] = __fmaf_rn(qd[j], x, dot[j][e]);
        }
      }
    }
    if (ch != n_chunks - 1) continue;

    // the tile's last chunk: distances, then the threshold filter
    const float norm = __fadd_rn(__fadd_rn(cc[0], cc[1]), __fadd_rn(cc[2], cc[3]));
#pragma unroll
    for (int j = 0; j < QG; ++j) {
      if (!elig[j]) continue;
      const float dt = __fadd_rn(__fadd_rn(dot[j][0], dot[j][1]), __fadd_rn(dot[j][2], dot[j][3]));
      const float dist = __fadd_rn(__fsub_rn(s_qq[j], __fmul_rn(2.f, dt)), norm);
      if (dist != dist) {
        s_nan[j] = 1;  // the row becomes (nan, sentinel) at the end
      } else if (pair_less(dist, my_id, s_thr_d[j], s_thr_i[j])) {
        const int p = atomicAdd(&s_cnt[j], 1);
        buf_d[j * buf + p] = dist;
        buf_i[j * buf + p] = my_id;
      }
    }
    __syncthreads();
    bool full = false;
    for (int j = 0; j < nq; ++j) full |= s_cnt[j] + kTileRows > buf;
    if (full) flush<QG>(buf_d, buf_i, buf, nq, k, s_cnt, s_thr_d, s_thr_i);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  flush<QG>(buf_d, buf_i, buf, nq, k, s_cnt, s_thr_d, s_thr_i);

  if (warp < nq) {
    const int j = warp;
    const int qi = q0 + j;
    const float* d = buf_d + j * buf;
    const int32_t* id = buf_i + j * buf;
    if (gridDim.x == 1) {  // the only block of its group: the final row
      float* od = list_d + static_cast<size_t>(qi) * k;
      int32_t* oi = list_i + static_cast<size_t>(qi) * k;
      if (s_nan[j]) {
        for (int r = lane; r < k; r += 32) {
          od[r] = __int_as_float(0x7fc00000);
          oi[r] = kSentinel;
        }
      } else {
        emit_distinct(d, id, s_cnt[j], k, od, oi, true);
      }
    } else {
      const size_t at = (static_cast<size_t>(qi) * gridDim.x + blockIdx.x) * k;
      emit_distinct(d, id, s_cnt[j], k, list_d + at, list_i + at, true);
      if (lane == 0 && s_nan[j]) nan_flags[qi] = 1;
    }
  }
}

// One CTA per (group of up to fan_in lists, query).  The k-th pair of any
// full list bounds the group's k-th distinct pair, so only pairs no greater
// than the least such bound T can be selected: those are gathered, sorted
// and cut to the first k distinct ones.
__global__ void __launch_bounds__(kMergeThreads)
ivf_merge_kernel(const float* __restrict__ in_d, const int32_t* __restrict__ in_i,
                 int n_lists, int fan_in, int k, const int32_t* __restrict__ nan_flags,
                 float* __restrict__ out_d, int32_t* __restrict__ out_i, int final_pass) {
  __shared__ float s_d[kSort];
  __shared__ int32_t s_i[kSort];
  __shared__ float s_td;
  __shared__ int32_t s_ti;
  __shared__ int s_n;
  const int g = blockIdx.x;
  const int n_groups = gridDim.x;
  const int qi = blockIdx.y;
  const int l0 = g * fan_in;
  const int nl = min(fan_in, n_lists - l0);
  const size_t src = (static_cast<size_t>(qi) * n_lists + l0) * k;
  const size_t dst = (static_cast<size_t>(qi) * n_groups + g) * k;
  if (final_pass && nan_flags[qi]) {
    for (int r = threadIdx.x; r < k; r += kMergeThreads) {
      out_d[dst + r] = __int_as_float(0x7fc00000);
      out_i[dst + r] = kSentinel;
    }
    return;
  }
  if (threadIdx.x < 32) {
    float td = __int_as_float(0x7f800000);
    int32_t ti = kSentinel;
    for (int l = threadIdx.x; l < nl; l += 32) {
      const float d = in_d[src + static_cast<size_t>(l) * k + k - 1];
      const int32_t i = in_i[src + static_cast<size_t>(l) * k + k - 1];
      if (pair_less(d, i, td, ti)) { td = d; ti = i; }
    }
    for (int o = 16; o > 0; o >>= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, td, o);
      const int32_t oi = __shfl_xor_sync(0xffffffffu, ti, o);
      if (pair_less(od, oi, td, ti)) { td = od; ti = oi; }
    }
    if (threadIdx.x == 0) {
      s_td = td;
      s_ti = ti;
      s_n = 0;
    }
  }
  __syncthreads();
  const float td = s_td;
  const int32_t ti = s_ti;
  for (int e = threadIdx.x; e < nl * k; e += kMergeThreads) {
    const float d = in_d[src + e];
    const int32_t i = in_i[src + e];
    if (!pair_less(td, ti, d, i)) {  // (d, i) <= T
      const int p = atomicAdd(&s_n, 1);
      s_d[p] = d;
      s_i[p] = i;
    }
  }
  __syncthreads();
  const int m = s_n;
  int n = 1;
  while (n < m) n <<= 1;
  for (int e = m + threadIdx.x; e < n; e += kMergeThreads) {
    s_d[e] = __int_as_float(0x7f800000);
    s_i[e] = kSentinel;
  }
  __syncthreads();
  bitonic_sort(s_d, s_i, n, 1, n);
  if (threadIdx.x < 32) emit_distinct(s_d, s_i, m, k, out_d + dst, out_i + dst, true);
}

template <int QG, bool kVec16>
cudaError_t launch_score(dim3 grid, int smem, cudaStream_t s, int device, const float* q,
                         const float* c, const int32_t* ids, const uint8_t* mask, int32_t* nan,
                         float* ld, int32_t* li, int Q, int N, int D, int k, int tpb, int buf,
                         int stages) {
  static bool smem_set[64] = {};  // per device, set on the first launch
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (!smem_set[device]) {
    cudaError_t e = cudaFuncSetAttribute(ivf_score_kernel<QG, kVec16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSmemMax - 1024);
    if (e != cudaSuccess) return e;
    smem_set[device] = true;
  }
  ivf_score_kernel<QG, kVec16><<<grid, kThreads, smem, s>>>(
      q, c, ids, mask, nan, ld, li, Q, N, D, k, tpb, buf, stages);
  return cudaGetLastError();
}

}  // namespace

// Launch the scoring pass and the merge passes on `stream` of `device`, as
// planned by ops.ivf_plan: `qg` queries per group (1, 2, 4 or 8), `blocks`
// score blocks per group of `tiles_per_block` 256-row tiles each, survivor
// buffers of `buf` pairs per query (a power of two >= k + 256) and a ring of
// `stages` stages.  `list_a` holds Q * blocks * k pairs and `list_b` Q *
// ceil(blocks / fan_in) * k (fan_in = 4096 / k) where more than one merge
// pass runs, each pair 8 bytes; `nan_flags` holds Q ints.  Returns the first
// CUDA error (0 on success).
extern "C" int ivf_topk_launch(const void* queries, const void* cands, const void* ids,
                               const void* mask, void* nan_flags, void* list_a, void* list_b,
                               void* out_d, void* out_i, int Q, int N, int D, int k, int qg,
                               int blocks, int tiles_per_block, int buf, int stages, int device,
                               void* stream) {
  const int n_tiles = (N + kTileRows - 1) / kTileRows;
  const long long smem =
      static_cast<long long>(stages) * kStageFloats * 4 + 8LL * qg * buf;
  if (Q <= 0 || N <= 0 || D <= 0 || k <= 0 || 4 * k > kSort ||
      (qg != 1 && qg != 2 && qg != 4 && qg != 8) || blocks <= 0 || tiles_per_block <= 0 ||
      static_cast<long long>(blocks) * tiles_per_block < n_tiles ||
      static_cast<long long>(blocks - 1) * tiles_per_block >= n_tiles || buf < k + kTileRows ||
      (buf & (buf - 1)) || stages < kMinStages || stages > kMaxStages ||
      smem > kSmemMax - 1024 || (Q + qg - 1) / qg > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  DeviceGuard guard(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaSuccess;
  const int fan_in = kSort / k;
  // each list buffer is split into a distance half and an id half
  auto halves = [&](void* b, size_t pairs, float** d, int32_t** i) {
    *d = static_cast<float*>(b);
    *i = reinterpret_cast<int32_t*>(static_cast<float*>(b) + pairs);
  };
  float* a_d = nullptr; int32_t* a_i = nullptr; float* b_d = nullptr; int32_t* b_i = nullptr;
  if (blocks > 1) {
    e = cudaMemsetAsync(nan_flags, 0, sizeof(int32_t) * Q, s);
    if (e != cudaSuccess) return static_cast<int>(e);
    halves(list_a, static_cast<size_t>(Q) * blocks * k, &a_d, &a_i);
    halves(list_b, static_cast<size_t>(Q) * ((blocks + fan_in - 1) / fan_in) * k, &b_d, &b_i);
  } else {  // one block per group writes the final rows
    a_d = static_cast<float*>(out_d);
    a_i = static_cast<int32_t*>(out_i);
  }
  const bool vec16 = D % 4 == 0 && reinterpret_cast<uintptr_t>(cands) % 16 == 0;
  const dim3 grid(blocks, (Q + qg - 1) / qg);
  const float* qp = static_cast<const float*>(queries);
  const float* cp = static_cast<const float*>(cands);
  const int32_t* ip = static_cast<const int32_t*>(ids);
  const uint8_t* mp = static_cast<const uint8_t*>(mask);
  int32_t* np_ = static_cast<int32_t*>(nan_flags);
#define IVF_SCORE(QGV)                                                                        \
  e = vec16 ? launch_score<QGV, true>(grid, static_cast<int>(smem), s, device, qp, cp, ip, mp, \
                                      np_, a_d, a_i, Q, N, D, k, tiles_per_block, buf, stages) \
            : launch_score<QGV, false>(grid, static_cast<int>(smem), s, device, qp, cp, ip, mp, \
                                       np_, a_d, a_i, Q, N, D, k, tiles_per_block, buf, stages)
  switch (qg) {
    case 1: IVF_SCORE(1); break;
    case 2: IVF_SCORE(2); break;
    case 4: IVF_SCORE(4); break;
    default: IVF_SCORE(8); break;
  }
#undef IVF_SCORE
  if (e != cudaSuccess || blocks == 1) return static_cast<int>(e);
  int n_lists = blocks;
  bool in_a = true;
  for (;;) {
    const int n_groups = (n_lists + fan_in - 1) / fan_in;
    const bool final_pass = n_groups == 1;
    float* dst_d = final_pass ? static_cast<float*>(out_d) : (in_a ? b_d : a_d);
    int32_t* dst_i = final_pass ? static_cast<int32_t*>(out_i) : (in_a ? b_i : a_i);
    ivf_merge_kernel<<<dim3(n_groups, Q), kMergeThreads, 0, s>>>(
        in_a ? a_d : b_d, in_a ? a_i : b_i, n_lists, fan_in, k,
        static_cast<const int32_t*>(nan_flags), dst_d, dst_i, final_pass ? 1 : 0);
    e = cudaGetLastError();
    if (e != cudaSuccess || final_pass) return static_cast<int>(e);
    n_lists = n_groups;
    in_a = !in_a;
  }
}
