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
// of 8 queries, the (Q, N) mask and the ids: about 1.07 GB at Q = 8,
// N = 690k, D = 384 (0.32 ms at 3.35 TB/s), against 2 * Q * N * D = 4.2
// GFLOP of fp32 products (0.063 ms at 67 TFLOP/s outside the tensor cores).
//
// Design.  The TPU kernel holds the whole candidate matrix in VMEM and sweeps
// it k times; the search path gives this kernel up to a million candidates
// (1.6 GB), so the candidate axis is tiled instead:
//   1. score pass, one CTA per (tile of 512 candidates, group of 8 queries):
//      one warp per candidate row, its lanes striding over D with the query
//      values read through the read-only cache, so each row is read once
//      for all 8 queries; the 9 sums (8 dots, cc) are reduced by butterfly
//      shuffles.  The 8 x 512 (distance, id) pairs, with the mask applied,
//      are bitonic-sorted in shared memory, and warp j writes the first k
//      distinct pairs of query j as this tile's list.
//   2. merge passes, one CTA per (group of lists, query): load up to 4,096
//      pairs (at least 4 lists of k), sort, keep the first k distinct, until
//      one list per query is left.  A pair duplicated across tiles collapses
//      there, so the tie-break and the dedup survive the merge.
// Rounding: every product and sum goes through the _rn intrinsics, so nvcc's
// default -fmad=true cannot contract (qq - 2 * dot) into an FMA, and no
// TF32 or tensor-core product is used.  The order of the dot's and the
// norms' accumulation is the one free choice: lane-strided sums (FMAs in
// the dot only), then a butterfly.  It differs from PyTorch's and XLA's
// orders by about an ulp at D >= 128, so the winners of a near tie may
// differ from the plain version's.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kQG = 8;               // queries per score CTA (= warps)
constexpr int kTile = 512;           // candidates per score CTA
constexpr int kScoreThreads = kQG * 32;
constexpr int kSort = 4096;          // pairs a merge CTA sorts at once
constexpr int kMergeThreads = 512;
constexpr int32_t kSentinel = 0x7fffffff;

__device__ __forceinline__ bool pair_less(float da, int32_t ia, float db, int32_t ib) {
  return da < db || (da == db && ia < ib);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sort `segs` segments of `n` pairs each (n a power of two) in shared memory,
// ascending by (distance, id).  Every thread of the block takes part.
__device__ void bitonic_sort(float* d, int32_t* id, int n, int segs) {
  const int half = n >> 1;
  const int total = segs * half;
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < total; t += blockDim.x) {
        const int seg = t / half;
        const int r = t - seg * half;
        const int lo = 2 * stride * (r / stride) + (r % stride);
        const bool up = (lo & size) == 0;
        const int i = seg * n + lo;
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

// One warp: write the first k distinct pairs of a sorted run of n pairs,
// padded with (inf, sentinel).
__device__ void emit_distinct(const float* d, const int32_t* id, int n, int k,
                              float* out_d, int32_t* out_i) {
  const int lane = threadIdx.x & 31;
  int count = 0;  // warp-uniform
  for (int base = 0; base < n && count < k; base += 32) {
    const int r = base + lane;
    const bool fresh = r < n && (r == 0 || d[r] != d[r - 1] || id[r] != id[r - 1]);
    const unsigned ballot = __ballot_sync(0xffffffffu, fresh);
    const int rank = count + __popc(ballot & ((1u << lane) - 1u));
    if (fresh && rank < k) {
      out_d[rank] = d[r];
      out_i[rank] = id[r];
    }
    count += __popc(ballot);
  }
  for (int r = count + lane; r < k; r += 32) {
    out_d[r] = __int_as_float(0x7f800000);
    out_i[r] = kSentinel;
  }
}

// A pass's lists: per query, n_lists lists of k pairs; pair p of list l of
// query q sits at (q * n_lists + l) * k + p of list_d (distances) and list_i
// (ids).
__global__ void __launch_bounds__(kScoreThreads)
ivf_score_kernel(const float* __restrict__ q, const float* __restrict__ c,
                 const int32_t* __restrict__ ids, const uint8_t* __restrict__ mask,
                 int32_t* __restrict__ nan_flags, float* __restrict__ list_d,
                 int32_t* __restrict__ list_i, int Q, int N, int D, int k) {
  __shared__ float s_d[kQG * kTile];
  __shared__ int32_t s_i[kQG * kTile];
  __shared__ float s_qq[kQG];
  const int tile = blockIdx.x;
  const int n_tiles = gridDim.x;
  const int q0 = blockIdx.y * kQG;
  const int nq = min(kQG, Q - q0);
  const int n0 = tile * kTile;
  const int nc = min(kTile, N - n0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float* qb = q + static_cast<size_t>(q0) * D;

  if (warp < nq) {
    const float* qr = qb + static_cast<size_t>(warp) * D;
    float acc = 0.f;
    for (int t = lane; t < D; t += 32) {
      const float x = __ldg(qr + t);
      acc = __fadd_rn(acc, __fmul_rn(x, x));
    }
    acc = warp_sum(acc);
    if (lane == 0) s_qq[warp] = acc;
  }
  __syncthreads();

  for (int r = warp; r < nc; r += kQG) {
    const float* cr = c + static_cast<size_t>(n0 + r) * D;
    float dot[kQG];
#pragma unroll
    for (int j = 0; j < kQG; ++j) dot[j] = 0.f;
    float cc = 0.f;
    for (int t = lane; t < D; t += 32) {
      const float x = __ldg(cr + t);
      cc = __fadd_rn(cc, __fmul_rn(x, x));
#pragma unroll
      for (int j = 0; j < kQG; ++j)
        if (j < nq) dot[j] = __fmaf_rn(__ldg(qb + static_cast<size_t>(j) * D + t), x, dot[j]);
    }
    cc = warp_sum(cc);
    float mine = 0.f;
#pragma unroll
    for (int j = 0; j < kQG; ++j) {
      const float s = warp_sum(dot[j]);
      if (lane == j) mine = s;
    }
    if (lane < nq)
      s_d[lane * kTile + r] =
          __fadd_rn(__fsub_rn(s_qq[lane], __fmul_rn(2.f, mine)), cc);
  }
  __syncthreads();

  for (int e = threadIdx.x; e < kQG * kTile; e += kScoreThreads) {
    const int j = e / kTile;
    const int r = e - j * kTile;
    float dv = __int_as_float(0x7f800000);
    int32_t iv = kSentinel;
    if (j < nq && r < nc &&
        (mask == nullptr || mask[static_cast<size_t>(q0 + j) * N + n0 + r] != 0)) {
      const float x = s_d[e];
      if (x != x) {
        nan_flags[q0 + j] = 1;  // the row becomes (nan, sentinel) at the end
      } else {
        dv = x;
        iv = ids[n0 + r];
      }
    }
    s_d[e] = dv;
    s_i[e] = iv;
  }
  __syncthreads();
  bitonic_sort(s_d, s_i, kTile, kQG);
  if (warp < nq) {
    const size_t at = (static_cast<size_t>(q0 + warp) * n_tiles + tile) * k;
    emit_distinct(s_d + warp * kTile, s_i + warp * kTile, kTile, k, list_d + at, list_i + at);
  }
}

__global__ void __launch_bounds__(kMergeThreads)
ivf_merge_kernel(const float* __restrict__ in_d, const int32_t* __restrict__ in_i,
                 int n_lists, int fan_in, int sort_n, int k,
                 const int32_t* __restrict__ nan_flags, float* __restrict__ out_d,
                 int32_t* __restrict__ out_i, int final_pass) {
  __shared__ float s_d[kSort];
  __shared__ int32_t s_i[kSort];
  const int g = blockIdx.x;
  const int n_groups = gridDim.x;
  const int qi = blockIdx.y;
  const int l0 = g * fan_in;
  const int nl = min(fan_in, n_lists - l0);
  const size_t src = (static_cast<size_t>(qi) * n_lists + l0) * k;
  for (int e = threadIdx.x; e < sort_n; e += kMergeThreads) {
    if (e < nl * k) {
      s_d[e] = in_d[src + e];
      s_i[e] = in_i[src + e];
    } else {
      s_d[e] = __int_as_float(0x7f800000);
      s_i[e] = kSentinel;
    }
  }
  __syncthreads();
  bitonic_sort(s_d, s_i, sort_n, 1);
  if (threadIdx.x >= 32) return;
  const size_t dst = (static_cast<size_t>(qi) * n_groups + g) * k;
  if (final_pass && nan_flags[qi]) {
    for (int r = threadIdx.x; r < k; r += 32) {
      out_d[dst + r] = __int_as_float(0x7fc00000);
      out_i[dst + r] = kSentinel;
    }
    return;
  }
  emit_distinct(s_d, s_i, sort_n, k, out_d + dst, out_i + dst);
}

int next_pow2(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

}  // namespace

// Launch the scoring pass and the merge passes on `stream`.  `list_a` holds
// Q * ceil(N / tile) * k pairs, `list_b` Q * ceil(ceil(N / tile) / fan_in) * k
// (fan_in = sort / k), each pair 8 bytes; `nan_flags` holds Q ints.  `tile`
// and `sort` must be this file's kTile and kSort (the wrapper sizes the lists
// with them).  Returns the first CUDA error (0 on success).
extern "C" int ivf_topk_launch(const void* queries, const void* cands, const void* ids,
                               const void* mask, void* nan_flags, void* list_a,
                               void* list_b, void* out_d, void* out_i, int Q, int N,
                               int D, int k, int tile, int sort, void* stream) {
  if (Q <= 0 || Q > 65535 || N <= 0 || D <= 0 || k <= 0 || 4 * k > kSort ||
      tile != kTile || sort != kSort)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(nan_flags, 0, sizeof(int32_t) * Q, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_tiles = (N + kTile - 1) / kTile;
  // each list buffer is split into a distance half and an id half
  auto halves = [&](void* buf, size_t pairs, float** d, int32_t** i) {
    *d = static_cast<float*>(buf);
    *i = reinterpret_cast<int32_t*>(static_cast<float*>(buf) + pairs);
  };
  const int fan_in = kSort / k;
  float* a_d; int32_t* a_i; float* b_d; int32_t* b_i;
  halves(list_a, static_cast<size_t>(Q) * n_tiles * k, &a_d, &a_i);
  halves(list_b, static_cast<size_t>(Q) * ((n_tiles + fan_in - 1) / fan_in) * k, &b_d, &b_i);
  ivf_score_kernel<<<dim3(n_tiles, (Q + kQG - 1) / kQG), kScoreThreads, 0, s>>>(
      static_cast<const float*>(queries), static_cast<const float*>(cands),
      static_cast<const int32_t*>(ids), static_cast<const uint8_t*>(mask),
      static_cast<int32_t*>(nan_flags), a_d, a_i, Q, N, D, k);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  int n_lists = n_tiles;
  bool in_a = true;
  for (;;) {
    const int n_groups = (n_lists + fan_in - 1) / fan_in;
    const bool final_pass = n_groups == 1;
    const int sort_n = next_pow2(std::min(fan_in, n_lists) * k);
    float* dst_d = final_pass ? static_cast<float*>(out_d) : (in_a ? b_d : a_d);
    int32_t* dst_i = final_pass ? static_cast<int32_t*>(out_i) : (in_a ? b_i : a_i);
    ivf_merge_kernel<<<dim3(n_groups, Q), kMergeThreads, 0, s>>>(
        in_a ? a_d : b_d, in_a ? a_i : b_i, n_lists, fan_in, sort_n, k,
        static_cast<const int32_t*>(nan_flags), dst_d, dst_i, final_pass ? 1 : 0);
    e = cudaGetLastError();
    if (e != cudaSuccess || final_pass) return static_cast<int>(e);
    n_lists = n_groups;
    in_a = !in_a;
  }
}
