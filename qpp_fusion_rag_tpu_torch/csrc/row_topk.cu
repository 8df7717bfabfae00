// Exact row top-k of f32 rows: the dense merge of the packed group maxima.
//
// Replaces no TPU kernel. The JAX package merges its dense kernels' group
// maxima with lax.top_k (or lax.approx_max_k), which XLA lowers on the TPU
// by itself. The port merged them with ops/segment.py:topk_first, a stable
// descending torch.sort of the whole row and a slice; on an H100 that took
// ~65x the time of reading the rows at the flagship's 5,120 x 20,480 (two CUB
// radix passes over keys and values, an index fill), more than any other
// step of the dense cells but K1 / K7. This kernel was added for that.
//
// Contract: f32 rows x [M, G], any G, and 1 <= k <= min(G, kMaxK) -> the k largest
// values of each row and their int64 columns, in descending order, ties to
// the lowest column first: exactly topk_first(x, k) on the card. The order
// is torch.sort's there: -0.0 ties with +0.0 (CUB's radix sort maps -0.0 to
// +0.0), +-inf and denormals order by their bits, nothing is flushed, and
// the values come back as read (-0.0 stays -0.0). NaN lies outside it.
//
// Bound: bytes. Each row is read once (4 G bytes) and k values and columns
// are written once (12 k): at 5,120 x 20,480 and k = 100 that is 425.6 MB,
// 0.127 ms at 3.35 TB/s.
//
// Design: one CTA of 512 threads a row, so each row is read from HBM once
// and nothing leaves the SM but the answer; one launch a merge.
//  1. A row of at most kMaxG columns is staged in shared memory with 16-byte
//     streaming loads (4-byte ones where a row is not 16-byte aligned), four
//     in flight a thread. A wider row is not staged: every later pass reads
//     it from global memory again, where it is still in L2 (a row of 69,077
//     columns is 276 KB; the L2 holds 50 MB). Each thread keeps the largest
//     order key (the f32 bits mapped to an unsigned int that orders as the
//     floats do) of its G/512 values.
//  2-4. row_select.cuh's select_topk: a threshold from the threads' maxima,
//     a bitonic sort of the few hundred values above it, a radix select where
//     thousands tie. The values are read back from the staged row.
//  Shared memory: the staged row (4 G bytes) and 16 KB for the selection's
//  buffer; two CTAs an SM at the cells' G.
#include <cuda_runtime.h>
#include <stdint.h>

#include "row_select.cuh"

namespace {

using namespace row_select;

constexpr int kMaxG = 53248;        // the widest row that shared memory stages

// A load of the first pass: streaming where the row is staged (it is read
// from HBM once), cached where it is read again from global memory.
template <bool kStaged, typename V>
__device__ __forceinline__ V first_load(const V* p) {
  if constexpr (kStaged) return __ldcs(p);
  else return *p;
}

// kStaged: the row is staged in shared memory (G <= kMaxG); otherwise every
// pass reads it from global memory.
template <bool kStaged>
__global__ void __launch_bounds__(kThreads, 2) row_topk_kernel(
    const float* __restrict__ x, int G, int k, int vec, float* __restrict__ out_vals,
    long long* __restrict__ out_cols) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* stage = reinterpret_cast<uint32_t*>(smem);
  uint64_t* buf = reinterpret_cast<uint64_t*>(
      smem + (kStaged ? 4 * static_cast<size_t>((G + 3) & ~3) : 0));
  __shared__ Shared sh;

  const int tid = threadIdx.x;
  const size_t r = blockIdx.x;
  const uint32_t* src = reinterpret_cast<const uint32_t*>(x) + r * G;
  const uint32_t* row = kStaged ? stage : src;
  const bool row_vec = kStaged || vec;
  float* vals = out_vals + r * k;
  long long* cols = out_cols + r * k;

  // 1. stage the row (or only read it); each thread's largest key
  uint32_t mx = 0;
  if (vec) {
    const uint4* src4 = reinterpret_cast<const uint4*>(src);
    uint4* stage4 = reinterpret_cast<uint4*>(stage);
    const int n4 = G >> 2;
    for (int c0 = tid; c0 < n4; c0 += 4 * kThreads) {
      uint4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (c0 + u * kThreads < n4) v[u] = first_load<kStaged>(src4 + c0 + u * kThreads);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (c0 + u * kThreads < n4) {
          if (kStaged) stage4[c0 + u * kThreads] = v[u];
          mx = max(mx, max4(v[u]));
        }
    }
  } else {
    for (int i0 = tid; i0 < G; i0 += 4 * kThreads) {
      uint32_t v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (i0 + u * kThreads < G) v[u] = first_load<kStaged>(src + i0 + u * kThreads);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (i0 + u * kThreads < G) {
          if (kStaged) stage[i0 + u * kThreads] = v[u];
          mx = max(mx, order_key(v[u]));
        }
    }
  }

  select_topk(row, G, k, row_vec, mx, buf, sh, [&](int i, int col) {
    vals[i] = __uint_as_float(row[col]);
    cols[i] = col;
  });
}

}  // namespace

extern "C" int qfr_row_topk(const void* x, int M, int G, int k, int vec, void* vals, void* cols,
                            void* stream) {
  if (M < 1 || G < 1 || k < 1 || k > kMaxK || k > G)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool staged = G <= kMaxG;
  const size_t smem =
      (staged ? 4 * static_cast<size_t>((G + 3) & ~3) : 0) + 8 * static_cast<size_t>(kSortCap);
  const auto kernel = staged ? row_topk_kernel<true> : row_topk_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(M), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), G, k, vec, static_cast<float*>(vals),
      static_cast<long long*>(cols));
  return static_cast<int>(cudaGetLastError());
}
