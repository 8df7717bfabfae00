// K2: per-row sort of packed (doc << 8 | q8) int32 keys fused with an exact
// int32 segmented run-sum of the low byte over equal-doc runs.
//
// Replaces qpp_fusion_rag_tpu/ops/pallas/bitonic.py:bitonic_segsum_rows
// (_bitonic_segsum_kernel). Contract kept: ascending sort; sids are the
// sorted keys' doc ids by LOGICAL shift (the INT32_MIN pad of descending
// presorted windows becomes 0x800000, callers mask sids >= 0x7FFFFF); sums
// hold each run's total of (q8 + plus_one) at the run's last position and -1
// elsewhere. start_block > 2 skips the first log2(start_block) - 1 rounds for
// rows that arrive as aligned start_block/2 blocks sorted alternately
// ascending / descending (the presorted posting layout).
//
// Bound on the H100: shared-memory bandwidth and barriers. The row lives in
// shared memory (64 KB at M = 16,384, 128 KB at M = 32,768); at the main
// path's presorted start_block = 4096 the network is 54 compare-exchange
// stages over M/2 pairs, each a block-wide barrier.
//
// Design: one CTA of 1024 threads per row; the keys never leave shared
// memory between the load and the two output stores. Rows that are not a
// power of two are padded with INT32_MAX inside shared memory (the pad sorts
// last and is never stored). The scan is exact for ANY run length, not just
// max_run: each thread owns a contiguous chunk, reduces it to a
// (run-start-seen, partial-sum) pair, a block-wide segmented exclusive scan
// of those pairs (warp shuffles) gives every chunk its carry-in, and a second
// pass over the chunk writes the run totals. Shared memory is indexed with
// one pad word per 32 keys so the chunk walks hit 32 distinct banks. The
// compare-exchange network is the one in bitonic_common.cuh, shared with K4
// and K5.
#include <climits>
#include <cuda_runtime.h>

#include "bitonic_common.cuh"

namespace {

using qfr_bitonic::kThreads;
using qfr_bitonic::slot;

__device__ __forceinline__ int sid_of(int key) {
  return static_cast<int>(static_cast<unsigned>(key) >> 8);
}

// (f, s) pairs: f = a run starts inside the span, s = sum from the last run
// start in the span (or the span's beginning) to its end. combine(earlier,
// later) is associative.
__device__ __forceinline__ void warp_inclusive_scan(int& f, int& s, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int fu = __shfl_up_sync(0xffffffffu, f, off);
    const int su = __shfl_up_sync(0xffffffffu, s, off);
    if (lane >= off) {
      s = f ? s : su + s;
      f = f | fu;
    }
  }
}

__global__ void __launch_bounds__(kThreads) bitonic_segsum_kernel(
    const int* __restrict__ keys, int M, int Mp, int start_block, int plus_one,
    int* __restrict__ sums, int* __restrict__ sids) {
  extern __shared__ int x[];  // Mp keys at slot(i)
  __shared__ int warp_f[kThreads / 32];
  __shared__ int warp_s[kThreads / 32];
  const long long row = blockIdx.x;
  const int* in = keys + row * M;
  qfr_bitonic::load_row(x, in, M, Mp, INT_MAX);
  // at round k, pairs (i, i + j) with bit j of i clear sort ascending where
  // bit k of i is clear (k = Mp: everywhere)
  qfr_bitonic::network(x, Mp, start_block, Mp);

  // segmented scan over the first M sorted keys, chunk per thread
  const int chunk = (M + kThreads - 1) / kThreads;
  const int lo = min(M, static_cast<int>(threadIdx.x) * chunk);
  const int hi = min(M, lo + chunk);
  int f = 0, s = 0;
  int prev = lo > 0 ? sid_of(x[slot(lo - 1)]) : -1;
  for (int i = lo; i < hi; ++i) {
    const int key = x[slot(i)];
    const int sid = sid_of(key);
    const int v = (key & 0xFF) + plus_one;
    if (sid != prev) {
      f = 1;
      s = v;
    } else {
      s += v;
    }
    prev = sid;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int fi = f, si = s;
  warp_inclusive_scan(fi, si, lane);
  int fe = __shfl_up_sync(0xffffffffu, fi, 1);
  int se = __shfl_up_sync(0xffffffffu, si, 1);
  if (lane == 0) fe = se = 0;
  if (lane == 31) {
    warp_f[warp] = fi;
    warp_s[warp] = si;
  }
  __syncthreads();
  if (warp == 0) {
    int wf = warp_f[lane], ws = warp_s[lane];
    warp_inclusive_scan(wf, ws, lane);
    int pf = __shfl_up_sync(0xffffffffu, wf, 1);
    int ps = __shfl_up_sync(0xffffffffu, ws, 1);
    if (lane == 0) pf = ps = 0;
    __syncwarp();
    warp_f[lane] = pf;
    warp_s[lane] = ps;
  }
  __syncthreads();
  // carry-in = (warps before) combined with (lanes before, this warp)
  int run = fe ? se : warp_s[warp] + se;

  int* out_sums = sums + row * M;
  int* out_sids = sids + row * M;
  prev = lo > 0 ? sid_of(x[slot(lo - 1)]) : -1;
  for (int i = lo; i < hi; ++i) {
    const int key = x[slot(i)];
    const int sid = sid_of(key);
    const int v = (key & 0xFF) + plus_one;
    run = (sid != prev) ? v : run + v;
    const bool last = (i == M - 1) || sid_of(x[slot(i + 1)]) != sid;
    out_sums[i] = last ? run : -1;
    out_sids[i] = sid;
    prev = sid;
  }
}

}  // namespace

extern "C" int qfr_bitonic_segsum(const void* keys, int B, int M, int start_block,
                                  int plus_one, void* sums, void* sids, void* stream) {
  const int Mp = qfr_bitonic::padded_len(M);
  if (M < 1 || Mp > qfr_bitonic::kMaxRow || !qfr_bitonic::valid_start_block(start_block, Mp))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = qfr_bitonic::smem_bytes(Mp);
  cudaError_t err = cudaFuncSetAttribute(
      bitonic_segsum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  bitonic_segsum_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(keys), M, Mp, start_block, plus_one,
      static_cast<int*>(sums), static_cast<int*>(sids));
  return static_cast<int>(cudaGetLastError());
}
