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
// shared memory (64 KB at M = 16,384, 128 KB at M = 32,768, two CTAs of a
// cluster at M = 65,536); at the main path's presorted start_block = 4096
// the network is 54 compare-exchange stages over M/2 pairs, each a
// block-wide barrier.
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
// and K5. A row of more than 32,768 keys is sorted by a cluster of two
// CTAs (bitonic_common.cuh: sort_row); each then scans its own half, and
// the halves meet through distributed shared memory: the lower half reads
// the first doc id of the upper one (is its last run complete?) and the
// upper half reads the lower half's last doc id and sums that doc's run
// backwards from the lower half's end (the carry into its first run).
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
  extern __shared__ int x[];  // this CTA's keys at slot(i)
  __shared__ int warp_f[kThreads / 32];
  __shared__ int warp_s[kThreads / 32];
  __shared__ int edge[3];     // prev_sid, next_sid, carry
  const qfr_bitonic::Part p = qfr_bitonic::part_of(Mp);
  qfr_bitonic::load_row(x, keys + p.row * M, M, p, INT_MAX);
  // at round k, pairs (i, i + j) with bit j of i clear sort ascending where
  // bit k of i is clear (k = Mp: everywhere)
  qfr_bitonic::sort_row(x, p, start_block);

  // the neighbouring half's edge: the doc id just before this part (-1:
  // none) with the sum of its run there, and the doc id just after it
  int prev_sid = -1, next_sid = -1, carry = 0;
  if (p.halves == 2) {
    qfr_bitonic::cg::cluster_group cluster = qfr_bitonic::cg::this_cluster();
    cluster.sync();                       // both halves sorted
    if (threadIdx.x == 0) {
      const int* other = cluster.map_shared_rank(x, p.rank ^ 1);
      int e0 = -1, e1 = -1, e2 = 0;
      if (p.rank == 0) {
        e1 = sid_of(other[slot(0)]);
      } else {
        e0 = sid_of(other[slot(p.n - 1)]);
        for (int i = p.n - 1; i >= 0 && sid_of(other[slot(i)]) == e0; --i)
          e2 += (other[slot(i)] & 0xFF) + plus_one;
      }
      edge[0] = e0;
      edge[1] = e1;
      edge[2] = e2;
    }
    cluster.sync();                       // the other half stays until these reads are done
    prev_sid = edge[0];
    next_sid = edge[1];
    carry = edge[2];
  }

  // segmented scan over this part's first m sorted keys, chunk per thread
  const int m = min(p.n, M - p.base());
  const int chunk = (m + kThreads - 1) / kThreads;
  const int lo = min(m, static_cast<int>(threadIdx.x) * chunk);
  const int hi = min(m, lo + chunk);
  int f = 0, s = 0;
  int prev = lo > 0 ? sid_of(x[slot(lo - 1)]) : prev_sid;
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
  // carry-in = (the other half's run, if no run starts before this chunk)
  // combined with (warps before) and (lanes before, this warp)
  int run = fe ? se : warp_s[warp] + se + (warp_f[warp] ? 0 : carry);

  int* out_sums = sums + p.row * M + p.base();
  int* out_sids = sids + p.row * M + p.base();
  prev = lo > 0 ? sid_of(x[slot(lo - 1)]) : prev_sid;
  for (int i = lo; i < hi; ++i) {
    const int key = x[slot(i)];
    const int sid = sid_of(key);
    const int v = (key & 0xFF) + plus_one;
    run = (sid != prev) ? v : run + v;
    const bool last = (i == m - 1) ? next_sid != sid : sid_of(x[slot(i + 1)]) != sid;
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
  return static_cast<int>(qfr_bitonic::launch_rows(
      bitonic_segsum_kernel, B, Mp, static_cast<cudaStream_t>(stream),
      static_cast<const int*>(keys), M, Mp, start_block, plus_one, static_cast<int*>(sums),
      static_cast<int*>(sids)));
}
