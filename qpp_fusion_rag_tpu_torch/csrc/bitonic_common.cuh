// Shared-memory bitonic compare-exchange network of K5 (bitonic_sort.cu)
// and of K4's route for bs > 2048 (bitonic_topp.cu), as the TPU kernels
// share _bitonic_network (ops/pallas/bitonic.py). K2 and K4's route for
// bs <= 2048 run the register network of bitonic_regs.cuh, with the same
// direction and start_block rules, and take the padding and start_block
// rules and the launch (launch_clusters) from here.
//
// A row of M int32 keys is padded by the caller's sentinel to Mp = the next
// power of two >= M keys. Key i sits at slot(i): one pad word per 32 keys,
// so the per-thread chunk walks of K2's scan hit 32 distinct banks. Every
// CTA has kThreads threads.
//
// Rows of up to kHalf = 32,768 keys live in one CTA's dynamic shared memory
// (132 KB with the pad words). Rows of up to kMaxRow = 65,536 keys (256 KB,
// more than a CTA can hold) run on a cluster of two CTAs: CTA r of the
// cluster holds keys [r * kHalf, (r + 1) * kHalf). Every round of the
// network pairs keys less than kHalf apart, and so stays inside one CTA,
// except the first stage of the last round (k = 65,536, j = 32,768), which
// pairs key i of one half with key i of the other: each CTA does half of
// those pairs through distributed shared memory (map_shared_rank), between
// two cluster barriers. A CTA's compare directions follow the key's index
// in the whole row (Part::base), so the two halves end the earlier rounds
// ascending and descending, a bitonic row.
#pragma once

#include <cooperative_groups.h>
#include <cstddef>
#include <cuda_runtime.h>

namespace qfr_bitonic {

namespace cg = cooperative_groups;

constexpr int kThreads = 1024;
constexpr int kHalf = 32768;             // keys one CTA holds
constexpr int kMaxRow = 2 * kHalf;       // keys a two-CTA cluster holds

__device__ __forceinline__ int slot(int i) { return i + (i >> 5); }

// This CTA's share of its row.
struct Part {
  long long row;  // the row this CTA works on
  int halves;     // CTAs per row: 1, or 2 when Mp > kHalf
  int rank;       // this CTA's half (0 when halves == 1)
  int n;          // keys this CTA holds: Mp / halves
  __device__ __forceinline__ int base() const { return rank * n; }  // row index of local key 0
};

__device__ __forceinline__ Part part_of(int Mp) {
  Part p;
  p.halves = Mp > kHalf ? 2 : 1;
  p.rank = p.halves == 2 ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
  p.row = blockIdx.x / p.halves;
  p.n = Mp / p.halves;
  return p;
}

// Logical index -> physical index. Dense: the identity. Strided: logical
// block b of 2^lbs keys lives at physical block b << gap (the tournament's
// surviving blocks after gap pairing rounds, left in place).
struct Dense {
  __device__ __forceinline__ int operator()(int i) const { return i; }
};
struct Strided {
  int lbs, gap;
  __device__ __forceinline__ int operator()(int i) const {
    return (((i >> lbs) << gap) << lbs) | (i & ((1 << lbs) - 1));
  }
};

// One stage over logical [0, n): pairs (i, i + j) with bit j of i clear,
// sorted ascending where bit k of (base + i) is clear (k beyond the row:
// everywhere). Ends with a block-wide barrier.
template <class Map>
__device__ __forceinline__ void stage(int* x, int n, int j, int k, Map map, int base = 0) {
  for (int t = threadIdx.x; t < (n >> 1); t += kThreads) {
    const int i = 2 * t - (t & (j - 1));
    const int l = i + j;
    const int si = slot(map(i)), sl = slot(map(l));
    const int a = x[si], b = x[sl];
    if ((a > b) == (((base + i) & k) == 0)) {
      x[si] = b;
      x[sl] = a;
    }
  }
  __syncthreads();
}

// Rounds k = start_block .. stop_block of the network over this CTA's n
// keys. With stop_block = n the part ends sorted, ascending or descending
// by bit n of its row index (base); with stop_block < n every
// stop_block-block ends sorted, ascending for even blocks of the row and
// descending for odd ones. start_block > 2 skips the rounds before it: the
// row must then hold aligned start_block/2 blocks sorted alternately
// ascending / descending (the state those rounds would have produced).
__device__ __forceinline__ void network(int* x, int n, int start_block, int stop_block,
                                        int base) {
  for (int k = start_block; k <= stop_block; k <<= 1)
    for (int j = k >> 1; j > 0; j >>= 1) stage(x, n, j, k, Dense(), base);
}

// The whole row sorted ascending: this CTA's part is keys [base, base + n)
// of the sorted row. With two halves, the cross-CTA stage runs between two
// cluster barriers, then each half finishes its last round alone.
__device__ __forceinline__ void sort_row(int* x, const Part& p, int start_block) {
  network(x, p.n, start_block, p.n, p.base());
  if (p.halves == 1) return;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  int* lo = cluster.map_shared_rank(x, 0);
  int* hi = cluster.map_shared_rank(x, 1);
  const int half = p.n / 2;   // pairs per CTA
  for (int t = threadIdx.x; t < half; t += kThreads) {
    const int s = slot(p.rank * half + t);
    const int a = lo[s], b = hi[s];
    if (a > b) {
      lo[s] = b;
      hi[s] = a;
    }
  }
  cluster.sync();
  for (int j = p.n >> 1; j > 0; j >>= 1) stage(x, p.n, j, 2 * p.n, Dense(), p.base());
}

// This CTA's keys [base, base + n) of row `in` (M keys) -> shared memory,
// pad keys past M. Ends with a barrier.
__device__ __forceinline__ void load_row(int* x, const int* __restrict__ in, int M,
                                         const Part& p, int pad) {
  for (int i = threadIdx.x; i < p.n; i += kThreads) {
    const int gi = p.base() + i;
    x[slot(i)] = gi < M ? in[gi] : pad;
  }
  __syncthreads();
}

// Host side: the padded row length (>= 2) and one CTA's shared-memory bytes.
inline int padded_len(int M) {
  int Mp = 2;
  while (Mp < M) Mp <<= 1;
  return Mp;
}
inline size_t smem_bytes(int n) { return static_cast<size_t>(n + n / 32) * sizeof(int); }

// Host side: the shared start_block rule of every entry point.
inline bool valid_start_block(int start_block, int Mp) {
  return start_block >= 2 && start_block <= Mp && (start_block & (start_block - 1)) == 0;
}

// Host side: launch `kernel` over B rows, `halves` CTAs of `threads` threads
// and `smem` bytes of dynamic shared memory per row (a cluster of two CTAs
// when halves == 2). -> a cudaError_t.
template <class... Params, class... Args>
inline cudaError_t launch_clusters(void (*kernel)(Params...), int B, int halves, int threads,
                                   size_t smem, cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = halves;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(B) * halves);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// Host side: launch `kernel` of the shared-memory network over B rows of
// padded length Mp: one CTA per row, or a cluster of two per row when
// Mp > kHalf.
template <class... Params, class... Args>
inline cudaError_t launch_rows(void (*kernel)(Params...), int B, int Mp, cudaStream_t stream,
                               Args... args) {
  const int halves = Mp > kHalf ? 2 : 1;
  return launch_clusters(kernel, B, halves, kThreads, smem_bytes(Mp / halves), stream, args...);
}

}  // namespace qfr_bitonic
