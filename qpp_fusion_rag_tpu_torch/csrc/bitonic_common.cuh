// Shared-memory bitonic compare-exchange network, shared by K2
// (bitonic_segsum.cu), K4 (bitonic_topp.cu) and K5 (bitonic_sort.cu), as the
// TPU kernels share _bitonic_network (ops/pallas/bitonic.py): one copy, so a
// direction or start_block fix can never apply to only one of them.
//
// A row of M int32 keys lives in dynamic shared memory as Mp = next power of
// two >= M keys, padded by the caller's sentinel. Key i sits at slot(i): one
// pad word per 32 keys, so the per-thread chunk walks of K2's scan hit 32
// distinct banks. Every CTA has kThreads threads; rows of up to kMaxRow keys
// fit (132 KB with the pad words).
#pragma once

#include <cstddef>
#include <cuda_runtime.h>

namespace qfr_bitonic {

constexpr int kThreads = 1024;
constexpr int kMaxRow = 32768;

__device__ __forceinline__ int slot(int i) { return i + (i >> 5); }

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
// sorted ascending where bit k of i is clear (k >= n: everywhere). Ends with
// a block-wide barrier.
template <class Map>
__device__ __forceinline__ void stage(int* x, int n, int j, int k, Map map) {
  for (int t = threadIdx.x; t < (n >> 1); t += kThreads) {
    const int i = 2 * t - (t & (j - 1));
    const int l = i + j;
    const int si = slot(map(i)), sl = slot(map(l));
    const int a = x[si], b = x[sl];
    if ((a > b) == ((i & k) == 0)) {
      x[si] = b;
      x[sl] = a;
    }
  }
  __syncthreads();
}

// Rounds k = start_block .. stop_block of the network over n keys. With
// stop_block = n the row ends sorted ascending; with stop_block < n every
// stop_block-block ends sorted, ascending for even blocks and descending
// for odd ones. start_block > 2 skips the rounds before it: the row must
// then hold aligned start_block/2 blocks sorted alternately ascending /
// descending (the state those rounds would have produced).
__device__ __forceinline__ void network(int* x, int n, int start_block, int stop_block) {
  for (int k = start_block; k <= stop_block; k <<= 1)
    for (int j = k >> 1; j > 0; j >>= 1) stage(x, n, j, k, Dense());
}

// Row `in` of M keys -> shared memory, Mp - M pad keys after it. Ends with a
// barrier.
__device__ __forceinline__ void load_row(int* x, const int* __restrict__ in, int M, int Mp,
                                         int pad) {
  for (int i = threadIdx.x; i < Mp; i += kThreads) x[slot(i)] = i < M ? in[i] : pad;
  __syncthreads();
}

// Host side: the padded row length (>= 2) and its shared-memory bytes.
inline int padded_len(int M) {
  int Mp = 2;
  while (Mp < M) Mp <<= 1;
  return Mp;
}
inline size_t smem_bytes(int Mp) { return static_cast<size_t>(Mp + Mp / 32) * sizeof(int); }

// Host side: the shared start_block rule of every entry point.
inline bool valid_start_block(int start_block, int Mp) {
  return start_block >= 2 && start_block <= Mp && (start_block & (start_block - 1)) == 0;
}

}  // namespace qfr_bitonic
