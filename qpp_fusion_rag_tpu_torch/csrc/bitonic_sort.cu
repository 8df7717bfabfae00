// K5: ascending sort of each row of [B, M] int32 keys.
//
// Replaces qpp_fusion_rag_tpu/ops/pallas/bitonic.py:bitonic_sort_rows
// (_bitonic_kernel). Contract kept: ascending; start_block > 2 skips the
// first log2(start_block) - 1 rounds for rows that arrive as aligned
// start_block/2 blocks sorted alternately ascending / descending. The TPU's
// rules (M a power of two and a multiple of 1024, B a multiple of 8) do not
// apply: a row of any length up to 65,536 keys is padded with INT32_MAX
// inside shared memory (the pad sorts last and is never stored).
//
// Bound on the H100: shared-memory bandwidth and block-wide barriers, as for
// K2. The rank-safe pool reaches it only when 2*bs > M (e.g. BM25 at 8192
// candidates: [1024, 16384], 105 stages from start_block 2).
//
// Design: one CTA of 1024 threads per row, the row in dynamic shared memory
// (above 48 KB after cudaFuncSetAttribute), the network of
// bitonic_common.cuh, one coalesced load and one coalesced store. A row of
// more than 32,768 keys takes a cluster of two CTAs, one half each
// (bitonic_common.cuh: sort_row).
#include <climits>
#include <cuda_runtime.h>

#include "bitonic_common.cuh"

namespace {

using qfr_bitonic::kThreads;
using qfr_bitonic::slot;

__global__ void __launch_bounds__(kThreads) bitonic_sort_kernel(
    const int* __restrict__ keys, int M, int Mp, int start_block, int* __restrict__ out) {
  extern __shared__ int x[];  // this CTA's keys at slot(i)
  const qfr_bitonic::Part p = qfr_bitonic::part_of(Mp);
  qfr_bitonic::load_row(x, keys + p.row * M, M, p, INT_MAX);
  qfr_bitonic::sort_row(x, p, start_block);
  int* o = out + p.row * M + p.base();
  const int m = min(p.n, M - p.base());
  for (int i = threadIdx.x; i < m; i += kThreads) o[i] = x[slot(i)];
}

}  // namespace

extern "C" int qfr_bitonic_sort(const void* keys, int B, int M, int start_block, void* out,
                                void* stream) {
  const int Mp = qfr_bitonic::padded_len(M);
  if (M < 1 || Mp > qfr_bitonic::kMaxRow || !qfr_bitonic::valid_start_block(start_block, Mp))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(qfr_bitonic::launch_rows(
      bitonic_sort_kernel, B, Mp, static_cast<cudaStream_t>(stream),
      static_cast<const int*>(keys), M, Mp, start_block, static_cast<int*>(out)));
}
