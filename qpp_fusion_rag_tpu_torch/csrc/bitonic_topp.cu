// K4: the exact top-bs values of each row of [B, M] int32 keys, returned as
// a [B, bs] block sorted ascending.
//
// Replaces qpp_fusion_rag_tpu/ops/pallas/bitonic.py:bitonic_topp_rows
// (_bitonic_topp_kernel). Contract kept: bs a power of two >= 1024 with
// 2*bs <= M; element [bs - pool - 1] of the output is the true (pool+1)-th
// value of the row (the rank-safe pool's outside maximum). The output is a
// function of the keys alone, so it equals the plain sort bit for bit. The
// TPU's rules on M (a power of two, a multiple of 1024) do not apply: a row
// of any length up to 65,536 keys is padded with INT32_MIN inside shared
// memory, which can never enter the top bs.
//
// Bound on the H100: shared-memory bandwidth and block-wide barriers, as for
// K2 (at [1024, 32768] and bs 1024: 55 network stages over 16,384 pairs, then
// 5 pairing rounds of 11 barriers each over a halving row).
//
// Design: a tournament in one CTA of 1024 threads per row, the row in
// dynamic shared memory. The shared network runs up to stop_block = bs,
// leaving bs-blocks sorted alternately ascending / descending. Each pairing
// round then keeps the elementwise max of adjacent blocks (an ascending and a
// descending block: exactly the top bs of their union, as a bitonic
// sequence) in the even block's place, and bitonic-merges every surviving
// block, direction by its new parity. Survivors stay where they are (no
// compaction copy): after g rounds logical block b lives at physical block
// b << g. The last block is logical block 0, ascending, at physical 0.
//
// A row of more than 32,768 keys runs on a cluster of two CTAs, one half
// each (bitonic_common.cuh). Each half plays its own tournament down to one
// bs-block, the lower half's ascending and the upper half's descending (the
// directions follow the row index), so the last pairing round is across
// the cluster: the lower CTA takes the elementwise max with the upper
// CTA's block through distributed shared memory and merges it alone.
#include <climits>
#include <cuda_runtime.h>

#include "bitonic_common.cuh"

namespace {

using qfr_bitonic::kThreads;
using qfr_bitonic::slot;

__global__ void __launch_bounds__(kThreads) bitonic_topp_kernel(
    const int* __restrict__ keys, int M, int Mp, int bs, int lbs, int start_block,
    int* __restrict__ out) {
  extern __shared__ int x[];  // this CTA's keys at slot(i)
  const qfr_bitonic::Part p = qfr_bitonic::part_of(Mp);
  qfr_bitonic::load_row(x, keys + p.row * M, M, p, INT_MIN);
  qfr_bitonic::network(x, p.n, start_block, bs, p.base());

  int n = p.n;
  for (int gap = 0; n > bs; ++gap) {
    const qfr_bitonic::Strided cur{lbs, gap};
    for (int t = threadIdx.x; t < (n >> 1); t += kThreads) {
      const int lo = (((t >> lbs) << 1) << lbs) | (t & (bs - 1));  // block 2b, element e
      const int plo = slot(cur(lo)), phi = slot(cur(lo + bs));
      x[plo] = max(x[plo], x[phi]);
    }
    __syncthreads();
    n >>= 1;
    const qfr_bitonic::Strided next{lbs, gap + 1};
    for (int j = bs >> 1; j > 0; j >>= 1) qfr_bitonic::stage(x, n, j, bs, next, p.rank * n);
  }
  if (p.halves == 2) {
    // the last pairing round: logical block 0 of each half sits at physical 0
    qfr_bitonic::cg::cluster_group cluster = qfr_bitonic::cg::this_cluster();
    cluster.sync();
    if (p.rank == 0) {
      const int* other = cluster.map_shared_rank(x, 1);
      for (int i = threadIdx.x; i < bs; i += kThreads) x[slot(i)] = max(x[slot(i)], other[slot(i)]);
    }
    cluster.sync();                       // the upper half stays until it has been read
    if (p.rank == 1) return;
    for (int j = bs >> 1; j > 0; j >>= 1)
      qfr_bitonic::stage(x, bs, j, 2 * bs, qfr_bitonic::Dense());
  }
  int* o = out + p.row * bs;
  for (int i = threadIdx.x; i < bs; i += kThreads) o[i] = x[slot(i)];
}

}  // namespace

extern "C" int qfr_bitonic_topp(const void* keys, int B, int M, int bs, int start_block,
                                void* out, void* stream) {
  const int Mp = qfr_bitonic::padded_len(M);
  int lbs = 0;
  while ((1 << lbs) < bs) ++lbs;
  if (M < 1 || Mp > qfr_bitonic::kMaxRow || bs < 1024 || (1 << lbs) != bs || 2 * bs > M ||
      !qfr_bitonic::valid_start_block(start_block, Mp) || start_block > 2 * bs)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(qfr_bitonic::launch_rows(
      bitonic_topp_kernel, B, Mp, static_cast<cudaStream_t>(stream),
      static_cast<const int*>(keys), M, Mp, bs, lbs, start_block, static_cast<int*>(out)));
}
