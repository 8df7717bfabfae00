// K10: the group (max, first argmax) of K8 at stride 1 on a corpus-
// stationary schedule: every doc leaves device memory exactly once.
//
//   per 128-doc group: v = max of dot_f32(q[m], c[n]), id = the first n
//   reaching it; docs n >= n_real score -inf. Output [M, n_groups].
//
// Replaces qpp_fusion_rag_tpu/ops/pallas/streaming_topk.py:
// _streaming_group_max (the kernel behind streaming_dense_topk). On the
// TPU the queries stay resident in VMEM while a double-buffered DMA streams
// the corpus through once. Here the roles are turned around to fit a
// block: a block owns ONE 128-doc group, holds its 128 x D bf16 rows in
// shared memory for its whole life (192 KB at D = 768, so one block per
// SM), and loops over every 128-query slab, whose 64-byte K slices it
// stages from L2 (the whole [1024, 768] bf16 query block is 1.5 MB, far
// inside the 50 MB L2).
//
// How it differs from K8's schedule, and what bounds each: K8 walks the
// query tiles of one corpus tile in neighbouring blocks and relies on L2 to
// keep the corpus tile between them, so each block stages both operands
// per K slice and any block-order drift re-reads corpus bytes from HBM. K10
// reads its corpus tile from HBM once by construction and re-reads only the
// queries, from L2; its price is one block per SM (8 warps), which hides
// less mma and load latency. Both are bounded by bf16 tensor-core
// arithmetic at these shapes (1024 x 768 x 2.6M is 4.1e12 flops on a
// 4.03 GB corpus); K10's HBM traffic is the floor of 4.03 GB, and its L2
// traffic is (N / 128) x the query block.
#include "dense_common.cuh"

namespace {

using namespace dense;

__global__ void __launch_bounds__(kThreads, 1) streaming_group_max_kernel(
    const uint16_t* __restrict__ q, const uint16_t* __restrict__ c, int M, int N, int D,
    int n_real, int n_groups, int pitch, float* __restrict__ vals, int* __restrict__ ids) {
  extern __shared__ __align__(16) int8_t smem[];
  __shared__ float rv[2][kBM];
  __shared__ int rc[2][kBM];
  int8_t* Cs = smem;                // [128][pitch]: the block's doc rows, K zero-padded
  int8_t* As = smem + kBN * pitch;  // [128][kLds]: one query slab's K slice

  const Lane L;
  const long long n0 = static_cast<long long>(blockIdx.x) * kBN;
  const int row_bytes = D * 2;
  const int chunks = (pitch - 16) / 16;  // 16-byte chunks per resident row
  const int8_t* qb = reinterpret_cast<const int8_t*>(q);
  const int8_t* cb = reinterpret_cast<const int8_t*>(c);

  for (int ch = L.tid; ch < kBN * chunks; ch += kThreads) {
    const int r = ch / chunks, cc = (ch % chunks) * 16;
    int4 v = make_int4(0, 0, 0, 0);
    if (n0 + r < N && cc < row_bytes)
      v = __ldg(reinterpret_cast<const int4*>(cb + (n0 + r) * row_bytes + cc));
    *reinterpret_cast<int4*>(Cs + r * pitch + cc) = v;
  }

  for (int m0 = 0; m0 < M; m0 += kBM) {
    float acc[2][8][4];
    zero(acc);
    RowSlice a;
    a.load(qb, m0, M, row_bytes, 0, L.tid);
    for (int k0b = 0; k0b < row_bytes; k0b += kSlice) {
      a.store(As, kLds, L.tid);
      __syncthreads();
      if (k0b + kSlice < row_bytes) a.load(qb, m0, M, row_bytes, k0b + kSlice, L.tid);
      mma_slice<Bf16>(acc, As, kLds, Cs + k0b, pitch, L);
      __syncthreads();
    }
    argmax_rows(
        [&](int mi, int ni, int e4, int col) {
          return n0 + col < n_real ? acc[mi][ni][e4] : -INFINITY;
        },
        rv, rc, L);
    if (L.tid < kBM && m0 + L.tid < M) {
      float v = rv[0][L.tid];
      int col = rc[0][L.tid];
      take_first_max(v, col, rv[1][L.tid], rc[1][L.tid]);
      const long long at = static_cast<long long>(m0 + L.tid) * n_groups + blockIdx.x;
      vals[at] = v;
      ids[at] = static_cast<int>(n0 + col);
    }
    // rv / rc are rewritten only after the next slab's barriers
  }
}

}  // namespace

extern "C" int qfr_streaming_group_max(const void* q, const void* corpus, int M, int N, int D,
                                       int n_real, int n_groups, void* vals, void* ids,
                                       void* stream) {
  // resident rows padded to whole K slices (zeros) plus the 16-byte bank pad;
  // the wrapper keeps this within the card's opt-in shared-memory limit
  const int pitch = (D * 2 + kSlice - 1) / kSlice * kSlice + 16;
  const int smem = kBN * pitch + kBM * kLds;
  cudaError_t err = cudaFuncSetAttribute(
      streaming_group_max_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  streaming_group_max_kernel<<<static_cast<unsigned>(n_groups), kThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(corpus), M, N, D, n_real,
      n_groups, pitch, static_cast<float*>(vals), static_cast<int*>(ids));
  return static_cast<int>(cudaGetLastError());
}
