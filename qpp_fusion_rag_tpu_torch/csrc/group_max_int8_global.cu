// K9: int8 dense scores under ONE global corpus scale, reduced entirely in
// int32.
//
//   out[m, g] = max over n in [128 g, 128 g + 128) of (s << 7) | (n & 127),
//   s = dot_i32(q[m], c[n]), or -(1 << 24) for docs n >= n_real
//
// |s| <= D * 127^2 < 2^24 (the wrapper refuses larger D), so the shift
// cannot overflow, and the pad sentinel shifts to exactly INT_MIN: below
// any real score, with the lane still in its low bits. An integer max on
// (s << 7) | lane always keeps the highest lane among equal scores.
//
// Replaces qpp_fusion_rag_tpu/ops/pallas/dense_topk.py:
// group_max_packed_int8_global (_make_packed_kernel_int8_global), with the
// corpus as rows [N, D] where the TPU kernel reads [D, N].
//
// Bound on the H100: int8 tensor-core arithmetic, as K1 (here on the s8
// mma.sync main loop of dense_common.cuh); the epilogue is shift + or + integer max, no
// float conversion, no scale and no per-doc load.
#include "dense_common.cuh"

namespace {

using namespace dense;

__global__ void __launch_bounds__(kThreads) group_max_int8_global_kernel(
    const int8_t* __restrict__ q, const int8_t* __restrict__ c, int M, int N, int D,
    int n_real, int m_tiles, int* __restrict__ out) {
  __shared__ __align__(16) int8_t As[kBM * kLds];
  __shared__ __align__(16) int8_t Bs[kBN * kLds];
  __shared__ int red[2][kBM];

  const Lane L;
  const int m0 = (blockIdx.x % m_tiles) * kBM;
  const long long n_tile = blockIdx.x / m_tiles;
  const long long n0 = n_tile * kBN;
  const int G = (N + kBN - 1) / kBN;

  int acc[2][8][4];
  tile_loop<S8>(acc, As, Bs, q, m0, M, c, n0, N, D, L);
  packed_imax_rows(
      [&](int mi, int ni, int e4, int col) {
        return n0 + col < n_real ? acc[mi][ni][e4] : -(1 << 24);
      },
      red, L);
  if (L.tid < kBM && m0 + L.tid < M)
    out[static_cast<long long>(m0 + L.tid) * G + n_tile] = max(red[0][L.tid], red[1][L.tid]);
}

}  // namespace

extern "C" int qfr_group_max_int8_global(const void* q, const void* corpus_rows, int M, int N,
                                         int D, int n_real, void* out, void* stream) {
  const int m_tiles = (M + kBM - 1) / kBM;
  const unsigned blocks =
      static_cast<unsigned>(static_cast<long long>(m_tiles) * ((N + kBN - 1) / kBN));
  group_max_int8_global_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(corpus_rows), M, N, D, n_real,
      m_tiles, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
