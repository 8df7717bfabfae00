// K1: int8 dense scores fused with the packed 128-doc group max.
//
//   out[m, g] = max over n in [128 g, 128 g + 128) of
//               pack(float(dot_i32(q[m], c[n])) * d_scale[n], lane = n & 127)
//   pack(v, lane) = bits(v) & ~0x7F | lane;  docs n >= n_real score -3e38
//
// Replaces qpp_fusion_rag_tpu/ops/pallas/dense_topk.py:group_max_packed_int8
// (_make_packed_kernel_int8), with the corpus in row-major [N, D] (the layout
// the rerank gather also reads) instead of the TPU's [D, N] copy.
//
// Bound on the H100: int8 tensor-core arithmetic. The main path's
// [1024, 768] x [768, 2,621,440] is 4.1e12 int8 ops; the corpus is 2.0 GB.
// The [M, N] scores never reach device memory, only [M, N/128] maxima.
//
// Design: the shared s8 main loop of dense_common.cuh (128 queries x 128
// docs per block, mma.sync m16n8k32, 64-byte K slices through shared
// memory, the next slice's loads in flight during the current mma). Block
// order puts the query tiles of one corpus tile next to each other, so a
// corpus tile is fetched from HBM once and re-read from L2. The
// epilogue follows the TPU kernel bit for bit: exact int32 -> f32
// conversion, ONE rounding for the scale product (__fmul_rn, no
// contraction), the -3e38 pad mask, lane packing, and a FLOAT max. Built
// without flush-to-zero: a zero score packs into a denormal that must
// survive the max.
#include "dense_common.cuh"

namespace {

using namespace dense;

__global__ void __launch_bounds__(kThreads) group_max_packed_int8_kernel(
    const int8_t* __restrict__ q, const int8_t* __restrict__ c,
    const float* __restrict__ scale, int M, int N, int D, int n_real, int m_tiles,
    float* __restrict__ out) {
  __shared__ __align__(16) int8_t As[kBM * kLds];
  __shared__ __align__(16) int8_t Bs[kBN * kLds];
  __shared__ float red[2][kBM];

  const Lane L;
  const int m0 = (blockIdx.x % m_tiles) * kBM;
  const long long n_tile = blockIdx.x / m_tiles;
  const long long n0 = n_tile * kBN;
  const int G = (N + kBN - 1) / kBN;

  int acc[2][8][4];
  tile_loop<S8>(acc, As, Bs, q, m0, M, c, n0, N, D, D, L);

  float sc[8][2];
#pragma unroll
  for (int ni = 0; ni < 8; ++ni)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const long long n = n0 + L.wn * 64 + ni * 8 + L.tg * 2 + e;
      sc[ni][e] = n < N ? __ldg(scale + n) : 0.0f;
    }
  packed_max_rows(
      [&](int mi, int ni, int e4, int col) {
        const float v = __fmul_rn(__int2float_rn(acc[mi][ni][e4]), sc[ni][e4 & 1]);
        return n0 + col < n_real ? v : kNegFinite;
      },
      red, L);
  if (L.tid < kBM && m0 + L.tid < M)
    out[static_cast<long long>(m0 + L.tid) * G + n_tile] = fmaxf(red[0][L.tid], red[1][L.tid]);
}

}  // namespace

extern "C" int qfr_group_max_packed_int8(const void* q, const void* corpus_rows,
                                         const void* d_scale, int M, int N, int D,
                                         int n_real, void* out, void* stream) {
  const int m_tiles = (M + kBM - 1) / kBM;
  const long long blocks = static_cast<long long>(m_tiles) * ((N + kBN - 1) / kBN);
  group_max_packed_int8_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(corpus_rows),
      static_cast<const float*>(d_scale), M, N, D, n_real, m_tiles,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
