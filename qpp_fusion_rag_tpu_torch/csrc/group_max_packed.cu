// K7: bf16 dense scores fused with the packed 128-doc group max.
//
//   out[m, g] = max over n in [128 g, 128 g + 128) of
//               pack(dot_f32(q[m], c[n]), lane = n & 127)
//   pack(v, lane) = bits(v) & ~0x7F | lane;  docs n >= n_real score -3e38
//
// Replaces qpp_fusion_rag_tpu/ops/pallas/dense_topk.py:group_max_packed
// (_make_packed_kernel), both layouts: the corpus as rows [N, D], or as
// [D, N] (transposed=True), which is read in place through ldmatrix.trans.
//
// Bound on the H100: bf16 tensor-core arithmetic. The dense flagship's
// [5120, 768] x [768, 2,621,440] is 2.06e13 flops per step against a
// 4.03 GB corpus (~5,100 flops per corpus byte, far above the ~295 at
// which the card stops being memory-bound). Only the [M, N/128] maxima
// reach device memory, never the [M, N] scores (419 MB instead of 54 GB).
//
// Design: the shared bf16 main loop of dense_common.cuh (128 x 128 tile,
// mma.sync m16n8k16 with f32 accumulators, 32 bf16 of K per staged slice,
// the next slice's loads in flight during the current mma);
// the query tiles of one corpus tile run next to each other, so the corpus
// leaves HBM about once and is re-read from L2. Simple first: no cp.async
// or TMA ring and no wgmma yet. The epilogue is the TPU kernel's:
// the -3e38 pad mask, lane packing, a FLOAT max (fmaxf: among equal cleared
// bits it keeps the highest lane for positive scores and the lowest for
// negative ones), and no flush-to-zero (a zero score packs into a denormal).
#include "dense_common.cuh"

namespace {

using namespace dense;

template <bool kTrans>
__global__ void __launch_bounds__(kThreads) group_max_packed_kernel(
    const uint16_t* __restrict__ q, const uint16_t* __restrict__ c, int M, int N, int D,
    int n_real, int m_tiles, float* __restrict__ out) {
  __shared__ __align__(16) int8_t As[kBM * kLds];
  __shared__ __align__(16) int8_t Bs[kTrans ? kTransRows * kLdt : kBN * kLds];
  __shared__ float red[2][kBM];

  const Lane L;
  const int m0 = (blockIdx.x % m_tiles) * kBM;
  const long long n_tile = blockIdx.x / m_tiles;
  const long long n0 = n_tile * kBN;
  const int G = (N + kBN - 1) / kBN;

  float acc[2][8][4];
  tile_loop<Bf16, kTrans>(acc, As, Bs, q, m0, M, c, n0, N, D, D * 2, L);
  packed_max_rows(
      [&](int mi, int ni, int e4, int col) {
        return n0 + col < n_real ? acc[mi][ni][e4] : kNegFinite;
      },
      red, L);
  if (L.tid < kBM && m0 + L.tid < M)
    out[static_cast<long long>(m0 + L.tid) * G + n_tile] = fmaxf(red[0][L.tid], red[1][L.tid]);
}

}  // namespace

extern "C" int qfr_group_max_packed(const void* q, const void* corpus, int M, int N, int D,
                                    int n_real, int transposed, void* out, void* stream) {
  const int m_tiles = (M + kBM - 1) / kBM;
  const unsigned blocks =
      static_cast<unsigned>(static_cast<long long>(m_tiles) * ((N + kBN - 1) / kBN));
  const auto* qq = static_cast<const uint16_t*>(q);
  const auto* cc = static_cast<const uint16_t*>(corpus);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (transposed)
    group_max_packed_kernel<true><<<blocks, kThreads, 0, st>>>(qq, cc, M, N, D, n_real, m_tiles, o);
  else
    group_max_packed_kernel<false><<<blocks, kThreads, 0, st>>>(qq, cc, M, N, D, n_real, m_tiles, o);
  return static_cast<int>(cudaGetLastError());
}
