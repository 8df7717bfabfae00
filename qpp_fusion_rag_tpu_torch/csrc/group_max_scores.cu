// K8: bf16 dense scores fused with the unpacked group (max, argmax), with
// the optional stride reduce.
//
//   per 128-doc group: v = max of dot_f32(q[m], c[n]), id = the first n
//   reaching it (global doc id); docs n >= n_real score -inf.
//   stride > 1: inside each tn-wide tile of g = tn/128 groups, group j
//   merges with j + g2, j + 2 g2, ... (g2 = g / stride) under a strict '>':
//   on equal values the earlier block keeps its id. Output column
//   t*g2 + j for tile t. tn is therefore part of the result.
//
// Replaces qpp_fusion_rag_tpu/ops/pallas/dense_topk.py:group_max_scores
// (_make_kernel).
//
// Bound on the H100: bf16 tensor-core arithmetic, as K7 (the same main
// loop); the output is [M, N/(128 stride)] values + ids.
//
// Design: one block per 128 queries x one OUTPUT column: it walks the
// `stride` groups that merge into that column in block order, runs the
// shared bf16 main loop over each, reduces each to (max, first argmax)
// and merges them in registers, so the stride reduce costs no extra pass.
#include "dense_common.cuh"

namespace {

using namespace dense;

__global__ void __launch_bounds__(kThreads) group_max_scores_kernel(
    const uint16_t* __restrict__ q, const uint16_t* __restrict__ c, int M, int N, int D,
    int n_real, int m_tiles, int n_out, int g, int stride, float* __restrict__ vals,
    int* __restrict__ ids) {
  __shared__ __align__(16) int8_t As[kBM * kLds];
  __shared__ __align__(16) int8_t Bs[kBN * kLds];
  __shared__ float rv[2][kBM];
  __shared__ int rc[2][kBM];

  const Lane L;
  const int m0 = (blockIdx.x % m_tiles) * kBM;
  const int o = blockIdx.x / m_tiles;
  const int g2 = g / stride;

  float best_v = -INFINITY;
  int best_i = 0;
  for (int s = 0; s < stride; ++s) {
    const long long n0 =
        (static_cast<long long>(o / g2) * g + s * g2 + o % g2) * kBN;
    float acc[2][8][4];
    tile_loop<Bf16>(acc, As, Bs, q, m0, M, c, n0, N, D * 2, L);
    argmax_rows(
        [&](int mi, int ni, int e4, int col) {
          return n0 + col < n_real ? acc[mi][ni][e4] : -INFINITY;
        },
        rv, rc, L);
    if (L.tid < kBM) {
      float v = rv[0][L.tid];
      int col = rc[0][L.tid];
      take_first_max(v, col, rv[1][L.tid], rc[1][L.tid]);
      if (s == 0 || v > best_v) {
        best_v = v;
        best_i = static_cast<int>(n0 + col);
      }
    }
    // rv / rc are rewritten only after the next main loop's barriers
  }
  if (L.tid < kBM && m0 + L.tid < M) {
    const long long at = static_cast<long long>(m0 + L.tid) * n_out + o;
    vals[at] = best_v;
    ids[at] = best_i;
  }
}

}  // namespace

extern "C" int qfr_group_max_scores(const void* q, const void* corpus, int M, int N, int D,
                                    int n_real, int n_out, int g, int stride, void* vals,
                                    void* ids, void* stream) {
  const int m_tiles = (M + kBM - 1) / kBM;
  const unsigned blocks = static_cast<unsigned>(static_cast<long long>(m_tiles) * n_out);
  group_max_scores_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(corpus), M, N, D, n_real,
      m_tiles, n_out, g, stride, static_cast<float*>(vals), static_cast<int*>(ids));
  return static_cast<int>(cudaGetLastError());
}
