// K8 and K10: bf16 dense scores fused with the unpacked group (max, first
// argmax), K8 with the optional stride merge.
//
//   per 128-doc group: v = max of dot_f32(q[m], c[n]), id = the first n
//   reaching it (global doc id); docs n >= n_real score -inf.
//   stride > 1: inside each tn-wide tile of g = tn/128 groups, group j
//   merges with j + g2, j + 2 g2, ... (g2 = g / stride) under a strict '>':
//   on equal values the earlier block keeps its id. Output column
//   t*g2 + j for tile t. tn is therefore part of the result.
//
// Replaces qpp_fusion_rag_tpu/ops/pallas/dense_topk.py:group_max_scores
// (_make_kernel) and qpp_fusion_rag_tpu/ops/pallas/streaming_topk.py:
// _streaming_group_max (the kernel behind streaming_dense_topk). K10 is K8
// at stride 1 over a corpus padded to a multiple of 16,384 docs.
//
// Bound on the H100: bf16 tensor-core arithmetic. At [1024, 768] x
// 2,621,440 docs, 4.12e12 flops (4.17 ms at 989 TF/s) against a 4.03 GB
// corpus (1.20 ms at 3.35 TB/s); the output is [M, N/(128 stride)] values
// and ids, never the [M, N] scores.
//
// Design: the TMA + wgmma main loop of dense_wgmma.cuh with the FirstArgmax
// epilogue. A unit of work is a query-tile pair x two output columns; the
// cluster walks the `stride` doc tiles that merge into them back to back
// (each tile's two 128-doc halves are separate TMA boxes, one per column),
// and the consumers carry (max, id) per row in shared memory across them, so
// the stride merge costs no extra pass. The persistent grid's query-pair-
// fastest order runs the query tiles of a doc tile side by side, so the
// corpus leaves HBM about once: what K10's schedule does on the TPU.
#include "dense_wgmma.cuh"

namespace {

// bf16 [N, D] corpus -> (vals, ids) [M, n_out] at `stride`, tn = 128 g docs
// (n_out = N_pad / (128 stride), N_pad a multiple of tn).
int launch_group_argmax(const void* q, const void* corpus, int M, int N, int D, int n_real,
                        int n_out, int g, int stride, void* vals, void* ids, void* stream) {
  return wg::launch<wg::Bf16, 0>(
      q, corpus, nullptr, M, N, D, n_real, (n_out + 1) / 2,
      wg::FirstArgmax{static_cast<float*>(vals), static_cast<int*>(ids), n_out, stride, g,
                      g / stride},
      static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" int qfr_group_max_scores(const void* q, const void* corpus, int M, int N, int D,
                                    int n_real, int n_out, int g, int stride, void* vals,
                                    void* ids, void* stream) {
  return launch_group_argmax(q, corpus, M, N, D, n_real, n_out, g, stride, vals, ids, stream);
}

extern "C" int qfr_streaming_group_max(const void* q, const void* corpus, int M, int N, int D,
                                       int n_real, int n_groups, void* vals, void* ids,
                                       void* stream) {
  return launch_group_argmax(q, corpus, M, N, D, n_real, n_groups, 1, 1, vals, ids, stream);
}
