// K7: bf16 dense scores fused with the packed 128-doc group max.
//
//   out[m, g] = max over n in [128 g, 128 g + 128) of
//               pack(dot_f32(q[m], c[n]), lane = n & 127)
//   pack(v, lane) = bits(v) & ~0x7F | lane;  docs n >= n_real score -3e38
//
// Replaces qpp_fusion_rag_tpu/ops/pallas/dense_topk.py:group_max_packed
// (_make_packed_kernel), both layouts: the corpus as rows [N, D], or as
// [D, N] (transposed=True), read in place.
//
// Bound on the H100: bf16 tensor-core arithmetic. The dense flagship's
// [5120, 768] x [768, 2,621,440] is 2.06e13 flops per step (20.85 ms at
// 989 TF/s) against a 4.03 GB corpus (1.20 ms at 3.35 TB/s). Only the
// [M, N/128] maxima reach device memory, never the [M, N] scores (419 MB
// instead of 54 GB).
//
// Design: the TMA + wgmma main loop of dense_wgmma.cuh (m64n256k16
// .f32.bf16.bf16 with f32 accumulators, a persistent grid, query tiles
// fastest so a corpus tile leaves HBM about once). The [D, N] layout is
// MN-major for wgmma: TMA brings 64-doc x 64-k boxes and the wgmma
// B-transpose bit reads them, with no transposed copy of the corpus. The
// epilogue is the TPU kernel's: the -3e38 pad mask, lane packing, a FLOAT
// max (fmaxf: among equal cleared bits it keeps the highest lane for
// positive scores and the lowest for negative ones), and no flush-to-zero
// (a zero score packs into a denormal).
#include "dense_wgmma.cuh"

extern "C" int qfr_group_max_packed(const void* q, const void* corpus, int M, int N, int D,
                                    int n_real, int transposed, void* out, void* stream) {
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (transposed)
    return wg::launch_packed_group_max<wg::Bf16, 1>(q, corpus, nullptr, M, N, D, n_real, o, st);
  return wg::launch_packed_group_max<wg::Bf16, 0>(q, corpus, nullptr, M, N, D, n_real, o, st);
}
