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
// Bound on the H100: int8 tensor-core arithmetic. The ensemble's
// [1024, 768] x [768, 2,621,440] is 4.1e12 int8 ops (2.08 ms at 1,979
// TOP/s), the flagship's 5,120 rows 2.06e13 (10.42 ms); the corpus is 2.0 GB
// (0.60 ms at 3.35 TB/s). The [M, N] scores never reach device memory, only
// [M, N/128] maxima.
//
// Design: the TMA + wgmma main loop of dense_wgmma.cuh (m64n256k32
// .s32.s8.s8, both operands K-major as the [N, D] rows are; a persistent
// grid, query tiles fastest so a corpus tile leaves HBM about once). The
// epilogue follows the TPU kernel bit for bit: exact int32 -> f32
// conversion, ONE rounding for the scale product (__fmul_rn, no
// contraction) with the tile's 256 doc scales staged once in shared
// memory, the -3e38 pad mask, lane packing, and a FLOAT max. Built without
// flush-to-zero: a zero score packs into a denormal that must survive the
// max.
#include "dense_wgmma.cuh"

extern "C" int qfr_group_max_packed_int8(const void* q, const void* corpus_rows,
                                         const void* d_scale, int M, int N, int D,
                                         int n_real, void* out, void* stream) {
  return wg::launch_packed_group_max<wg::S8, 0>(
      q, corpus_rows, static_cast<const float*>(d_scale), M, N, D, n_real,
      static_cast<float*>(out), static_cast<cudaStream_t>(stream));
}
