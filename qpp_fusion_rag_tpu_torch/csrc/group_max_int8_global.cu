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
// Bound on the H100: int8 tensor-core arithmetic, as K1: at [1024, 768] x
// 2,621,440 docs, 4.1e12 int8 ops (2.08 ms at 1,979 TOP/s) against a
// 2.0 GB corpus (0.60 ms at 3.35 TB/s).
//
// Design: K1's TMA + wgmma main loop of dense_wgmma.cuh (m64n256k32
// .s32.s8.s8, a persistent grid of two-CTA clusters) with no scale traffic
// (S8Unscaled: no per-doc scale load, no staging barrier) and the int32
// epilogue policy PackedIMax: shift, or, integer max, no float conversion.
#include "dense_wgmma.cuh"

extern "C" int qfr_group_max_int8_global(const void* q, const void* corpus_rows, int M, int N,
                                         int D, int n_real, void* out, void* stream) {
  return wg::launch_packed_group_max<wg::S8Unscaled, 0>(
      q, corpus_rows, nullptr, M, N, D, n_real, static_cast<int*>(out),
      static_cast<cudaStream_t>(stream));
}
