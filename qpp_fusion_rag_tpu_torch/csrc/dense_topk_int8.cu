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
// Design: one 256-thread block computes 128 queries x 128 docs (exactly one
// output group per row) with mma.sync m16n8k32 s8 -> s32 (8 warps, each a
// 32 x 64 sub-tile), staging 64-byte K slices of both operands through
// shared memory with a 16-byte row pad (conflict-free fragment loads).
// Block order puts the query tiles of one corpus tile next to each other, so
// a corpus tile is fetched from HBM once and re-read from L2. The epilogue
// follows the TPU kernel bit for bit: exact int32 -> f32 conversion, ONE
// rounding for the scale product (__fmul_rn, no contraction), the -3e38 pad
// mask, lane packing, and a FLOAT max (fmaxf, not an integer max: negative
// scores order inversely as integers). Built without flush-to-zero: a zero
// score packs into a denormal that must survive the max.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 64;
constexpr int kLds = kBK + 16;  // bytes per shared-memory row
constexpr int kThreads = 256;
constexpr float kNegFinite = -3.0e38f;

__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(kThreads) group_max_packed_int8_kernel(
    const int8_t* __restrict__ q, const int8_t* __restrict__ c,
    const float* __restrict__ scale, int M, int N, int D, int n_real, int m_tiles,
    float* __restrict__ out) {
  __shared__ __align__(16) int8_t As[kBM * kLds];
  __shared__ __align__(16) int8_t Bs[kBN * kLds];
  __shared__ float red[2][kBM];

  const int m_tile = blockIdx.x % m_tiles;
  const long long n_tile = blockIdx.x / m_tiles;
  const int m0 = m_tile * kBM;
  const long long n0 = n_tile * kBN;
  const int G = (N + kBN - 1) / kBN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3;   // rows wm*32 .. +32
  const int wn = warp >> 2;  // cols wn*64 .. +64
  const int g = lane >> 2, tg = lane & 3;

  int acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

  for (int k0 = 0; k0 < D; k0 += kBK) {
    // 128 rows x 4 chunks of 16 bytes per operand; zero past M, N or D
    for (int ch = tid; ch < kBM * (kBK / 16); ch += kThreads) {
      const int r = ch >> 2, cc = (ch & 3) * 16, kk = k0 + cc;
      int4 va = make_int4(0, 0, 0, 0), vb = make_int4(0, 0, 0, 0);
      if (m0 + r < M && kk < D)
        va = __ldg(reinterpret_cast<const int4*>(q + static_cast<long long>(m0 + r) * D + kk));
      if (n0 + r < N && kk < D)
        vb = __ldg(reinterpret_cast<const int4*>(c + (n0 + r) * D + kk));
      *reinterpret_cast<int4*>(As + r * kLds + cc) = va;
      *reinterpret_cast<int4*>(Bs + r * kLds + cc) = vb;
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      unsigned a[2][4], b[8][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        // A fragment: rows g / g+8, bytes tg*4 .. +3 and +16
        const int8_t* p = As + (wm * 32 + mi * 16 + g) * kLds + ks + tg * 4;
        a[mi][0] = *reinterpret_cast<const unsigned*>(p);
        a[mi][1] = *reinterpret_cast<const unsigned*>(p + 8 * kLds);
        a[mi][2] = *reinterpret_cast<const unsigned*>(p + 16);
        a[mi][3] = *reinterpret_cast<const unsigned*>(p + 8 * kLds + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        // B fragment (column-major K x N = doc rows): doc g, bytes tg*4 and +16
        const int8_t* p = Bs + (wn * 64 + ni * 8 + g) * kLds + ks + tg * 4;
        b[ni][0] = *reinterpret_cast<const unsigned*>(p);
        b[ni][1] = *reinterpret_cast<const unsigned*>(p + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
    }
    __syncthreads();
  }

  // epilogue: accumulator e of (mi, ni) is row g (+8 for e >= 2), col tg*2 + (e & 1)
  float rmax[2][2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) rmax[mi][0] = rmax[mi][1] = -INFINITY;
#pragma unroll
  for (int ni = 0; ni < 8; ++ni) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = wn * 64 + ni * 8 + tg * 2 + e;
      const long long n = n0 + col;
      const float sc = n < N ? __ldg(scale + n) : 0.0f;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v = __fmul_rn(__int2float_rn(acc[mi][ni][2 * h + e]), sc);
          if (n >= n_real) v = kNegFinite;
          const int bits = (__float_as_int(v) & ~0x7F) | col;  // col & 0x7F == col
          rmax[mi][h] = fmaxf(rmax[mi][h], __int_as_float(bits));
        }
      }
    }
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = rmax[mi][h];
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
      if (tg == 0) red[wn][wm * 32 + mi * 16 + h * 8 + g] = v;
    }
  }
  __syncthreads();
  if (tid < kBM && m0 + tid < M)
    out[static_cast<long long>(m0 + tid) * G + n_tile] = fmaxf(red[0][tid], red[1][tid]);
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
