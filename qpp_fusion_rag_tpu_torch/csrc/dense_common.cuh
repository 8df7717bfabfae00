// The mma.sync main loop and epilogue of the dense group-max kernel K9
// (group_max_int8_global.cu). K1, K7, K8 and K10 run on the TMA + wgmma
// loop of dense_wgmma.cuh instead.
//
// One block of 256 threads (8 warps as 4 x 2, each a 32 x 64 sub-tile)
// computes a 128-query x 128-doc tile of dot products with mma.sync
// m16n8k32 s8 -> s32 on the tensor cores. A 128-doc tile is exactly one
// output group.
//
// K is staged in slices of 64 bytes per operand row, with a 16-byte row
// pad so the fragment loads hit 32 distinct banks; each slice goes global
// -> registers -> shared memory, and the next slice's global loads are in
// flight during the current slice's mma (tile_loop).
//
// Accumulator element (mi, ni, e) of warp (wm, wn), lane (g = lane / 4,
// tg = lane % 4) is tile row wm*32 + mi*16 + g + 8*(e / 2) and tile column
// wn*64 + ni*8 + tg*2 + (e % 2). The epilogue reduces each row's 128
// columns in registers, then across the 4 lanes of a quad (shuffles), then
// across the two column warps (shared memory).
#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace dense {

constexpr int kBM = 128, kBN = 128;      // queries x docs per tile; kBN = one group
constexpr int kSlice = 64;               // K bytes staged per operand row and step
constexpr int kLds = kSlice + 16;        // bytes per staged row
constexpr int kThreads = 256;

struct S8 {
  using Acc = int;
  static __device__ __forceinline__ void mma(int (&d)[4], const unsigned (&a)[4],
                                             const unsigned (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

// Thread coordinates inside a tile.
struct Lane {
  int tid, lane, wm, wn, g, tg;
  __device__ __forceinline__ Lane() {
    tid = threadIdx.x;
    lane = tid & 31;
    const int warp = tid >> 5;
    wm = warp & 3;   // rows wm*32 .. +32
    wn = warp >> 2;  // cols wn*64 .. +64
    g = lane >> 2;
    tg = lane & 3;
  }
};

template <class Acc>
__device__ __forceinline__ void zero(Acc (&acc)[2][8][4]) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = Acc(0);
}

constexpr int kChunks = kBM * (kSlice / 16) / kThreads;  // 16-byte chunks per thread (2)

// One 64-byte K slice of a 128-row operand on its way from device memory to
// shared memory. load() starts the global reads into registers and store()
// writes them out, so a kernel can start slice k+1's loads before slice
// k's mma and keep them in flight behind it.
struct RowSlice {
  int4 v[kChunks];
  // Bytes [k0b, k0b + 64) of rows r0 .. r0+127 of a row-major matrix with
  // row_bytes bytes per row (a multiple of 16); zero past `rows` and past
  // the row's end.
  __device__ __forceinline__ void load(const int8_t* src, long long r0, long long rows,
                                       int row_bytes, int k0b, int tid) {
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int ch = tid + i * kThreads, r = ch >> 2, kb = k0b + (ch & 3) * 16;
      v[i] = make_int4(0, 0, 0, 0);
      if (r0 + r < rows && kb < row_bytes)
        v[i] = __ldg(reinterpret_cast<const int4*>(src + (r0 + r) * row_bytes + kb));
    }
  }
  __device__ __forceinline__ void store(int8_t* dst, int ld, int tid) const {
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int ch = tid + i * kThreads;
      *reinterpret_cast<int4*>(dst + (ch >> 2) * ld + (ch & 3) * 16) = v[i];
    }
  }
};

__device__ __forceinline__ void load_a(unsigned (&a)[2][4], const int8_t* As, int lda,
                                       int ks, const Lane& L) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int8_t* p = As + (L.wm * 32 + mi * 16 + L.g) * lda + ks + L.tg * 4;
    a[mi][0] = *reinterpret_cast<const unsigned*>(p);
    a[mi][1] = *reinterpret_cast<const unsigned*>(p + 8 * lda);
    a[mi][2] = *reinterpret_cast<const unsigned*>(p + 16);
    a[mi][3] = *reinterpret_cast<const unsigned*>(p + 8 * lda + 16);
  }
}

// One staged 64-byte slice: A rows at As (pitch lda), doc rows at Bs
// (pitch ldb, the doc's k bytes contiguous).
template <class Op>
__device__ __forceinline__ void mma_slice(typename Op::Acc (&acc)[2][8][4], const int8_t* As,
                                          int lda, const int8_t* Bs, int ldb, const Lane& L) {
#pragma unroll
  for (int ks = 0; ks < kSlice; ks += 32) {
    unsigned a[2][4], b[8][2];
    load_a(a, As, lda, ks, L);
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const int8_t* p = Bs + (L.wn * 64 + ni * 8 + L.g) * ldb + ks + L.tg * 4;
      b[ni][0] = *reinterpret_cast<const unsigned*>(p);
      b[ni][1] = *reinterpret_cast<const unsigned*>(p + 16);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) Op::mma(acc[mi][ni], a[mi], b[ni]);
  }
}

// acc += the dot products of query rows m0 .. m0+127 (row-major, M rows)
// with doc rows n0 .. n0+127 (row-major [N, D]) over all of K; row_bytes =
// D * sizeof(element). The next slice's global loads start before the
// current slice's mma; the order of the mma steps, and so every sum, is the
// same as without them.
template <class Op>
__device__ __forceinline__ void tile_loop(typename Op::Acc (&acc)[2][8][4], int8_t* As,
                                          int8_t* Bs, const void* q, long long m0, int M,
                                          const void* c, long long n0, int N, int row_bytes,
                                          const Lane& L) {
  const int8_t* qb = static_cast<const int8_t*>(q);
  const int8_t* cb = static_cast<const int8_t*>(c);
  RowSlice a, b;
  auto load = [&](int k0b) {
    a.load(qb, m0, M, row_bytes, k0b, L.tid);
    b.load(cb, n0, N, row_bytes, k0b, L.tid);
  };
  zero(acc);
  load(0);
  for (int k0b = 0; k0b < row_bytes; k0b += kSlice) {
    a.store(As, kLds, L.tid);
    b.store(Bs, kLds, L.tid);
    __syncthreads();
    if (k0b + kSlice < row_bytes) load(k0b + kSlice);
    mma_slice<Op>(acc, As, kLds, Bs, kLds, L);
    __syncthreads();
  }
}

// ---------------------------------------------------------------- epilogues

// Packed int32 max per row: (score << 7) | col, an integer max.
template <class ScoreFn>
__device__ __forceinline__ void packed_imax_rows(ScoreFn score, int (&red)[2][kBM],
                                                 const Lane& L) {
  int rmax[2][2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) rmax[mi][0] = rmax[mi][1] = INT_MIN;
#pragma unroll
  for (int ni = 0; ni < 8; ++ni)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = L.wn * 64 + ni * 8 + L.tg * 2 + e;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // shift as unsigned: a left shift of a negative int is undefined in C++17
          const int p = static_cast<int>(
              (static_cast<unsigned>(score(mi, ni, 2 * h + e, col)) << 7) | col);
          rmax[mi][h] = max(rmax[mi][h], p);
        }
    }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int v = rmax[mi][h];
      v = max(v, __shfl_xor_sync(0xffffffffu, v, 1));
      v = max(v, __shfl_xor_sync(0xffffffffu, v, 2));
      if (L.tg == 0) red[L.wn][L.wm * 32 + mi * 16 + h * 8 + L.g] = v;
    }
  __syncthreads();
}

}  // namespace dense
