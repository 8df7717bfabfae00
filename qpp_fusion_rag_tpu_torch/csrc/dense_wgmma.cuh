// The Hopper main loop of the packed dense group-max kernels K1
// (dense_topk_int8.cu, s8) and K7 (group_max_packed.cu, bf16, corpus as
// rows [N, D] or as [D, N]): TMA loads into a ring of shared-memory stages,
// wgmma on two consumer warpgroups, a persistent grid of two-CTA clusters.
//
// One block of 384 threads per SM computes output tiles of 128 queries x
// 256 docs (two 128-doc groups). The two CTAs of a cluster take query tiles
// 2p and 2p + 1 of the same doc tile: each loads its own queries and half
// of the doc tile, multicast into both CTAs' shared memory, so a doc stage
// leaves L2 once per cluster (32 KB of L2 reads per CTA and stage instead of
// 48 KB, and half the TMA requests; on an H100 this made the [D, N] layout
// 18 % faster and the others 3-5 %). Tile pairs go query-pair fastest, so
// the query tiles of one doc tile run at about the same time on the card:
// the doc tile leaves HBM about once, and the queries stay in L2 (7.9 MB in
// bf16 at 5,120 rows).
//
//   warpgroup 0  producer: one lane of warp 0 issues the TMA copies of every
//                K stage (queries 128 rows x 128 bytes, its half of the docs
//                128 x 128 bytes) into a ring of kStages stages, each guarded
//                by a full mbarrier (48 KB of transactions: its own copies and the
//                peer's multicast) and an empty one (one arrival from each
//                consumer warpgroup of BOTH CTAs, since the multicast writes
//                both); it runs ahead into the next tile while the consumers
//                finish the epilogue. setmaxnreg gives its registers to the
//                consumers.
//   warpgroups 1, 2  consumers: each owns 64 query rows x 256 docs in 128
//                f32 (bf16) or s32 (s8) accumulators per thread, issued as
//                wgmma m64n256k16 .f32.bf16.bf16 or m64n256k32 .s32.s8.s8,
//                4 per 128-byte K stage, one wgmma group kept in flight.
//
// Shared-memory layout: TMA writes each 128-byte row with the 128-byte
// swizzle (16-byte chunk c of row r at chunk c ^ (r & 7)); each stage
// buffer starts on 1024 bytes. The wgmma descriptors say the same thing:
// layout type 1 (128-byte swizzle); for a K-major operand (queries, doc
// rows) the stride between 8-row groups (SBO) is 1024 bytes and a k step
// of 32 bytes advances the start address; for K7's [D, N] corpus (MN-major,
// read with wgmma's B-transpose bit, bf16 only) a stage is four TMA boxes
// of 64 docs x 64 k-rows (two from each CTA), the 8-k-row groups 1024
// bytes apart (SBO), the 64-doc blocks 8192 bytes apart (LBO), and a k16
// step advances 2048 bytes.
// TMA zero-fills rows and columns outside the tensors, which covers a
// ragged M, N or D; the epilogue masks docs n >= n_real itself.
//
// Accumulator register 4j + 2h + e of a consumer thread (warp w of its
// warpgroup, lane = 4g + tg) holds tile row 16w + g + 8h and tile column
// 8j + 2tg + e, j = 0..31: each row's 128 columns of a group sit in one
// quad of lanes, so a group max needs the thread's own 32 values and two
// quad shuffles, with no shared memory and no block barrier.
//
// Host side: the tensor maps are encoded with cuTensorMapEncodeTiled taken
// from the driver through cudaGetDriverEntryPoint (no -lcuda at link time)
// and passed as __grid_constant__ kernel parameters.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace wg {

constexpr int kBM = 128;                 // query rows per tile (2 consumer warpgroups)
constexpr int kBN = 256;                 // docs per tile (two 128-doc groups)
constexpr int kBK = 128;                 // K bytes per stage (128 s8 or 64 bf16)
constexpr int kStages = 4;
constexpr int kThreads = 384;
constexpr int kABytes = kBM * kBK;       // 16 KB
constexpr int kBBytes = kBN * kBK;       // 32 KB
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kTransBox = 64;            // docs (and k-rows) per [D, N] TMA box
constexpr int kCluster = 2;              // CTAs per cluster: two query tiles, one doc tile
constexpr float kNegFinite = -3.0e38f;   // packed pad score: finite, so no NaN

struct Smem {
  uint8_t a[kStages][kABytes];
  uint8_t b[kStages][kBBytes];
  uint64_t full[kStages];
  uint64_t empty[kStages];
  float scale[2][kBN];                   // K1: per-doc scales, one copy per consumer
};
constexpr size_t kSmemBytes = sizeof(Smem) + 1024;   // + room to align the base to 1024

// ------------------------------------------------------------------ PTX ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Spin until the barrier's phase differs from `parity`. A wait of 2^35
// cycles (about 18 s) can only be a lost arrival: trap, so the launch
// fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1ll << 35)) __trap();
}

// One 2-D TMA box: global coordinates (c0 innermost, c1) -> shared dst;
// completion counts its bytes on `bar`.
__device__ __forceinline__ void tma_load(const CUtensorMap* map, void* dst, uint64_t* bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// The same box multicast into the shared memory of every CTA in `mask`,
// at the same offsets, counting its bytes on each CTA's `bar`.
__device__ __forceinline__ void tma_load_multicast(const CUtensorMap* map, void* dst, uint64_t* bar,
                                                   int c0, int c1, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "h"(mask)
      : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of the cluster: arrive (release) and wait (acquire).
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}

// Arrive on the barrier at the same offset in CTA `cta` of the cluster.
// Default (.release.cta) semantics, as CUTLASS's cluster barrier arrives:
// .release.cluster made the whole loop twice as slow on an H100.
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar, uint32_t cta) {
  uint32_t addr;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(addr)
               : "r"(smem_u32(bar)), "r"(cta));
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(addr) : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle (layout type 1).
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma boundaries (fence, wait).
template <class T>
__device__ __forceinline__ void fence_acc(T (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) {
    if constexpr (std::is_same<T, float>::value)
      asm volatile("" : "+f"(d[i])::"memory");
    else
      asm volatile("" : "+r"(d[i])::"memory");
  }
}

#define QFR_WG_REGS                                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                 \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "        \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "        \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "        \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "        \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "        \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "   \
  "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, "     \
  "%125, %126, %127}"
#define QFR_WG_D4(c, i) "+" c(d[i]), "+" c(d[i + 1]), "+" c(d[i + 2]), "+" c(d[i + 3])
#define QFR_WG_D16(c, i) \
  QFR_WG_D4(c, i), QFR_WG_D4(c, i + 4), QFR_WG_D4(c, i + 8), QFR_WG_D4(c, i + 12)
#define QFR_WG_D128(c)                                                                 \
  QFR_WG_D16(c, 0), QFR_WG_D16(c, 16), QFR_WG_D16(c, 32), QFR_WG_D16(c, 48),           \
      QFR_WG_D16(c, 64), QFR_WG_D16(c, 80), QFR_WG_D16(c, 96), QFR_WG_D16(c, 112)

// d (+)= A[64 x 32 bytes] . B[256 x 32 bytes]^T; scale_d = 0 overwrites d.
struct S8 {
  using Acc = int;
  static constexpr int kElem = 1;          // bytes per value
  static constexpr bool kScaled = true;    // per-doc scales (K1)
  template <int kTransB>
  static __device__ __forceinline__ void mma(int (&d)[128], uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
    static_assert(kTransB == 0, "s8 wgmma takes both operands K-major");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 " QFR_WG_REGS
        ", %128, %129, p;\n}\n"
        : QFR_WG_D128("r")
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }
};

struct Bf16 {
  using Acc = float;
  static constexpr int kElem = 2;
  static constexpr bool kScaled = false;
  template <int kTransB>
  static __device__ __forceinline__ void mma(float (&d)[128], uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " QFR_WG_REGS
        ", %128, %129, p, 1, 1, 0, %131;\n}\n"
        : QFR_WG_D128("f")
        : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(kTransB));
  }
};

#undef QFR_WG_D128
#undef QFR_WG_D16
#undef QFR_WG_D4
#undef QFR_WG_REGS

// Named barrier over one consumer warpgroup's 128 threads (ids 1, 2).
__device__ __forceinline__ void wg_bar(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// ---------------------------------------------------------------- kernel ---

// out[m, g] = max over the 128 docs n of group g of
//   pack(score(m, n), lane = n & 127),  pack(v, l) = bits(v) & ~0x7F | l,
// score = float(acc) * scale[n] (Op::kScaled, exact int32 -> f32 and ONE
// rounding of the product, __fmul_rn) or acc, and -3e38 for n >= n_real;
// the max is a FLOAT max (fmaxf). Built without flush-to-zero: a zero score
// packs into a denormal that must survive the max.
template <class Op, int kTransB>
__global__ void __launch_bounds__(kThreads, 1)
    packed_group_max(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_c, const float* __restrict__ scale,
                     int M, int N, int n_real, int k_iters, int m_tiles, int n_tiles,
                     float* __restrict__ out) {
  extern __shared__ uint8_t smem_raw[];
  // pointer arithmetic on the shared array (not an integer round trip), so
  // the compiler keeps shared-memory loads for the scales
  Smem& s = *reinterpret_cast<Smem*>(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  const int wgi = threadIdx.x / 128;
  // a cluster takes query tiles 2p and 2p + 1 of one doc tile (pair p);
  // pairs go query-pair fastest
  const int rank = static_cast<int>(cluster_rank());
  const int m_pairs = (m_tiles + kCluster - 1) / kCluster;
  const int num_pairs = m_pairs * n_tiles;
  const int cid = blockIdx.x / kCluster, n_clusters = gridDim.x / kCluster;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&s.full[i], 1);
      mbar_init(&s.empty[i], 2 * kCluster);   // each consumer warpgroup of the cluster
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();                           // the peer's barriers exist before any use

  if (wgi == 0) {
    // ------------------------------------------------------- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x < 32) {
      // each CTA loads its own queries and HALF the doc tile, multicast to
      // both CTAs: the doc tile leaves L2 once per cluster, not per CTA.
      // A stage is refilled only when the consumers of both CTAs freed it.
      // The whole warp walks the loop and lane 0 issues, so the warp stays
      // converged up to the final cluster barrier.
      constexpr uint16_t kBoth = (1 << kCluster) - 1;
      const bool issue = threadIdx.x == 0;
      int it = 0;
      for (int p = cid; p < num_pairs; p += n_clusters) {
        const int m0 = ((p % m_pairs) * kCluster + rank) * kBM;
        const int n0 = (p / m_pairs) * kBN;
        for (int kb = 0; kb < k_iters; ++kb, ++it) {
          const int st = it % kStages;
          mbar_wait(&s.empty[st], ((it / kStages) & 1) ^ 1);
          if (issue) {
            mbar_expect_tx(&s.full[st], kStageBytes);
            const int k0 = kb * (kBK / Op::kElem);   // K coordinate in values
            tma_load(&map_q, s.a[st], &s.full[st], k0, m0);
            if (kTransB) {
#pragma unroll
              for (int j = rank * 2; j < rank * 2 + 2; ++j)
                tma_load_multicast(&map_c, s.b[st] + j * kTransBox * kBK, &s.full[st],
                                   n0 + j * kTransBox, k0, kBoth);
            } else {
              const int half = rank * (kBN / kCluster);
              tma_load_multicast(&map_c, s.b[st] + half * kBK, &s.full[st], k0, n0 + half,
                                 kBoth);
            }
          }
          __syncwarp();
        }
      }
    }
    cluster_sync();                         // no CTA leaves while its peer may signal it
  } else {
    // ------------------------------------------------------- consumers ---
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = wgi - 1;                  // consumer index: query rows 64c .. 64c+63
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, tg = lane % 4;
    const int G = (N + 127) / 128;
    // a stage is free again once both CTAs' consumers are done with it
    auto release = [&](int st) {
      if (tid < kCluster) mbar_arrive_cluster(&s.empty[st], tid);
    };
    typename Op::Acc d[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) d[i] = 0;
    int it = 0;
    for (int p = cid; p < num_pairs; p += n_clusters) {
      const int m0 = ((p % m_pairs) * kCluster + rank) * kBM;
      const int n_tile = p / m_pairs;
      const int n0 = n_tile * kBN;
      float sc_reg[2];
      if constexpr (Op::kScaled) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int n = n0 + tid + 128 * i;
          sc_reg[i] = n < N ? __ldg(scale + n) : 0.0f;
        }
      }

      int prev = 0;
      fence_acc(d);                         // the previous epilogue's reads come first
      for (int kb = 0; kb < k_iters; ++kb, ++it) {
        const int st = it % kStages;
        mbar_wait(&s.full[st], (it / kStages) & 1);
        wgmma_fence();
        const uint8_t* a = s.a[st] + c * 64 * kBK;
#pragma unroll
        for (int kk = 0; kk < kBK / 32; ++kk) {
          // K-major: LBO unused by the swizzled layout (1, as CUTLASS sets it)
          const uint64_t da = desc(a + kk * 32, 16, 1024);
          const uint64_t db = kTransB ? desc(s.b[st] + kk * 16 * kBK, kTransBox * kBK, 1024)
                                      : desc(s.b[st] + kk * 32, 16, 1024);
          Op::template mma<kTransB>(d, da, db, kb > 0 || kk > 0);
        }
        wgmma_commit();
        if (kb > 0) {
          wgmma_wait<1>();                  // the previous stage's wgmmas are done
          release(prev);
        }
        prev = st;
      }
      wgmma_wait<0>();
      fence_acc(d);
      release(prev);

      if constexpr (Op::kScaled) {   // stage the tile's 256 doc scales once
        wg_bar(1 + c);                      // the previous tile's reads are done
        s.scale[c][tid] = sc_reg[0];
        s.scale[c][tid + 128] = sc_reg[1];
        wg_bar(1 + c);
      }
      // Thread-local maxima pack only the lane bits 8jj + e (bits 0 and
      // 3..6): the thread's own 2tg (bits 1..2) is the same for all its
      // values, so it cannot change which one wins; it is ORed in after.
      const float* sc = s.scale[c] + 2 * tg;
      auto group_max = [&](int grp, int h, auto masked) -> float {
        float r = -INFINITY;
#pragma unroll
        for (int jj = 0; jj < 16; ++jj) {
          const int j = grp * 16 + jj;
          float2 scale2 = make_float2(0.0f, 0.0f);
          if constexpr (Op::kScaled) scale2 = *reinterpret_cast<const float2*>(sc + 8 * j);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float v;
            if constexpr (Op::kScaled)
              v = __fmul_rn(__int2float_rn(d[4 * j + 2 * h + e]), e ? scale2.y : scale2.x);
            else
              v = d[4 * j + 2 * h + e];
            if constexpr (decltype(masked)::value)
              v = n0 + 8 * j + 2 * tg + e < n_real ? v : kNegFinite;
            r = fmaxf(r, __int_as_float((__float_as_int(v) & ~0x7F) | (8 * jj + e)));
          }
        }
        return __int_as_float(__float_as_int(r) | 2 * tg);
      };
      auto write_tile = [&](auto masked) {
#pragma unroll
        for (int grp = 0; grp < 2; ++grp) {
          const int gcol = 2 * n_tile + grp;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float v = group_max(grp, h, masked);
            v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
            v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
            const int m = m0 + 64 * c + 16 * warp + g + 8 * h;
            if (tg == 0 && m < M && gcol < G) out[static_cast<long long>(m) * G + gcol] = v;
          }
        }
      };
      if (n0 + kBN <= n_real)                 // no doc of the tile is masked
        write_tile(std::false_type{});
      else
        write_tile(std::true_type{});
    }
    cluster_sync();
  }
}

// ------------------------------------------------------------------ host ---

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
            cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// A row-major [rows, cols] tensor of `elem` bytes per value, boxes of
// box_cols x box_rows with the 128-byte swizzle (box_cols * elem == 128).
inline bool make_map(CUtensorMap* map, const void* ptr, long long rows, long long cols, int elem,
                     int box_cols, int box_rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, elem == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
            const_cast<void*>(ptr), dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Encode the maps and launch the persistent grid: clusters of two CTAs,
// as many as the card runs at once (one CTA per SM), at most one per tile
// pair. elem = 1 (s8) or 2 (bf16); the corpus is [N, D], or [D, N] when
// kTransB. -> a cudaError_t as int.
template <class Op, int kTransB>
int launch_packed_group_max(const void* q, const void* corpus, const float* scale, int M, int N,
                            int D, int n_real, float* out, cudaStream_t stream) {
  const int elem = Op::kElem;
  const int per_row = kBK / elem;                      // K values per 128-byte row
  CUtensorMap map_q, map_c;
  bool ok = make_map(&map_q, q, M, D, elem, per_row, kBM);
  ok = ok && (kTransB ? make_map(&map_c, corpus, D, N, elem, kTransBox, kTransBox)
                      : make_map(&map_c, corpus, N, D, elem, per_row, kBN / kCluster));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = packed_group_max<Op, kTransB>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int m_tiles = (M + kBM - 1) / kBM;
  const int n_tiles = (N + kBN - 1) / kBN;
  const long long pairs = static_cast<long long>((m_tiles + kCluster - 1) / kCluster) * n_tiles;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cfg.gridDim = dim3(kCluster);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (clusters < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  cfg.gridDim = dim3(kCluster * static_cast<unsigned>(pairs < clusters ? pairs : clusters));
  const int k_iters = (D + per_row - 1) / per_row;
  err = cudaLaunchKernelEx(&cfg, kernel, map_q, map_c, scale, M, N, n_real, k_iters, m_tiles,
                           n_tiles, out);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace wg
