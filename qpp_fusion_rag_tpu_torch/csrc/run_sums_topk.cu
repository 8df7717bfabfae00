// The "sort" engine's run totals and their exact top-k, one launch a view.
//
// Replaces no TPU kernel: the JAX package's "sort" engine is plain XLA (a
// blocked cumsum, running maxima, lax.top_k). The port ran it as
// ops/segment.py:segmented_topk_presorted, ~118 small kernels a view on an
// H100 (the blocked cumsum's per-column adds and stacks, two cummax, a
// full-row stable radix sort to keep 100): 12.4 ms of a 24.9 ms ensemble
// step. This kernel was added for that.
//
// Contract: sids int32 [B, M], ascending along each row, SENTINEL
// (2^31 - 1) last; svals f32 [B, M]; 1 <= k <= min(M, kMaxK) -> the k best
// run totals, descending, ties to the lowest position (the lowest doc id),
// as f32 scores and int32 ids, -inf / -1 where fewer runs are real. Bit for
// bit what segmented_topk_presorted(sids, svals, k) gives on the card:
//   vmin = min(min over the row of svals, 0); sv = svals - vmin;
//   c = cumsum_blocked(sv) in XLA-CPU's association: sequential within
//     blocks of 16 (a ragged last block padded with 0), the block totals'
//     own blocked cumsum, recursively, and c[i] = within[i] + prefix[block]
//     (prefix 0 for block 0; a row of at most 16 is one sequential sum);
//   at each run end i: total = (c[i] - prev) + vmin * count, prev the
//     running MAXIMUM of c over earlier run ends (0 where none; across
//     blocks c can step down by an ulp, so it is not the latest run end's
//     c), count the run's length; -inf elsewhere and on SENTINEL runs;
//   then topk_first's order (row_select.cuh).
// Every add, subtract and multiply is an explicit round-to-nearest
// intrinsic, so nvcc fuses none into an FMA. The SENTINEL positions of a
// row come after every real one and c at a real position depends only on
// sv before it, so sv is not masked there; nor does the sign of a zero
// change a total (every zero total comes out +0.0 either way).
//
// Bound: bytes. Each pair is read once (4 B id, 4 B value) and each winner
// written once (4 B score, 4 B id), plus its id read again: 8 B M + 12 B k a
// row; 1024 x 32,768 at k 100 is 0.0805 ms at 3.35 TB/s, 1024 x 16,384
// 0.0404 ms.
//
// Design: one CTA of 512 threads a row; thread t owns the 16-pair blocks
// t, t + 512, ... (a tile is 512 blocks).
//  A. The values stream into shared memory (16-byte loads, four in flight a
//     thread), each block's four 16-byte words permuted within it so that
//     the threads' reads of whole blocks hit distinct banks; the row's
//     minimum gives vmin.
//  B. Each thread sums its blocks sequentially; the block totals and the
//     tree of their blocked cumsum (M/16 + M/256 + ... floats) are built in
//     shared memory, level by level.
//  C. Tile by tile, each thread sums its blocks again, adds the block's
//     prefix, reads the ids (16-byte loads) for the run ends and validity,
//     and a block-wide scan of (max c, last run end) over the tile (plus the
//     carry of the tiles before) gives each block its prev and its count
//     base; the totals overwrite the block in place, -inf off the run ends.
//  D. row_select.cuh's select_topk over the totals row; the winners' ids are
//     read from the id row in global memory.
//  Rows of at most kMaxStaged pairs are staged: 4 M + 16 KB + the tree in
//  shared memory, two CTAs an SM at 16,384, one at 32,768. Wider rows read
//  their values from global memory (still in L2) in each pass, and write the
//  totals and the tree to a global scratch row, which the selection reads.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "row_select.cuh"

namespace {

using namespace row_select;

constexpr int kBlock = 16;             // XLA-CPU's cumsum block
constexpr int kMaxStaged = 49152;      // the widest row that shared memory stages
constexpr int kMaxLevels = 8;          // tree levels of any int32 width
constexpr int kSentinel = 0x7fffffff;

// Floats of the tree of block totals over a row of M (none at M <= 16):
// ceil(M / 16), then ceil of that / 16, ... down to a level of at most 16.
__host__ __device__ constexpr int tree_floats(int M) {
  int total = 0;
  if (M > kBlock) {
    for (int n = (M + kBlock - 1) / kBlock;; n = (n + kBlock - 1) / kBlock) {
      total += n;
      if (n <= kBlock) break;
    }
  }
  return total;
}

constexpr size_t staged_smem(int M) {
  return 4 * static_cast<size_t>((M + kBlock - 1) / kBlock * kBlock) +
         8 * static_cast<size_t>(kSortCap) + 4 * static_cast<size_t>(tree_floats(M));
}

static_assert(staged_smem(kMaxStaged) + 1024 <= 227 * 1024, "the staged row fits an SM");

// Where the staged row keeps the 16-byte word c: words permuted within
// their block, (c & 3) ^ ((block >> 1) & 3), so that the eight lanes of a
// 16-byte shared access, each reading word q of its own block, hit
// distinct banks.
__device__ __forceinline__ int word_slot(int c) {
  return (c & ~3) | ((c & 3) ^ ((c >> 3) & 3));
}

// Block b's 16 values (0 past M) into x, from the staged row (permuted
// words) or from global memory (vec: 16-byte loads).
template <bool kStaged>
__device__ __forceinline__ void load_block(const float* src, int b, int M, bool vec,
                                           float (&x)[kBlock]) {
  const int base = b * kBlock;
  if (kStaged || (vec && base + kBlock <= M)) {
    const float4* src4 = reinterpret_cast<const float4*>(src);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 v = src4[kStaged ? word_slot(4 * b + q) : 4 * b + q];
      x[4 * q] = v.x;
      x[4 * q + 1] = v.y;
      x[4 * q + 2] = v.z;
      x[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int p = 0; p < kBlock; ++p) x[p] = base + p < M ? src[base + p] : 0.0f;
  }
}

// Block b's within-block prefix sums of sv = x - vmin (0 past M), in place.
__device__ __forceinline__ void within_sums(float (&x)[kBlock], int base, int M, float vmin) {
  float acc = 0.0f;
#pragma unroll
  for (int p = 0; p < kBlock; ++p) {
    const float sv = base + p < M ? __fsub_rn(x[p], vmin) : 0.0f;
    acc = p == 0 ? sv : __fadd_rn(acc, sv);
    x[p] = acc;
  }
}

// lv[0, n) holds the block totals T (n > 1); on return it holds
// cumsum_blocked(T), with the higher levels after it: blocks of 16 summed
// in place (each block's total to the next level), the top level (at most
// 16) summed by one thread, then each level's blocks plus the prefix of the
// level above, top down.
__device__ void tree_cumsum(float* lv, int n) {
  int off[kMaxLevels], len[kMaxLevels];
  int L = 0;
  off[0] = 0;
  len[0] = n;
  while (len[L] > kBlock) {
    const int nb = (len[L] + kBlock - 1) / kBlock;
    float* a = lv + off[L];
    float* t = a + len[L];
    for (int b = threadIdx.x; b < nb; b += kThreads) {
      float acc = a[b * kBlock];
      for (int j = 1; j < kBlock; ++j) {
        const int i = b * kBlock + j;
        acc = __fadd_rn(acc, i < len[L] ? a[i] : 0.0f);
        if (i < len[L]) a[i] = acc;
      }
      t[b] = acc;
    }
    __syncthreads();
    off[L + 1] = off[L] + len[L];
    len[L + 1] = nb;
    ++L;
  }
  if (threadIdx.x == 0) {
    float* a = lv + off[L];
    for (int i = 1; i < len[L]; ++i) a[i] = __fadd_rn(a[i - 1], a[i]);
  }
  __syncthreads();
  for (int l = L - 1; l >= 0; --l) {
    float* a = lv + off[l];
    const float* c = lv + off[l + 1];
    for (int i = threadIdx.x; i < len[l]; i += kThreads) {
      const int b = i / kBlock;
      a[i] = __fadd_rn(a[i], b == 0 ? 0.0f : c[b - 1]);
    }
    __syncthreads();
  }
}

// kStaged: the row is staged in shared memory (M <= kMaxStaged); otherwise
// its values are read from global memory in each pass and the totals and
// the tree go to `scratch` (tree_floats(M) + M rounded up to 16, rounded up
// to 4 floats a row).
template <bool kStaged>
__global__ void __launch_bounds__(kThreads, 2) run_sums_topk_kernel(
    const int* __restrict__ sids, const float* __restrict__ svals, int M, int k, int vec,
    float* __restrict__ scratch, float* __restrict__ out_scores, int* __restrict__ out_ids) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Shared sh;
  __shared__ float s_min[kWarps];
  __shared__ float s_c[2][kWarps];
  __shared__ int s_p[2][kWarps];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nb = (M + kBlock - 1) / kBlock, Mp = nb * kBlock;
  const size_t r = blockIdx.x;
  const int* sid = sids + r * M;
  const float* sval = svals + r * M;
  float* row;      // the staged values, then the totals
  float* lv;       // the tree
  uint64_t* buf;   // the selection's buffer
  if (kStaged) {
    row = reinterpret_cast<float*>(smem);
    buf = reinterpret_cast<uint64_t*>(row + Mp);
    lv = reinterpret_cast<float*>(buf + kSortCap);
  } else {
    row = scratch + r * static_cast<size_t>((Mp + tree_floats(M) + 3) & ~3);
    lv = row + Mp;
    buf = reinterpret_cast<uint64_t*>(smem);
  }
  const float* src = kStaged ? row : sval;

  // A. stage the values; the row's minimum
  float mn = INFINITY;
  if (vec) {
    const float4* sval4 = reinterpret_cast<const float4*>(sval);
    float4* row4 = reinterpret_cast<float4*>(row);
    const int n4 = M >> 2;
    for (int c0 = tid; c0 < n4; c0 += 4 * kThreads) {
      float4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (c0 + u * kThreads < n4) v[u] = kStaged ? __ldcs(sval4 + c0 + u * kThreads)
                                                   : sval4[c0 + u * kThreads];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (c0 + u * kThreads < n4) {
          if (kStaged) row4[word_slot(c0 + u * kThreads)] = v[u];
          mn = fminf(mn, fminf(fminf(v[u].x, v[u].y), fminf(v[u].z, v[u].w)));
        }
    }
  } else {
    for (int i = tid; i < M; i += kThreads) {
      const float v = kStaged ? __ldcs(sval + i) : sval[i];
      if (kStaged) row[4 * word_slot(i >> 2) + (i & 3)] = v;
      mn = fminf(mn, v);
    }
  }
  for (int o = 16; o > 0; o >>= 1) mn = fminf(mn, __shfl_xor_sync(kFull, mn, o));
  if (lane == 0) s_min[warp] = mn;
  __syncthreads();
  for (int w = 0; w < kWarps; ++w) mn = fminf(mn, s_min[w]);
  const float vmin = fminf(mn, 0.0f);

  // B. the block totals, then their blocked cumsum
  const int tiles = (nb + kThreads - 1) / kThreads;
  if (nb > 1) {
    for (int b = tid; b < nb; b += kThreads) {
      float x[kBlock];
      load_block<kStaged>(src, b, M, vec, x);
      within_sums(x, b * kBlock, M, vmin);
      lv[b] = x[kBlock - 1];
    }
    __syncthreads();
    tree_cumsum(lv, nb);
  }

  // C. the totals, tile by tile
  uint32_t mx = 0;
  float carry_c = -INFINITY;  // max c over the run ends of the tiles before
  int carry_p = -1;           // their last run end
  for (int j = 0; j < tiles; ++j) {
    const int b = j * kThreads + tid, base = b * kBlock;
    const bool has = b < nb;
    int s[kBlock];
    if (has && vec && base + kBlock <= M) {
      const int4* sid4 = reinterpret_cast<const int4*>(sid + base);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int4 v = __ldcs(sid4 + q);
        s[4 * q] = v.x;
        s[4 * q + 1] = v.y;
        s[4 * q + 2] = v.z;
        s[4 * q + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int p = 0; p < kBlock; ++p) s[p] = has && base + p < M ? sid[base + p] : kSentinel;
    }
    // the id after the block: the next lane's first, else from memory
    int next = __shfl_down_sync(kFull, s[0], 1);
    if (has && lane == 31 && base + kBlock < M) next = sid[base + kBlock];
    uint32_t ends = 0, real = 0;   // run ends; positions of real (not SENTINEL) ids
#pragma unroll
    for (int p = 0; p < kBlock; ++p) {
      const int pos = base + p;
      const int nxt = p + 1 < kBlock ? s[p + 1] : next;
      if (has && pos < M && (pos == M - 1 || s[p] != nxt)) ends |= 1u << p;
      if (s[p] != kSentinel) real |= 1u << p;
    }
    float x[kBlock];
    float bc = -INFINITY;
    int bp = -1;
    if (has) {
      load_block<kStaged>(src, b, M, vec, x);
      within_sums(x, base, M, vmin);
      if (nb > 1) {
        const float pre = b == 0 ? 0.0f : lv[b - 1];
#pragma unroll
        for (int p = 0; p < kBlock; ++p) x[p] = __fadd_rn(x[p], pre);
      }
#pragma unroll
      for (int p = 0; p < kBlock; ++p)
        if (ends >> p & 1u) {
          bc = fmaxf(bc, x[p]);
          bp = base + p;
        }
    }
    // exclusive scan of (max c, last run end) over the tile's blocks
    float ic = bc;
    int ip = bp;
    for (int o = 1; o < 32; o <<= 1) {
      const float nc = __shfl_up_sync(kFull, ic, o);
      const int np = __shfl_up_sync(kFull, ip, o);
      if (lane >= o) {
        ic = fmaxf(ic, nc);
        ip = max(ip, np);
      }
    }
    if (lane == 31) {
      s_c[j & 1][warp] = ic;
      s_p[j & 1][warp] = ip;
    }
    __syncthreads();
    float pc = __shfl_up_sync(kFull, ic, 1);
    int pp = __shfl_up_sync(kFull, ip, 1);
    if (lane == 0) {
      pc = -INFINITY;
      pp = -1;
    }
    pc = fmaxf(pc, carry_c);
    pp = max(pp, carry_p);
    for (int w = 0; w < kWarps; ++w) {
      const float wc = s_c[j & 1][w];
      const int wp = s_p[j & 1][w];
      if (w < warp) {
        pc = fmaxf(pc, wc);
        pp = max(pp, wp);
      }
      carry_c = fmaxf(carry_c, wc);
      carry_p = max(carry_p, wp);
    }
    if (has) {
#pragma unroll
      for (int p = 0; p < kBlock; ++p) {
        const int pos = base + p;
        float total = -INFINITY;
        if (ends >> p & 1u) {
          if (real >> p & 1u)
            total = __fadd_rn(__fsub_rn(x[p], pc == -INFINITY ? 0.0f : pc),
                              __fmul_rn(vmin, static_cast<float>(pos - pp)));
          pc = fmaxf(pc, x[p]);
          pp = pos;
        }
        if (pos < M) mx = max(mx, order_key(__float_as_uint(total)));
        x[p] = total;
      }
      float4* row4 = reinterpret_cast<float4*>(row + base);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        row4[q] = make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
    }
  }
  __syncthreads();

  // D. the k best totals; the winners' ids from the id row
  float* scores = out_scores + r * k;
  int* ids = out_ids + r * k;
  select_topk(reinterpret_cast<const uint32_t*>(row), M, k, true, mx, buf, sh,
              [&](int i, int col) {
                const float v = row[col];
                const bool ok = fabsf(v) < INFINITY;
                scores[i] = ok ? v : -INFINITY;
                ids[i] = ok ? sid[col] : -1;
              });
}

}  // namespace

// Floats of global scratch a row needs: 0 where the row is staged.
extern "C" int qfr_run_sums_scratch(int M) {
  if (M <= kMaxStaged) return 0;
  return ((M + kBlock - 1) / kBlock * kBlock + tree_floats(M) + 3) & ~3;
}

extern "C" int qfr_run_sums_topk(const void* sids, const void* svals, int B, int M, int k,
                                 int vec, void* scratch, void* scores, void* ids, void* stream) {
  if (B < 1 || M < 1 || k < 1 || k > kMaxK || k > M)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool staged = M <= kMaxStaged;
  if (!staged && scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = staged ? staged_smem(M) : 8 * static_cast<size_t>(kSortCap);
  const auto kernel = staged ? run_sums_topk_kernel<true> : run_sums_topk_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(B), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(sids), static_cast<const float*>(svals), M, k, vec,
      static_cast<float*>(scratch), static_cast<float*>(scores), static_cast<int*>(ids));
  return static_cast<int>(cudaGetLastError());
}
