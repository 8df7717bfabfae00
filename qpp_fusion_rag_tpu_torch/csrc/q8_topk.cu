// The top-k of the q8 run sums: the selection of sparse_score_topk_q8.
//
// Replaces no TPU kernel: the JAX package takes lax.top_k (or
// lax.approx_max_k) over the dequantized sums and lets XLA lower it. The port
// took ops/segment.py:topk_first, a stable descending torch.sort of every
// whole row and a slice: on an H100 ~21 kernels a view (the cast, the
// multiply, CUB's segmented radix passes over keys and values, the index
// fill, the gathers), 9.0 ms of a 25.0 ms HotpotQA ensemble step at 32,768
// and 65,536 sums a row. This kernel was added for that.
//
// Contract: sums int32 [B, M] (a run's total at its last position, -1
// elsewhere; every total below 2^22, and below 2^15 - 1 unless `wide`, so
// that a key, sum + 1, fits 15 bits), sids int32 [B, M], wmax f32 [B]
// (positive, normal), 1 <= k <= min(M, kMaxK) -> each row's k best sums as
// scores float(sum) * wmax (one round-to-nearest multiply) and their ids
// sids[column], descending, ties to the lowest column first, -inf / -1 where
// the row has fewer than k runs: bit for bit what topk_first gives over
// where(sums >= 0, sums * wmax, -inf), masked where not finite. The order of
// the integers is the order of the scores: for integers a < b < 2^22 and a
// positive normal wmax, b wmax - a wmax >= wmax while each product's rounding
// error is below 2^-2 wmax, so distinct sums never round to one score.
//
// Bound: bytes. Each sum is read once (4 B) and each winner written once
// (4 B score, 4 B id) plus its id read: 4 M + 12 k bytes a row; 1024 x 16,384
// at k 100 is 0.0205 ms at 3.35 TB/s, 1024 x 32,768 0.0405, 1024 x 65,536
// 0.0805.
//
// Design: one CTA of 512 threads a row. The sums are small integers (at most
// 8,161 distinct at 32 terms), so one histogram finds the k-th exactly, where
// row_select.cuh's float selection needs its threshold, a compaction and,
// where many values tie, four radix passes and a round-by-round scan of the
// ties.
//  1. The row streams in with 16-byte loads (4-byte ones where it is not
//     16-byte aligned), four in flight a thread, and is staged in shared
//     memory as 16-bit keys, sum + 1 for a run and 0 for none (128 KB at
//     65,536 sums). Each thread keeps its largest key; the row's largest too.
//  2. tau from the threads' maxima (row_select.cuh's threshold): at least k
//     keys are >= tau.
//  3. One shared histogram of the keys in [max(tau, 1), row max], a bin a
//     key (8,161 bins at 32 terms), and a block scan of it from the top: the
//     k-th key T, the count `above` of keys > T and the count of keys = T.
//     A range wider than the histogram (over 8,192 keys: more than 32 terms)
//     takes a coarse pass of 2^s keys a bin first, then a fine one inside the
//     chosen bin. Every pass over a staged row compares the two keys of a
//     32-bit word at once.
//  4. Where the keys >= T are at most 2 k, all of them go into the sort
//     buffer in any order (a warp ballot, one shared atomic a warp): the
//     cells' rows, whose k-th sum ties a dozen times. Else (thousands tie at
//     T) the keys > T do, and each warp, owning a contiguous stretch of
//     columns, counts its keys equal to T; from one scan of the 16 counts
//     each warp writes its first ties after them, in column order, until k
//     are chosen. The cells' rows skip that second pass, which costs more
//     than their sort of up to 2 k pairs (PERF.md section 6, M3).
//  5. row_select.cuh's bitonic sort of the (key, ~column) pairs orders them
//     by key, then lowest column, and the first k are the answer; the scores
//     are computed from the keys and the ids read from sids at the k columns
//     only.
// Shared memory: 32 KB of histogram (the sort buffer aliases it) and the
// staged row, 2 M bytes: three CTAs an SM at 16,384 sums, two at 32,768, one
// at 65,536. Rows over kMaxStaged sums, and `wide` rows (more than 128 query
// terms), are not staged: every pass reads their sums from global memory
// again as 32-bit keys.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "row_select.cuh"

namespace {

using namespace row_select;

constexpr int kCountBins = 8192;                 // histogram bins (32 KB)
constexpr int kMaxStaged = 98304;                // the widest row staged as 16-bit keys
constexpr size_t kHistBytes = 4 * static_cast<size_t>(kCountBins);
constexpr int kChunk = 8;                        // keys a thread takes at a time (16 bytes staged)

static_assert(kHistBytes >= 8 * static_cast<size_t>(kSortCap), "the sort buffer aliases the histogram");
static_assert(kHistBytes + 2 * static_cast<size_t>(kMaxStaged) + 1024 <= 227 * 1024,
              "the staged row fits an SM");

// A sum's key: sum + 1 for a run, 0 for none.
__device__ __forceinline__ uint32_t key_of(int sum) {
  return sum >= 0 ? static_cast<uint32_t>(sum) + 1u : 0u;
}

// Two 16-bit keys a word, each below 2^15, compared at once: the top bit of
// each half is set where that half's key is >= c (c <= 2^15, c2 = c in both
// halves) or == t (t < 2^15, t2 likewise). No half borrows from the other.
constexpr uint32_t kTops = 0x80008000u, kOnes = 0x00010001u;

__device__ __forceinline__ uint32_t ge2(uint32_t w, uint32_t c2) {
  return ((w | kTops) - c2) & kTops;
}

__device__ __forceinline__ uint32_t eq2(uint32_t w, uint32_t t2) {
  return ~(((w ^ t2) | kTops) - kOnes) & kTops;
}

// Which of a chunk's eight keys pass a test. PairMask: the top bit of each
// 16-bit half of four words (ge2 / eq2), key e in half e & 1 of word e >> 1;
// BitMask: bit e for key e.
struct PairMask {
  uint32_t m[4];
  __device__ __forceinline__ bool any() const { return (m[0] | m[1] | m[2] | m[3]) != 0u; }
  __device__ __forceinline__ int count() const {
    return __popc(m[0]) + __popc(m[1]) + __popc(m[2]) + __popc(m[3]);
  }
  __device__ __forceinline__ bool has(int e) const {
    return (m[e >> 1] >> (15 + 16 * (e & 1))) & 1u;
  }
};

struct BitMask {
  uint32_t b;
  __device__ __forceinline__ bool any() const { return b != 0u; }
  __device__ __forceinline__ int count() const { return __popc(b); }
  __device__ __forceinline__ bool has(int e) const { return (b >> e) & 1u; }
};

// The keys of columns c0 .. c0 + 7 (0 past M, and 0 as constructed).
// StagedChunk: four words of two 16-bit keys from the staged row (padded with
// 0 to a multiple of 8), column c0 + 2 q in the low half of word q, tested
// two at a time. WideChunk: eight 32-bit keys read from the sums in global
// memory (16-byte loads where `vec`), tested one at a time.
struct StagedChunk {
  uint32_t w[4];
  __device__ __forceinline__ void load(const uint16_t* stage, const int*, int, bool, int c0) {
    const uint4 v = *reinterpret_cast<const uint4*>(stage + c0);
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  }
  __device__ __forceinline__ uint32_t key(int e) const {
    return (w[e >> 1] >> (16 * (e & 1))) & 0xffffu;
  }
  __device__ __forceinline__ PairMask in(uint32_t lo, uint32_t hi) const {   // lo <= key <= hi
    PairMask m;
#pragma unroll
    for (int q = 0; q < 4; ++q) m.m[q] = ge2(w[q], lo * kOnes) & ~ge2(w[q], (hi + 1) * kOnes);
    return m;
  }
  __device__ __forceinline__ PairMask ge(uint32_t c) const {
    PairMask m;
#pragma unroll
    for (int q = 0; q < 4; ++q) m.m[q] = ge2(w[q], c * kOnes);
    return m;
  }
  __device__ __forceinline__ PairMask eq(uint32_t t) const {
    PairMask m;
#pragma unroll
    for (int q = 0; q < 4; ++q) m.m[q] = eq2(w[q], t * kOnes);
    return m;
  }
};

struct WideChunk {
  uint32_t v[kChunk];
  __device__ __forceinline__ void load(const uint16_t*, const int* src, int M, bool vec, int c0) {
    if (vec && c0 + kChunk <= M) {
      const int4* src4 = reinterpret_cast<const int4*>(src + c0);
      const int4 a = src4[0], b = src4[1];
      const int s[kChunk] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
      for (int e = 0; e < kChunk; ++e) v[e] = key_of(s[e]);
    } else {
#pragma unroll
      for (int e = 0; e < kChunk; ++e) v[e] = c0 + e < M ? key_of(src[c0 + e]) : 0u;
    }
  }
  __device__ __forceinline__ uint32_t key(int e) const { return v[e]; }
  __device__ __forceinline__ BitMask in(uint32_t lo, uint32_t hi) const {
    BitMask m{0u};
#pragma unroll
    for (int e = 0; e < kChunk; ++e) m.b |= static_cast<uint32_t>(v[e] >= lo && v[e] <= hi) << e;
    return m;
  }
  __device__ __forceinline__ BitMask ge(uint32_t c) const {
    BitMask m{0u};
#pragma unroll
    for (int e = 0; e < kChunk; ++e) m.b |= static_cast<uint32_t>(v[e] >= c) << e;
    return m;
  }
  __device__ __forceinline__ BitMask eq(uint32_t t) const {
    BitMask m{0u};
#pragma unroll
    for (int e = 0; e < kChunk; ++e) m.b |= static_cast<uint32_t>(v[e] == t) << e;
    return m;
  }
};

// Exclusive prefix sum of v over the block's threads in order; *total gets
// the block's sum. part holds kWarps ints nobody else uses until the next
// barrier. One barrier.
__device__ __forceinline__ int block_scan(int v, int* part, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += n;
  }
  if (lane == 31) part[warp] = incl;
  __syncthreads();
  int before = 0, sum = 0;
  for (int w = 0; w < kWarps; ++w) {
    const int c = part[w];
    before += w < warp ? c : 0;
    sum += c;
  }
  *total = sum;
  return before + incl - v;
}

// kStaged: the row is staged in shared memory as 16-bit keys (every sum
// below 2^15 - 1, M <= kMaxStaged); otherwise every pass reads the sums from
// global memory again as 32-bit keys.
template <bool kStaged>
__global__ void __launch_bounds__(kThreads, 2) q8_topk_kernel(
    const int* __restrict__ sums, const int* __restrict__ sids, const float* __restrict__ wmax,
    int M, int k, int vec, float* __restrict__ out_scores, int* __restrict__ out_ids) {
  using Chunk = typename std::conditional<kStaged, StagedChunk, WideChunk>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* hist = reinterpret_cast<uint32_t*>(smem);
  uint64_t* buf = reinterpret_cast<uint64_t*>(smem);         // aliases hist
  uint16_t* stage = reinterpret_cast<uint16_t*>(smem + kHistBytes);
  __shared__ Shared sh;
  __shared__ uint32_t s_max[kWarps];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t r = blockIdx.x;
  const int* src = sums + r * M;
  const int* sid = sids + r * M;
  const int Mp = (M + kChunk - 1) & ~(kChunk - 1);
  const int chunks = Mp / kChunk;

  // 1. stage the keys; each thread's largest
  uint32_t mx = 0;
  if (vec) {
    const int4* src4 = reinterpret_cast<const int4*>(src);
    uint2* stage2 = reinterpret_cast<uint2*>(stage);
    const int n4 = M >> 2;
    for (int c0 = tid; c0 < n4; c0 += 4 * kThreads) {
      int4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (c0 + u * kThreads < n4)
          v[u] = kStaged ? __ldcs(src4 + c0 + u * kThreads) : src4[c0 + u * kThreads];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (c0 + u * kThreads < n4) {
          const uint32_t a = key_of(v[u].x), b = key_of(v[u].y), c = key_of(v[u].z),
                         d = key_of(v[u].w);
          if (kStaged) stage2[c0 + u * kThreads] = make_uint2(a | b << 16, c | d << 16);
          mx = max(mx, max(max(a, b), max(c, d)));
        }
    }
  } else {
    for (int i = tid; i < M; i += kThreads) {
      const uint32_t key = key_of(kStaged ? __ldcs(src + i) : src[i]);
      if (kStaged) stage[i] = static_cast<uint16_t>(key);
      mx = max(mx, key);
    }
  }
  if (kStaged && M + tid < Mp) stage[M + tid] = 0;
  const uint32_t wmx = __reduce_max_sync(kFull, mx);
  if (lane == 0) s_max[warp] = wmx;
  if (tid == 0) sh.count = 0;

  // 2. tau (its barrier also publishes the staged row and s_max)
  const uint32_t tau = threshold(mx, k, sh);
  uint32_t row_max = 0;
  for (int w = 0; w < kWarps; ++w) row_max = max(row_max, s_max[w]);

  // 3. the k-th key T: `above` keys lie above it and `ties` keys equal it,
  // of which the first `rem` by column complete the k. Where the row has
  // fewer than k runs (tau is then 0), T is 0: every run, none tied.
  uint32_t lo = max(tau, 1u), hi = row_max, T = 0;
  int rem = lo <= hi ? k : 0, above = 0, ties = 0;
  while (lo <= hi) {
    int shift = 0;
    while (((hi - lo) >> shift) >= static_cast<uint32_t>(kCountBins)) ++shift;
    const int nb = static_cast<int>((hi - lo) >> shift) + 1;
    for (int i = tid; i < nb; i += kThreads) hist[i] = 0;
    __syncthreads();
    for (int j = tid; j < chunks; j += kThreads) {
      Chunk c;
      c.load(stage, src, M, vec, kChunk * j);
      const auto m = c.in(lo, hi);
      if (m.any()) {
#pragma unroll
        for (int e = 0; e < kChunk; ++e)
          if (m.has(e)) atomicAdd(&hist[(c.key(e) - lo) >> shift], 1u);
      }
    }
    __syncthreads();
    // the bin holding the rem-th key from the top: each thread sums `per`
    // bins from the top down, a block scan of those sums, and the thread
    // whose bins hold it walks them
    const int per = (nb + kThreads - 1) / kThreads;
    const int top = nb - 1 - tid * per;
    int cnt = 0;
    for (int j = 0; j < per; ++j)
      if (top - j >= 0) cnt += hist[top - j];
    int total;
    int acc = block_scan(cnt, sh.part[0], &total);
    if (acc < rem && rem <= acc + cnt) {
      for (int j = 0; j < per; ++j) {
        const int c = hist[top - j];
        if (rem <= acc + c) {
          sh.sel[0] = top - j;
          sh.sel[1] = acc;
          sh.sel[2] = c;
          break;
        }
        acc += c;
      }
    }
    if (tid == 0 && total < rem) {   // fewer than rem keys in [lo, hi]: all of them
      sh.sel[0] = -1;
      sh.sel[1] = total;
    }
    __syncthreads();
    const int bin = sh.sel[0];
    above += sh.sel[1];
    if (bin < 0) {
      T = lo - 1;
      rem = 0;
      break;
    }
    rem -= sh.sel[1];
    lo += static_cast<uint32_t>(bin) << shift;
    if (shift == 0) {
      T = lo;
      ties = sh.sel[2];
      break;
    }
    hi = min(hi, lo + (1u << shift) - 1u);
  }

  // 4. The sort buffer gets every key >= cut, in any order (a warp ballot,
  // one shared atomic a warp): where the keys >= T are few (at most 2 k; the
  // cells' rows hold a dozen ties at T), all of them, and the sort's column
  // order picks the first rem ties; else (thousands tie at T) only the keys
  // > T, and the first rem ties by column follow them. Warp w owns the
  // chunks [w, w + 1) * rounds * 32, a round 32 of them: where ordered each
  // lane counts its ties on the way, and from one scan of the warps' counts
  // each warp writes its ties after those of the warps before it.
  const bool ordered = above + ties > min(2 * k, kSortCap);
  const uint32_t cut = ordered || rem == 0 ? T + 1 : T;
  const int n = ordered ? above + rem : above + ties;
  const int rounds = (chunks + kThreads - 1) / kThreads;
  int mine = 0;   // this lane's keys equal to T, where ordered
  for (int q = 0; q < rounds; ++q) {
    const int j = (warp * rounds + q) * 32 + lane;
    Chunk c{};
    if (j < chunks) c.load(stage, src, M, vec, kChunk * j);
    const auto m = c.ge(cut);
    if (ordered) mine += c.eq(T).count();
    if (__any_sync(kFull, m.any())) {   // most rounds hold none
#pragma unroll
      for (int e = 0; e < kChunk; ++e)
        append(m.has(e), pair_of(c.key(e), kChunk * j + e), buf, &sh.count);
    }
  }
  if (ordered) {
    mine = __reduce_add_sync(kFull, mine);
    if (lane == 0) sh.part[1][warp] = mine;
    __syncthreads();
    int run = 0;   // ties in the warps before, then in this warp's rounds before
    for (int w = 0; w < warp; ++w) run += sh.part[1][w];
    for (int q = 0; q < rounds && run < rem; ++q) {
      const int j = (warp * rounds + q) * 32 + lane;
      Chunk c{};
      if (j < chunks) c.load(stage, src, M, vec, kChunk * j);
      const auto m = c.eq(T);
      uint32_t eq = 0;
#pragma unroll
      for (int e = 0; e < kChunk; ++e) eq |= static_cast<uint32_t>(m.has(e)) << e;
      const int cnt = __popc(eq);
      int incl = cnt;
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += v;
      }
      int rank = run + incl - cnt;
#pragma unroll
      for (int e = 0; e < kChunk; ++e)
        if (eq >> e & 1u) {
          if (rank < rem) buf[above + rank] = pair_of(T, kChunk * j + e);
          ++rank;
        }
      run += __shfl_sync(kFull, incl, 31);
    }
  }
  __syncthreads();

  // 5. sort the chosen pairs; scores from the keys, ids from sids
  const int kept = min(n, k);
  const float wr = wmax[r];
  float* scores = out_scores + r * k;
  int* ids = out_ids + r * k;
  sort_and_emit(buf, n, kept, [&](int i, int col) {
    const int sum = static_cast<int>(buf[i] >> 32) - 1;
    const float s = __fmul_rn(__int2float_rn(sum), wr);
    const bool ok = fabsf(s) < INFINITY;
    scores[i] = ok ? s : -INFINITY;
    ids[i] = ok ? sid[col] : -1;
  });
  for (int i = kept + tid; i < k; i += kThreads) {
    scores[i] = -INFINITY;
    ids[i] = -1;
  }
}

}  // namespace

// wide: the sums may reach 2^15 - 1 or more (below 2^22), so the row is read
// as 32-bit keys and not staged.
extern "C" int qfr_q8_topk(const void* sums, const void* sids, const void* wmax, int B, int M,
                           int k, int vec, int wide, void* scores, void* ids, void* stream) {
  if (B < 1 || M < 1 || k < 1 || k > kMaxK || k > M)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool staged = !wide && M <= kMaxStaged;
  const size_t smem =
      kHistBytes + (staged ? 2 * static_cast<size_t>((M + kChunk - 1) & ~(kChunk - 1)) : 0);
  const auto kernel = staged ? q8_topk_kernel<true> : q8_topk_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(B), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(sums), static_cast<const int*>(sids),
      static_cast<const float*>(wmax), M, k, vec, static_cast<float*>(scores),
      static_cast<int*>(ids));
  return static_cast<int>(cudaGetLastError());
}
