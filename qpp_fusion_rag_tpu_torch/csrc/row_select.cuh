// Exact top-k of one f32 row by one CTA of 512 threads: the selection that
// row_topk.cu (the dense merge) and run_sums_topk.cu (the "sort" engine's
// run totals) share.
//
// Order: descending, ties to the lowest column first, -0.0 tied with +0.0
// (order_key maps -0.0 to +0.0, as CUB's radix sort does); +-inf and
// denormals order by their bits. NaN lies outside it.
//
// Method (select_topk), on a row a kernel has staged in shared memory or
// written to global memory, given each thread's largest order key over a
// set of columns that partition the row:
//  2. A threshold tau from those maxima: each warp takes the q-th largest of
//     its 32 (q = ceil(k / 16), a warp bitonic sort by shuffles), and tau is
//     the least of the 16 warps'. Each warp has q threads whose maximum is
//     >= tau, each a distinct value, so 16 q >= k values are >= tau and the
//     k-th largest is too. On the cells' rows a few hundred values pass.
//  3. The values >= tau go into a shared buffer of (key, ~column) pairs
//     (a warp ballot and one shared atomic a warp). If they fit (at most
//     kSortCap), one bitonic sort of the pairs, descending, orders them by
//     key and then by lowest column, which is the tie rule, and its first k
//     are the answer.
//  4. Otherwise (rows with thousands of equal values, or k > 512, which
//     takes no threshold): a radix select over 8-bit digits among the values
//     >= tau, with one histogram a warp in shared memory, narrows to the
//     digit holding the k-th key and goes back to step 3 as soon as the
//     values at or above the chosen prefix fit. With all 32 bits chosen, the
//     keys above the k-th (fewer than k) go into the buffer and the first k
//     minus those keys equal to it in column order (a block scan) fill it.
// The buffer holds kSortCap pairs (16 KB), so k is at most that; the
// histograms share it. q8_topk.cu takes steps 2 and 3's pieces (threshold,
// append, sort_and_emit) around a counting select of its own.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace row_select {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;          // one 8-bit digit
constexpr int kSortCap = 2048;      // pairs the bitonic buffer holds (16 KB)
constexpr int kMaxK = kSortCap;     // the largest k: its pairs fill the buffer
constexpr unsigned kFull = 0xffffffffu;

static_assert(kSortCap * 8 == kWarps * kBins * 4, "the histograms share the buffer");

// The selection's shared scalars; count must be 0 at the first barrier of
// select_topk (select_topk sets it before that barrier).
struct Shared {
  int count;
  uint32_t tau[kWarps];
  int part[2][kWarps];
  int sel[3];
};

__device__ __forceinline__ uint32_t order_key(uint32_t bits) {
  bits = bits == 0x80000000u ? 0u : bits;  // -0.0 ties with +0.0
  return (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
}

__device__ __forceinline__ uint64_t pair_of(uint32_t key, int col) {
  return (static_cast<uint64_t>(key) << 32) | static_cast<uint32_t>(~col);
}

__device__ __forceinline__ uint32_t max4(uint4 v) {
  return max(max(order_key(v.x), order_key(v.y)), max(order_key(v.z), order_key(v.w)));
}

// Append `pair` where `take`, in no particular order: a ballot, one shared
// atomic a warp. Every lane of the warp calls it.
__device__ __forceinline__ void append(bool take, uint64_t pair, uint64_t* buf, int* count) {
  const unsigned b = __ballot_sync(kFull, take);
  if (b == 0) return;
  const int lane = threadIdx.x & 31;
  int base = 0;
  if (lane == 0) base = atomicAdd(count, __popc(b));
  base = __shfl_sync(kFull, base, 0);
  if (take) {
    const int pos = base + __popc(b & ((1u << lane) - 1u));
    if (pos < kSortCap) buf[pos] = pair;
  }
}

// Every value of the row whose key is >= lo (> lo where strict) into buf;
// *count (0 on entry, read after the next barrier) counts them all, also
// beyond kSortCap. 16-byte loads where `vec` (the row is 16-byte aligned and
// may be read in whole 16-byte words: a staged row, padded to them, or a
// global one with G % 4 == 0), else 4-byte loads.
__device__ void compact(const uint32_t* row, int G, bool vec, uint32_t lo, bool strict,
                        uint64_t* buf, int* count) {
  const int lane = threadIdx.x & 31;
  if (!vec) {
    for (int i = threadIdx.x; i - lane < G; i += kThreads) {
      const uint32_t key = i < G ? order_key(row[i]) : 0;
      append(i < G && (strict ? key > lo : key >= lo), pair_of(key, i), buf, count);
    }
    return;
  }
  const uint4* row4 = reinterpret_cast<const uint4*>(row);
  const int n4 = (G + 3) >> 2;
  for (int c = threadIdx.x; c - lane < n4; c += kThreads) {
    const uint4 v = c < n4 ? row4[c] : make_uint4(0, 0, 0, 0);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 4 * c + e;
      const uint32_t key = order_key(w[e]);
      const bool take = col < G && (strict ? key > lo : key >= lo);
      append(take, pair_of(key, col), buf, count);
    }
  }
}

// Step 2 (1 <= k): tau, the least of the warps' q-th largest thread maxima,
// q = ceil(k / 16); 0 (none) where q > 32. mx is this thread's largest key
// (0 where it has none: the least key, so it can only lower tau). At least k
// keys of the row are >= tau. Every thread calls it; one barrier.
__device__ __forceinline__ uint32_t threshold(uint32_t mx, int k, Shared& sh) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q = (k + kWarps - 1) / kWarps;
  if (q <= 32) {
    uint32_t v = mx;
    for (int size = 2; size <= 32; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        const uint32_t o = __shfl_xor_sync(kFull, v, stride);
        const bool low = (lane & stride) == 0, desc = (lane & size) == 0;
        v = (low == desc) ? max(v, o) : min(v, o);
      }
    }
    v = __shfl_sync(kFull, v, q - 1);
    if (lane == 0) sh.tau[warp] = v;
  } else if (lane == 0) {
    sh.tau[warp] = 0;
  }
  __syncthreads();
  uint32_t tau = sh.tau[0];
  for (int w = 1; w < kWarps; ++w) tau = min(tau, sh.tau[w]);
  return tau;
}

// Sort the n pairs of buf descending (bitonic, padded to a power of two
// with 0, below every pair) and hand the first k to emit(rank, column).
template <class Emit>
__device__ void sort_and_emit(uint64_t* buf, int n, int k, Emit emit) {
  int P = 1;
  while (P < n) P <<= 1;
  for (int i = n + threadIdx.x; i < P; i += kThreads) buf[i] = 0;
  __syncthreads();
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < (P >> 1); t += kThreads) {
        const int i = 2 * t - (t & (stride - 1));
        const uint64_t a = buf[i], b = buf[i + stride];
        if ((a < b) == ((i & size) == 0)) {
          buf[i] = b;
          buf[i + stride] = a;
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < k; i += kThreads)
    emit(i, static_cast<int>(~static_cast<uint32_t>(buf[i])));
}

// Steps 2-4 over the row's G values (1 <= k <= min(G, kMaxK)), mx this
// thread's largest key (0 where it has none); the row must be visible to
// every thread (a barrier after it was written). emit(rank, column) gets
// the k columns in the order above.
template <class Emit>
__device__ void select_topk(const uint32_t* row, int G, int k, bool row_vec, uint32_t mx,
                            uint64_t* buf, Shared& sh, Emit emit) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  uint32_t* hist = reinterpret_cast<uint32_t*>(buf);
  if (tid == 0) sh.count = 0;
  const uint32_t tau = threshold(mx, k, sh);

  // 3. the values >= tau; done if they fit the buffer
  compact(row, G, row_vec, tau, false, buf, &sh.count);
  __syncthreads();
  if (sh.count <= kSortCap) {
    sort_and_emit(buf, sh.count, k, emit);
    return;
  }

  // 4. radix select among the keys >= tau, 8 bits a pass from the top
  uint32_t prefix = 0, mask = 0;
  int rem = k, above = 0;  // keys still wanted under the prefix; keys above it
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = tid; i < kWarps * kBins; i += kThreads) hist[i] = 0;
    __syncthreads();
    uint32_t* h = hist + warp * kBins;
    for (int i = tid; i < G; i += kThreads) {
      const uint32_t key = order_key(row[i]);
      if (key >= tau && (key & mask) == prefix) atomicAdd(&h[(key >> shift) & (kBins - 1)], 1u);
    }
    __syncthreads();
    // the bin holding the rem-th key from the top: bins descending over
    // the first 8 warps, a scan of their counts
    int cnt = 0, incl = 0;
    if (warp < kBins / 32) {
      const int bin = kBins - 1 - tid;
      for (int w = 0; w < kWarps; ++w) cnt += hist[w * kBins + bin];
      incl = cnt;
      for (int o = 1; o < 32; o <<= 1) {
        const int n = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += n;
      }
      if (lane == 31) sh.part[0][warp] = incl;
    }
    __syncthreads();
    if (warp < kBins / 32) {
      int excl = incl - cnt;
      for (int w = 0; w < warp; ++w) excl += sh.part[0][w];
      if (excl < rem && rem <= excl + cnt) {
        sh.sel[0] = kBins - 1 - tid;
        sh.sel[1] = excl;
        sh.sel[2] = cnt;
      }
    }
    if (tid == 0) sh.count = 0;
    __syncthreads();
    const int bin = sh.sel[0], in_bin = sh.sel[2];
    above += sh.sel[1];
    rem -= sh.sel[1];
    prefix |= static_cast<uint32_t>(bin) << shift;
    mask |= static_cast<uint32_t>(kBins - 1) << shift;
    if (above + in_bin <= kSortCap) {  // the keys at or above the prefix fit
      compact(row, G, row_vec, max(tau, prefix), false, buf, &sh.count);
      __syncthreads();
      sort_and_emit(buf, sh.count, k, emit);
      return;
    }
  }

  // every bit chosen: prefix is the k-th key, `above` keys lie above it and
  // the first `rem` keys equal to it, in column order, complete the k
  const uint32_t kth = prefix;
  if (kth != 0xffffffffu) compact(row, G, row_vec, kth, true, buf, &sh.count);
  int taken = 0;
  for (int i0 = 0, round = 0; i0 < G && taken < rem; i0 += kThreads, ++round) {
    const int i = i0 + tid;
    const bool eq = i < G && order_key(row[i]) == kth;
    const unsigned b = __ballot_sync(kFull, eq);
    if (lane == 0) sh.part[round & 1][warp] = __popc(b);
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = sh.part[round & 1][w];
      before += w < warp ? c : 0;
      total += c;
    }
    const int rank = taken + before + __popc(b & ((1u << lane) - 1u));
    if (eq && rank < rem) buf[above + rank] = pair_of(kth, i);
    taken += total;
  }
  __syncthreads();
  sort_and_emit(buf, k, k, emit);
}

}  // namespace row_select
}  // namespace
