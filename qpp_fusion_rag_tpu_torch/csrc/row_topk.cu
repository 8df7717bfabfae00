// Exact row top-k of f32 rows: the dense merge of the packed group maxima.
//
// Replaces no TPU kernel. The JAX package merges its dense kernels' group
// maxima with lax.top_k (or lax.approx_max_k), which XLA lowers on the TPU
// by itself. The port merged them with ops/segment.py:topk_first, a stable
// descending torch.sort of the whole row and a slice; on an H100 that took
// ~65x the time of reading the rows at the flagship's 5,120 x 20,480 (two CUB
// radix passes over keys and values, an index fill), more than any other
// step of the dense cells but K1 / K7. This kernel was added for that.
//
// Contract: f32 rows x [M, G], any G, and 1 <= k <= min(G, kMaxK) -> the k largest
// values of each row and their int64 columns, in descending order, ties to
// the lowest column first: exactly topk_first(x, k) on the card. The order
// is torch.sort's there: -0.0 ties with +0.0 (CUB's radix sort maps -0.0 to
// +0.0), +-inf and denormals order by their bits, nothing is flushed, and
// the values come back as read (-0.0 stays -0.0). NaN lies outside it.
//
// Bound: bytes. Each row is read once (4 G bytes) and k values and columns
// are written once (12 k): at 5,120 x 20,480 and k = 100 that is 425.6 MB,
// 0.127 ms at 3.35 TB/s.
//
// Design: one CTA of 512 threads a row, so each row is read from HBM once
// and nothing leaves the SM but the answer; one launch a merge.
//  1. A row of at most kMaxG columns is staged in shared memory with 16-byte
//     streaming loads (4-byte ones where a row is not 16-byte aligned), four
//     in flight a thread. A wider row is not staged: every later pass reads
//     it from global memory again, where it is still in L2 (a row of 69,077
//     columns is 276 KB; the L2 holds 50 MB). Each thread keeps the largest
//     order key (the f32 bits mapped to an unsigned int that orders as the
//     floats do) of its G/512 values.
//  2. A threshold tau from those maxima: each warp takes the q-th largest of
//     its 32 (q = ceil(k / 16), a warp bitonic sort by shuffles), and tau is
//     the least of the 16 warps'. Each warp has q threads whose maximum is
//     >= tau, each a distinct value, so 16 q >= k values are >= tau and the
//     k-th largest is too. On the cells' rows a few hundred values pass.
//  3. The values >= tau go into a shared buffer of (key, ~column) pairs
//     (a warp ballot and one shared atomic a warp). If they fit (at most
//     kSortCap), one bitonic sort of the pairs, descending, orders them by
//     key and then by lowest column, which is the tie rule, and its first k
//     are the answer. The values are read back from the staged row.
//  4. Otherwise (rows with thousands of equal values, or k > 512, which
//     takes no threshold): a radix select over 8-bit digits among the values
//     >= tau, with one histogram a warp in shared memory, narrows to the
//     digit holding the k-th key and goes back to step 3 as soon as the
//     values at or above the chosen prefix fit. With all 32 bits chosen, the
//     keys above the k-th (fewer than k) go into the buffer and the first k
//     minus those keys equal to it in column order (a block scan) fill it.
//  Shared memory: the staged row (4 G bytes) and 16 KB for the buffer, which
//  the histograms share; two CTAs an SM at the cells' G. The buffer holds
//  kSortCap pairs, so k is at most that.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;          // one 8-bit digit
constexpr int kSortCap = 2048;      // pairs the bitonic buffer holds (16 KB)
constexpr int kMaxK = kSortCap;     // the largest k: its pairs fill the buffer
constexpr int kMaxG = 53248;        // the widest row that shared memory stages
constexpr unsigned kFull = 0xffffffffu;

static_assert(kSortCap * 8 == kWarps * kBins * 4, "the histograms share the buffer");

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

// A load of the first pass: streaming where the row is staged (it is read
// from HBM once), cached where it is read again from global memory.
template <bool kStaged, typename V>
__device__ __forceinline__ V first_load(const V* p) {
  if constexpr (kStaged) return __ldcs(p);
  else return *p;
}

// Sort the n pairs of buf descending (bitonic, padded to a power of two
// with 0, below every pair) and write the first k: values from the row,
// columns as int64.
__device__ void sort_and_write(uint64_t* buf, int n, int k, const uint32_t* row,
                               float* vals, long long* cols) {
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
  for (int i = threadIdx.x; i < k; i += kThreads) {
    const int col = static_cast<int>(~static_cast<uint32_t>(buf[i]));
    vals[i] = __uint_as_float(row[col]);
    cols[i] = col;
  }
}

// kStaged: the row is staged in shared memory (G <= kMaxG); otherwise every
// pass reads it from global memory.
template <bool kStaged>
__global__ void __launch_bounds__(kThreads, 2) row_topk_kernel(
    const float* __restrict__ x, int G, int k, int vec, float* __restrict__ out_vals,
    long long* __restrict__ out_cols) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* stage = reinterpret_cast<uint32_t*>(smem);
  uint64_t* buf = reinterpret_cast<uint64_t*>(
      smem + (kStaged ? 4 * static_cast<size_t>((G + 3) & ~3) : 0));
  uint32_t* hist = reinterpret_cast<uint32_t*>(buf);
  __shared__ int s_count;
  __shared__ uint32_t s_tau[kWarps];
  __shared__ int s_part[2][kWarps];
  __shared__ int s_sel[3];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t r = blockIdx.x;
  const uint32_t* src = reinterpret_cast<const uint32_t*>(x) + r * G;
  const uint32_t* row = kStaged ? stage : src;
  const bool row_vec = kStaged || vec;
  float* vals = out_vals + r * k;
  long long* cols = out_cols + r * k;
  if (tid == 0) s_count = 0;

  // 1. stage the row (or only read it); each thread's largest key
  uint32_t mx = 0;
  if (vec) {
    const uint4* src4 = reinterpret_cast<const uint4*>(src);
    uint4* stage4 = reinterpret_cast<uint4*>(stage);
    const int n4 = G >> 2;
    for (int c0 = tid; c0 < n4; c0 += 4 * kThreads) {
      uint4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (c0 + u * kThreads < n4) v[u] = first_load<kStaged>(src4 + c0 + u * kThreads);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (c0 + u * kThreads < n4) {
          if (kStaged) stage4[c0 + u * kThreads] = v[u];
          mx = max(mx, max4(v[u]));
        }
    }
  } else {
    for (int i0 = tid; i0 < G; i0 += 4 * kThreads) {
      uint32_t v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (i0 + u * kThreads < G) v[u] = first_load<kStaged>(src + i0 + u * kThreads);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (i0 + u * kThreads < G) {
          if (kStaged) stage[i0 + u * kThreads] = v[u];
          mx = max(mx, order_key(v[u]));
        }
    }
  }

  // 2. tau: the least of the warps' q-th largest thread maxima (0 = none).
  // A thread with no value has mx 0, the least key, so it can only lower tau.
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
    if (lane == 0) s_tau[warp] = v;
  } else if (lane == 0) {
    s_tau[warp] = 0;
  }
  __syncthreads();
  uint32_t tau = s_tau[0];
  for (int w = 1; w < kWarps; ++w) tau = min(tau, s_tau[w]);

  // 3. the values >= tau; done if they fit the buffer
  compact(row, G, row_vec, tau, false, buf, &s_count);
  __syncthreads();
  if (s_count <= kSortCap) {
    sort_and_write(buf, s_count, k, row, vals, cols);
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
      if (lane == 31) s_part[0][warp] = incl;
    }
    __syncthreads();
    if (warp < kBins / 32) {
      int excl = incl - cnt;
      for (int w = 0; w < warp; ++w) excl += s_part[0][w];
      if (excl < rem && rem <= excl + cnt) {
        s_sel[0] = kBins - 1 - tid;
        s_sel[1] = excl;
        s_sel[2] = cnt;
      }
    }
    if (tid == 0) s_count = 0;
    __syncthreads();
    const int bin = s_sel[0], in_bin = s_sel[2];
    above += s_sel[1];
    rem -= s_sel[1];
    prefix |= static_cast<uint32_t>(bin) << shift;
    mask |= static_cast<uint32_t>(kBins - 1) << shift;
    if (above + in_bin <= kSortCap) {  // the keys at or above the prefix fit
      compact(row, G, row_vec, max(tau, prefix), false, buf, &s_count);
      __syncthreads();
      sort_and_write(buf, s_count, k, row, vals, cols);
      return;
    }
  }

  // every bit chosen: prefix is the k-th key, `above` keys lie above it and
  // the first `rem` keys equal to it, in column order, complete the k
  const uint32_t kth = prefix;
  if (kth != 0xffffffffu) compact(row, G, row_vec, kth, true, buf, &s_count);
  int taken = 0;
  for (int i0 = 0, round = 0; i0 < G && taken < rem; i0 += kThreads, ++round) {
    const int i = i0 + tid;
    const bool eq = i < G && order_key(row[i]) == kth;
    const unsigned b = __ballot_sync(kFull, eq);
    if (lane == 0) s_part[round & 1][warp] = __popc(b);
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = s_part[round & 1][w];
      before += w < warp ? c : 0;
      total += c;
    }
    const int rank = taken + before + __popc(b & ((1u << lane) - 1u));
    if (eq && rank < rem) buf[above + rank] = pair_of(kth, i);
    taken += total;
  }
  __syncthreads();
  sort_and_write(buf, k, k, row, vals, cols);
}

}  // namespace

extern "C" int qfr_row_topk(const void* x, int M, int G, int k, int vec, void* vals, void* cols,
                            void* stream) {
  if (M < 1 || G < 1 || k < 1 || k > kMaxK || k > G)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool staged = G <= kMaxG;
  const size_t smem =
      (staged ? 4 * static_cast<size_t>((G + 3) & ~3) : 0) + 8 * static_cast<size_t>(kSortCap);
  const auto kernel = staged ? row_topk_kernel<true> : row_topk_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(M), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), G, k, vec, static_cast<float*>(vals),
      static_cast<long long*>(cols));
  return static_cast<int>(cudaGetLastError());
}
