// K2: per-row sort of packed (doc << 8 | q8) int32 keys fused with an exact
// int32 segmented run-sum of the low byte over equal-doc runs.
//
// Replaces qpp_fusion_rag_tpu/ops/pallas/bitonic.py:bitonic_segsum_rows
// (_bitonic_segsum_kernel). Contract kept: ascending sort; sids are the
// sorted keys' doc ids by LOGICAL shift (the INT32_MIN pad of descending
// presorted windows becomes 0x800000, callers mask sids >= 0x7FFFFF); sums
// hold each run's total of (q8 + plus_one) at the run's last position and -1
// elsewhere. start_block > 2 skips the first log2(start_block) - 1 rounds for
// rows that arrive as aligned start_block/2 blocks sorted alternately
// ascending / descending (the presorted posting layout).
//
// Bound on the H100: the row must be read once and two rows written (12
// bytes a key); the compare-exchange network (54 stages at M = 32,768 from
// the main path's start_block 4096) is what the kernel spends its time on.
//
// Design: the row lives in registers. One CTA of T threads holds a part of
// n = 32 T keys, R = 32 a thread (rows shorter than 1024 keys are padded to
// 1024). A part holds at most 16,384 keys (512 threads): longer rows take a
// cluster of Mp / 16,384 CTAs (2 or 4). 64 keys a thread would keep 32,768
// in one CTA, but ptxas spilled them under the 128 registers a 512-thread CTA
// leaves a thread (and 1024 threads cap a thread at 64). The stages run on
// the register network of bitonic_regs.cuh: the load is strided (thread t
// reads keys t, t + T, ...: coalesced), the stages of distance >= T run
// in-thread in that layout, one transpose through shared memory per layout
// switch (5 at 16,384 keys and 7 at 32,768 from the main path's
// start_block 4096, where the shared-memory network paid 39 and 54
// barrier-separated stages), shuffles and in-thread stages below. Keys past M are padded with INT32_MAX (they sort last and
// are never stored). A stage of distance j >= n pairs key i of this part
// with key i of part rank ^ (j / n) (one such stage per round above 16,384
// keys, two in the last round at 65,536): both parts publish their keys,
// each takes half of the positions and writes the min and the max to both
// parts through distributed shared memory, between cluster barriers, and
// each finishes the round alone. The network ends contiguous: each thread's
// R sorted keys are one chunk of the row, published to shared memory.
//
// The scan is exact for ANY run length: each thread reduces its chunk to a
// (run-start-seen, partial-sum) pair, a block-wide segmented exclusive scan
// of those pairs (warp shuffles, warp totals in shared memory) gives every
// chunk its carry-in, and a second pass turns the keys into run totals in
// place. It reads the sorted keys from shared memory, where they sit for the
// strided (coalesced) stores of sids and sums anyway. Across a cluster, each
// part publishes a summary (first and last doc id, the sum of its last run,
// whether one run fills it), and a part's carry-in is summed from the
// summaries of the parts below whose last run it continues: no thread walks
// a run key by key, however long.
#include <climits>
#include <cuda_runtime.h>

#include "bitonic_common.cuh"
#include "bitonic_regs.cuh"

namespace {

namespace cg = qfr_bitonic::cg;

constexpr int R = 32;            // keys per thread
constexpr int kMinRow = 32 * R;  // rows are padded to at least one warp's keys
constexpr int kPart = 16384;     // keys one CTA holds: 512 threads

using qfr_regs::cpos;
using qfr_regs::pad;
using qfr_regs::spos;

__device__ __forceinline__ int sid_of(int key) {
  return static_cast<int>(static_cast<unsigned>(key) >> 8);
}

// (f, s) pairs: f = a run starts inside the span, s = sum from the last run
// start in the span (or the span's beginning) to its end. combine(earlier,
// later) is associative, (0, 0) its identity.
__device__ __forceinline__ void warp_inclusive_scan(int& f, int& s, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int fu = __shfl_up_sync(0xffffffffu, f, off);
    const int su = __shfl_up_sync(0xffffffffu, s, off);
    if (lane >= off) {
      s = f ? s : su + s;
      f = f | fu;
    }
  }
}

// This CTA's part of its row: `parts` CTAs (a cluster when > 1) of n = T R
// keys each.
struct Part {
  long long row;
  int parts, rank, n;
  __device__ __forceinline__ int base() const { return rank * n; }  // row index of local key 0
};

template <int T>
__device__ __forceinline__ Part part_of(int Mp) {
  Part p;
  p.parts = Mp / (T * R);
  p.rank = p.parts > 1 ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
  p.row = blockIdx.x / p.parts;
  p.n = T * R;
  return p;
}

// (T, 1): ptxas may then give a thread all 65,536 / T registers; with the
// default it kept fewer than the keys need and spilled.
template <int T>
__global__ void __launch_bounds__(T, 1) bitonic_segsum_kernel(
    const int* __restrict__ keys, int M, int Mp, int start_block, int plus_one,
    int* __restrict__ sums, int* __restrict__ sids) {
  extern __shared__ int s[];  // pad<R>(T R) words: transposes, sorted keys, sums
  __shared__ int warp_f[T / 32];
  __shared__ int warp_s[T / 32];
  __shared__ int info[4];     // this part's summary, read by its neighbours
  const Part p = part_of<T>(Mp);
  const int t = threadIdx.x;
  const int* in = keys + p.row * M;
  int x[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int gi = p.base() + r * T + t;
    x[r] = gi < M ? in[gi] : INT_MAX;
  }
  bool strided = true;
  // at round k, pairs (i, i + j) with bit j of i clear sort ascending where
  // bit k of i is clear (k = Mp: everywhere)
  qfr_regs::block_network<T, R>(x, s, strided, start_block, p.n, p.base());
  if (p.parts > 1) {
    // the stages across parts, j >= n, in shared memory: the keys are
    // published, each pair of parts splits the word positions in halves, and
    // for its half each part reads both keys and writes the min and the max
    // to their places (distributed shared memory), between cluster barriers;
    // no register holds a second copy of the keys
    cg::cluster_group cluster = cg::this_cluster();
    constexpr int W = pad<R>(T * R);      // words of one part, pad words included
    for (int k = max(2 * p.n, start_block); k <= Mp; k <<= 1) {
      __syncthreads();
#pragma unroll
      for (int r = 0; r < R; ++r) s[strided ? spos<T, R>(r, t) : cpos<R>(t, r)] = x[r];
      const bool asc = (p.base() & k) == 0;
      for (int j = k >> 1; j >= p.n; j >>= 1) {
        cluster.sync();                   // every part published, or the last stage done
        const int other = p.rank ^ (j / p.n);
        int* lo = cluster.map_shared_rank(s, min(p.rank, other));
        int* hi = cluster.map_shared_rank(s, max(p.rank, other));
        const int w0 = p.rank < other ? 0 : W / 2;
#pragma unroll 8
        for (int w = w0 + t; w < w0 + W / 2; w += T) {
          const int a = lo[w], b = hi[w];
          lo[w] = asc ? min(a, b) : max(a, b);
          hi[w] = asc ? max(a, b) : min(a, b);
        }
      }
      cluster.sync();                     // every stage's writes landed
#pragma unroll
      for (int r = 0; r < R; ++r) x[r] = s[strided ? spos<T, R>(r, t) : cpos<R>(t, r)];
      qfr_regs::block_round<T, R>(x, s, strided, k, p.n / 2, p.base());
    }
  }

  // contiguous: x[r] is sorted key t R + r of this part; publish them
  __syncthreads();
#pragma unroll
  for (int r = 0; r < R; ++r) s[cpos<R>(t, r)] = x[r];
  __syncthreads();
  const int m = min(p.n, M - p.base());   // this part's keys in the row

  // sids in the strided order (coalesced): thread t writes keys t, t + T, ...
  // From here on no register array is indexed: the loops unroll by 8 only,
  // so that the scheduler cannot hoist all R loads at once.
  int* out_sums = sums + p.row * M + p.base();
  int* out_sids = sids + p.row * M + p.base();
#pragma unroll 8
  for (int r = 0; r < R; ++r) {
    const int i = r * T + t;
    if (i < m) out_sids[i] = sid_of(s[spos<T, R>(r, t)]);
  }

  // segmented scan over this part's first m sorted keys, R per thread, read
  // from shared memory. Key 0 starts no run here (its own doc id stands
  // before it), so the part's total is its last run: f = a run starts after
  // key 0, s = the sum of the last run (of the whole part when f == 0).
  const int i0 = t * R;
  // the doc ids just before and just after this thread's chunk, read before
  // the neighbours overwrite their keys with sums (the part's own edges: -1,
  // replaced by the neighbouring parts' below)
  const int prev_in = i0 > 0 ? sid_of(s[pad<R>(i0 - 1)]) : -1;
  const int after_in = i0 + R < m ? sid_of(s[pad<R>(i0 + R)]) : -1;
  int f = 0, acc = 0;
  {
    int ps = i0 > 0 ? prev_in : sid_of(s[pad<R>(0)]);
#pragma unroll 8
    for (int r = 0; r < R; ++r) {
      if (i0 + r < m) {
        const int key = s[cpos<R>(t, r)];
        const int sid = sid_of(key);
        const int v = (key & 0xFF) + plus_one;
        if (sid != ps) {
          f = 1;
          acc = v;
        } else {
          acc += v;
        }
        ps = sid;
      }
    }
  }
  const int lane = t & 31, warp = t >> 5;
  int fi = f, si = acc;
  warp_inclusive_scan(fi, si, lane);
  int fe = __shfl_up_sync(0xffffffffu, fi, 1);
  int se = __shfl_up_sync(0xffffffffu, si, 1);
  if (lane == 0) fe = se = 0;
  if (lane == 31) {
    warp_f[warp] = fi;
    warp_s[warp] = si;
  }
  __syncthreads();
  if (warp == 0) {
    int wf = lane < T / 32 ? warp_f[lane] : 0, ws = lane < T / 32 ? warp_s[lane] : 0;
    warp_inclusive_scan(wf, ws, lane);
    int pf = __shfl_up_sync(0xffffffffu, wf, 1);
    int ps = __shfl_up_sync(0xffffffffu, ws, 1);
    if (lane == 0) pf = ps = 0;
    __syncwarp();
    if (lane < T / 32) {
      warp_f[lane] = pf;
      warp_s[lane] = ps;
    }
    if (lane == T / 32 - 1) {
      // this part's summary for its neighbours: first and last doc id, the
      // last run's sum, whether one run fills the part
      info[0] = m > 0 ? sid_of(s[pad<R>(0)]) : -1;
      info[1] = m > 0 ? sid_of(s[pad<R>(m - 1)]) : -1;
      info[2] = ws;
      info[3] = !wf;
    }
  }
  // the neighbouring parts: the doc id just before this part (-1: none) with
  // the sum of its run below this part when this part continues it, and the
  // doc id just after this part
  int prev_sid = -1, next_sid = -1, carry = 0;
  if (p.parts > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();                       // every part's summary written
    if (p.rank > 0 && m > 0) {
      prev_sid = cluster.map_shared_rank(info, p.rank - 1)[1];
      for (int c = p.rank - 1; c >= 0 && prev_sid == info[0]; --c) {
        const int* o = cluster.map_shared_rank(info, c);
        if (o[1] != prev_sid) break;
        carry += o[2];
        if (!o[3]) break;                 // the run starts inside part c
      }
    }
    if (p.base() + p.n < M) next_sid = cluster.map_shared_rank(info, p.rank + 1)[0];
    cluster.sync();                       // the other parts stay until these reads are done
  } else {
    __syncthreads();
  }
  const int prev = i0 > 0 ? prev_in : prev_sid;
  const int after = i0 + R < m ? after_in : next_sid;
  // carry-in = (the parts below's run, if no run starts before this chunk)
  // combined with (warps before) and (lanes before, this warp); each key
  // becomes its sum in place (run total at a run's last position, else -1),
  // after the next key has been read
  {
    int run = fe ? se : warp_s[warp] + se + (warp_f[warp] ? 0 : carry);
    int ps = prev;
    int key = s[cpos<R>(t, 0)];
#pragma unroll 8
    for (int r = 0; r < R; ++r) {
      const int i = i0 + r;
      if (i < m) {
        const int sid = sid_of(key);
        const int v = (key & 0xFF) + plus_one;
        run = sid != ps ? v : run + v;
        const int nkey = r + 1 < R ? s[cpos<R>(t, r + 1 < R ? r + 1 : r)] : 0;
        const int next = i == m - 1 ? next_sid : r + 1 < R ? sid_of(nkey) : after;
        s[cpos<R>(t, r)] = next != sid ? run : -1;
        ps = sid;
        key = nkey;
      }
    }
  }
  __syncthreads();
#pragma unroll 8
  for (int r = 0; r < R; ++r) {
    const int i = r * T + t;
    if (i < m) out_sums[i] = s[spos<T, R>(r, t)];
  }
}

template <int T>
cudaError_t launch(int B, int Mp, int parts, cudaStream_t stream, const int* keys, int M,
                   int start_block, int plus_one, int* sums, int* sids) {
  return qfr_bitonic::launch_clusters(
      bitonic_segsum_kernel<T>, B, parts, T, pad<R>(T * R) * sizeof(int), stream, keys, M, Mp,
      start_block, plus_one, sums, sids);
}

}  // namespace

// One instance per part size n (the padded row length, at least 1024, split
// into parts of at most 16,384 keys above that): T = n / 32 threads.
extern "C" int qfr_bitonic_segsum(const void* keys, int B, int M, int start_block,
                                  int plus_one, void* sums, void* sids, void* stream) {
  const int Mp = qfr_bitonic::padded_len(M);
  if (M < 1 || Mp > qfr_bitonic::kMaxRow || !qfr_bitonic::valid_start_block(start_block, Mp))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n = Mp < kMinRow ? kMinRow : Mp;
  const int parts = n > kPart ? n / kPart : 1;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto k = static_cast<const int*>(keys);
  const auto su = static_cast<int*>(sums);
  const auto si = static_cast<int*>(sids);
  cudaError_t err;
  switch (n / parts) {
    case 1024: err = launch<32>(B, n, parts, st, k, M, start_block, plus_one, su, si); break;
    case 2048: err = launch<64>(B, n, parts, st, k, M, start_block, plus_one, su, si); break;
    case 4096: err = launch<128>(B, n, parts, st, k, M, start_block, plus_one, su, si); break;
    case 8192: err = launch<256>(B, n, parts, st, k, M, start_block, plus_one, su, si); break;
    default: err = launch<512>(B, n, parts, st, k, M, start_block, plus_one, su, si); break;
  }
  return static_cast<int>(err);
}
