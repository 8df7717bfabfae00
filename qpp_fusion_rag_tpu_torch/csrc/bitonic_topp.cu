// K4: the exact top-bs values of each row of [B, M] int32 keys, returned as
// a [B, bs] block sorted ascending.
//
// Replaces qpp_fusion_rag_tpu/ops/pallas/bitonic.py:bitonic_topp_rows
// (_bitonic_topp_kernel). Contract kept: bs a power of two >= 1024 with
// 2*bs <= M; element [bs - pool - 1] of the output is the true (pool+1)-th
// value of the row (the rank-safe pool's outside maximum). The output is a
// function of the keys alone, so it equals the plain sort bit for bit. The
// TPU's rules on M (a power of two, a multiple of 1024) do not apply: a row
// of any length up to 65,536 keys is padded with INT32_MIN, which can never
// enter the top bs. start_block only promises presorted blocks; the warp
// route does not need it.
//
// Bound on the H100: reading the row once (4 bytes a key). Two routes,
// chosen by bs, not as a fallback:
//
// bs = 1024 and 2048 (the main path's pool of <= 1023 candidates takes
// 1024): a warp-streaming tournament on the register network of
// bitonic_regs.cuh. W warps split a row (W = 1..8, at least 8 bs-blocks
// each); a warp keeps the running top bs of its share in registers, R = bs /
// 32 keys a lane, sorted ascending. It reads its next bs keys with coalesced
// (16-byte where aligned) loads and keeps those above the running bs-th
// value (an exact filter: a key at or below it cannot change the top bs as
// a multiset of values), compacted by ballot into a per-warp buffer in
// shared memory. Whenever the buffer holds bs keys, the warp sorts them
// descending in registers (55 stages at bs 1024: 40 in-register, 15 by
// shuffle; no shared memory, no barrier), takes the elementwise max with the
// running block (as in _bitonic_topp_kernel: exactly the top bs of their
// union, as a bitonic sequence) and merges that ascending (10 stages). What
// is left in the buffer at the end goes in padded with INT32_MIN. The W
// running blocks then meet in log2(W) pairing rounds through shared memory,
// 4 KB (8 KB) a block. The row never sits whole in shared memory, so a row of
// 65,536 keys needs no cluster on this route.
//
// bs >= 4096 (no main path; the tests, up to 32,768): the shared-memory
// tournament in one CTA of 1024 threads per row, the row in dynamic shared
// memory. The shared network runs up to stop_block = bs, leaving bs-blocks
// sorted alternately ascending / descending. Each pairing round then keeps
// the elementwise max of adjacent blocks in the even block's place, and
// bitonic-merges every surviving block, direction by its new parity.
// Survivors stay where they are (no compaction copy): after g rounds
// logical block b lives at physical block b << g. The last block is logical
// block 0, ascending, at physical 0. A row of more than 32,768 keys runs on
// a cluster of two CTAs, one half each (bitonic_common.cuh). Each half plays
// its own tournament down to one bs-block, the lower half's ascending and
// the upper half's descending (the directions follow the row index), so the
// last pairing round is across the cluster: the lower CTA takes the
// elementwise max with the upper CTA's block through distributed shared
// memory and merges it alone.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "bitonic_common.cuh"
#include "bitonic_regs.cuh"

namespace {

using qfr_bitonic::kThreads;
using qfr_bitonic::slot;
using qfr_regs::kFull;

constexpr int kMaxWarps = 8;        // warps per row on the warp route
constexpr int kBlocksPerWarp = 8;   // bs-blocks of the row per warp, at least

// Fold the bs keys `in` into the running block `top` (ascending, contiguous
// over the warp: lane l holds keys l R .. l R + R - 1).
template <int R>
__device__ __forceinline__ void absorb(int (&top)[R], int (&in)[R], int i0) {
  // `in` descending (its complements sorted ascending): the elementwise max
  // with the ascending `top` is the top bs of their union, a bitonic sequence
#pragma unroll
  for (int r = 0; r < R; ++r) in[r] = ~in[r];
  qfr_regs::warp_sort<R>(in, i0, 32 * R);
#pragma unroll
  for (int r = 0; r < R; ++r) top[r] = max(top[r], ~in[r]);
  qfr_regs::contiguous_stages<R>(top, i0, 16 * R, 64 * R);
}

// The warp route, bs = 32 R. vec: rows may be read as int4.
template <int R>
__global__ void __launch_bounds__(kMaxWarps * 32) topp_warps_kernel(
    const int* __restrict__ keys, int M, int vec, int* __restrict__ out) {
  constexpr int bs = 32 * R;
  extern __shared__ int s[];          // 2 bs words per warp: its buffer, then its pairing block
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, W = blockDim.x >> 5;
  const int i0 = lane * R;
  const unsigned below = (1u << lane) - 1;
  int* buf = s + w * 2 * bs;
  const int* row = keys + static_cast<long long>(blockIdx.x) * M;
  int top[R];
#pragma unroll
  for (int r = 0; r < R; ++r) top[r] = INT_MIN;
  int th = INT_MIN;                   // the running bs-th value: top's key 0
  int n = 0;                          // keys in buf
  for (int b0 = w * bs; b0 < M; b0 += W * bs) {
    int v[R];
    if (vec && b0 + bs <= M) {
      const int4* src = reinterpret_cast<const int4*>(row + b0);
#pragma unroll
      for (int q = 0; q < R / 4; ++q) {
        const int4 u = src[q * 32 + lane];
        v[4 * q] = u.x;
        v[4 * q + 1] = u.y;
        v[4 * q + 2] = u.z;
        v[4 * q + 3] = u.w;
      }
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int gi = b0 + r * 32 + lane;
        v[r] = gi < M ? row[gi] : INT_MIN;
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const bool keep = v[r] > th;
      const unsigned mask = __ballot_sync(kFull, keep);
      if (keep) buf[n + __popc(mask & below)] = v[r];
      n += __popc(mask);
    }
    __syncwarp();
    if (n >= bs) {
      n -= bs;
      int in[R];
#pragma unroll
      for (int r = 0; r < R; ++r) in[r] = buf[n + r * 32 + lane];
      __syncwarp();
      absorb<R>(top, in, i0);
      th = __shfl_sync(kFull, top[0], 0);
    }
  }
  if (n > 0) {
    int in[R];
#pragma unroll
    for (int r = 0; r < R; ++r) in[r] = r * 32 + lane < n ? buf[r * 32 + lane] : INT_MIN;
    absorb<R>(top, in, i0);
  }
  // pairing rounds: warp w + h's block, read reversed (descending), into warp w's
  for (int h = W >> 1; h > 0; h >>= 1) {
    __syncthreads();
    if (w >= h && w < 2 * h) {
#pragma unroll
      for (int r = 0; r < R; ++r) buf[qfr_regs::cpos<R>(lane, r)] = top[r];
    }
    __syncthreads();
    if (w < h) {
      const int* other = s + (w + h) * 2 * bs;
#pragma unroll
      for (int r = 0; r < R; ++r) top[r] = max(top[r], other[qfr_regs::cpos<R>(31 - lane, R - 1 - r)]);
      qfr_regs::contiguous_stages<R>(top, i0, bs / 2, 2 * bs);
    }
  }
  if (w == 0) {
    int4* o = reinterpret_cast<int4*>(out + static_cast<long long>(blockIdx.x) * bs + i0);
#pragma unroll
    for (int q = 0; q < R / 4; ++q)
      o[q] = make_int4(top[4 * q], top[4 * q + 1], top[4 * q + 2], top[4 * q + 3]);
  }
}

template <int R>
cudaError_t launch_warps(const int* keys, int B, int M, int* out, cudaStream_t stream) {
  constexpr int bs = 32 * R;
  const int blocks = (M + bs - 1) / bs;
  int W = 1;
  while (2 * W <= kMaxWarps && 2 * W * kBlocksPerWarp <= blocks) W *= 2;
  const int vec = M % 4 == 0 && reinterpret_cast<uintptr_t>(keys) % 16 == 0;
  return qfr_bitonic::launch_clusters(topp_warps_kernel<R>, B, 1, W * 32,
                                      static_cast<size_t>(W) * 2 * bs * sizeof(int), stream,
                                      keys, M, vec, out);
}

// The shared-memory route, bs >= 4096.
__global__ void __launch_bounds__(kThreads) bitonic_topp_kernel(
    const int* __restrict__ keys, int M, int Mp, int bs, int lbs, int start_block,
    int* __restrict__ out) {
  extern __shared__ int x[];  // this CTA's keys at slot(i)
  const qfr_bitonic::Part p = qfr_bitonic::part_of(Mp);
  qfr_bitonic::load_row(x, keys + p.row * M, M, p, INT_MIN);
  qfr_bitonic::network(x, p.n, start_block, bs, p.base());

  int n = p.n;
  for (int gap = 0; n > bs; ++gap) {
    const qfr_bitonic::Strided cur{lbs, gap};
    for (int t = threadIdx.x; t < (n >> 1); t += kThreads) {
      const int lo = (((t >> lbs) << 1) << lbs) | (t & (bs - 1));  // block 2b, element e
      const int plo = slot(cur(lo)), phi = slot(cur(lo + bs));
      x[plo] = max(x[plo], x[phi]);
    }
    __syncthreads();
    n >>= 1;
    const qfr_bitonic::Strided next{lbs, gap + 1};
    for (int j = bs >> 1; j > 0; j >>= 1) qfr_bitonic::stage(x, n, j, bs, next, p.rank * n);
  }
  if (p.halves == 2) {
    // the last pairing round: logical block 0 of each half sits at physical 0
    qfr_bitonic::cg::cluster_group cluster = qfr_bitonic::cg::this_cluster();
    cluster.sync();
    if (p.rank == 0) {
      const int* other = cluster.map_shared_rank(x, 1);
      for (int i = threadIdx.x; i < bs; i += kThreads) x[slot(i)] = max(x[slot(i)], other[slot(i)]);
    }
    cluster.sync();                       // the upper half stays until it has been read
    if (p.rank == 1) return;
    for (int j = bs >> 1; j > 0; j >>= 1)
      qfr_bitonic::stage(x, bs, j, 2 * bs, qfr_bitonic::Dense());
  }
  int* o = out + p.row * bs;
  for (int i = threadIdx.x; i < bs; i += kThreads) o[i] = x[slot(i)];
}

}  // namespace

// The route is chosen by bs: 1024 and 2048 take the warp route, larger bs
// the shared-memory tournament.
extern "C" int qfr_bitonic_topp(const void* keys, int B, int M, int bs, int start_block,
                                void* out, void* stream) {
  const int Mp = qfr_bitonic::padded_len(M);
  int lbs = 0;
  while ((1 << lbs) < bs) ++lbs;
  if (M < 1 || Mp > qfr_bitonic::kMaxRow || bs < 1024 || (1 << lbs) != bs || 2 * bs > M ||
      !qfr_bitonic::valid_start_block(start_block, Mp) || start_block > 2 * bs)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto k = static_cast<const int*>(keys);
  const auto o = static_cast<int*>(out);
  if (bs == 1024) return static_cast<int>(launch_warps<32>(k, B, M, o, st));
  if (bs == 2048) return static_cast<int>(launch_warps<64>(k, B, M, o, st));
  return static_cast<int>(qfr_bitonic::launch_rows(
      bitonic_topp_kernel, B, Mp, st, k, M, Mp, bs, lbs, start_block, o));
}
