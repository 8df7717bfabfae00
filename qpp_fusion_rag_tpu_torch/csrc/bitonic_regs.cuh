// Register-resident bitonic network: the stage library of K2
// (bitonic_segsum.cu) and of K4's warp route (bitonic_topp.cu). K5 and K4's
// route for bs > 2048 keep the shared-memory network of bitonic_common.cuh.
//
// A thread holds R keys of its part of a row in a register array x[R],
// indexed only by compile-time constants: every loop over r and over the
// in-register stages unrolls (a runtime index would send the array to local
// memory). T threads hold n = T * R keys in one of two logical layouts:
//   contiguous: x[r] of thread t is key t * R + r;
//   strided:    x[r] of thread t is key r * T + t.
// A compare-exchange stage of distance j runs where the partner already is:
//   j < R, contiguous:          in-thread (registers r and r + j);
//   R <= j < 32 R, contiguous:  __shfl_xor_sync on lane bit j / R;
//   j >= T, strided:            in-thread (registers r and r + j / T).
// With T <= 32 R every stage falls in one of these classes. A round k runs
// its stages j >= T in the strided layout, switches to the contiguous layout
// once through a shared-memory transpose and runs the rest there: at most
// two transposes (four block barriers) per round, where the shared-memory
// network spends one pass over the row and one block barrier per stage.
// The compare direction is that network's: ascending where bit k of the
// key's whole-row index (base + i, Part::base) is clear.
#pragma once

#include <cuda_runtime.h>

namespace qfr_regs {

constexpr unsigned kFull = 0xffffffffu;

// Word of key i in a transpose buffer: one pad word per R keys, so a warp's
// contiguous accesses (t * R + r over its lanes: stride R + 1, odd) and
// strided ones (consecutive words) both hit 32 distinct banks. A buffer of
// n keys takes pad<R>(n) words.
template <int R>
__host__ __device__ constexpr int pad(int i) {
  return i + static_cast<int>(static_cast<unsigned>(i) / R);
}

// pad of key t R + r (contiguous) and of key r T + t (strided, T % R == 0),
// written so that every r is a constant offset from one base.
template <int R>
__device__ __forceinline__ int cpos(int t, int r) { return t * (R + 1) + r; }
template <int T, int R>
__device__ __forceinline__ int spos(int r, int t) { return r * (T + T / R) + pad<R>(t); }

// x <- ~x where `down`: ~ reverses the order, so an ascending network over
// ~x sorts x descending. Every stage whose direction is only known at run
// time (it follows the thread's part of the row index) runs ascending
// between two flips: a min and a max per pair, where selecting between them
// by a runtime direction cost two more instructions per pair (the flips made
// K2 and K4 6-16 % faster on the H100).
template <int R>
__device__ __forceinline__ void flip(int (&x)[R], bool down) {
  const int m = down ? -1 : 0;
#pragma unroll
  for (int r = 0; r < R; ++r) x[r] ^= m;
}

// One in-thread stage: registers r and r + JR pair (bit JR of r clear),
// ascending where bit KB of r is clear (KB > 0: the round's bit k lies in
// the register index, a constant), everywhere with KB == 0.
template <int R, int JR, int KB>
__device__ __forceinline__ void reg_stage(int (&x)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if ((r & JR) == 0) {
      const int lo = min(x[r], x[r + JR]), hi = max(x[r], x[r + JR]);
      const bool asc = KB == 0 || (r & KB) == 0;
      x[r] = asc ? lo : hi;
      x[r + JR] = asc ? hi : lo;
    }
  }
}

// The in-thread stages of register distance JR = R/2 .. 1, those with
// JR <= jr_max (template recursion keeps every distance a constant).
template <int R, int KB, int JR = R / 2>
__device__ __forceinline__ void reg_stages(int (&x)[R], int jr_max) {
  if constexpr (JR >= 1) {
    if (JR <= jr_max) reg_stage<R, JR, KB>(x);
    reg_stages<R, KB, JR / 2>(x, jr_max);
  }
}

// One ascending shuffle stage, contiguous layout, R <= j < 32 R: the
// partner is lane bit j / R away, and the lane with that bit clear keeps
// the min.
template <int R>
__device__ __forceinline__ void shfl_stage(int (&x)[R], int j) {
  const int m = j / R;
  const bool keep_min = (threadIdx.x & m) == 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int y = __shfl_xor_sync(kFull, x[r], m);
    x[r] = keep_min ? min(x[r], y) : max(x[r], y);
  }
}

// Rounds K .. R of the network, those >= k0, entirely in-thread in the
// contiguous layout (i0 = base + t R, a multiple of R): round k < R takes
// its direction from bit k of r, round R from bit R of i0.
template <int R, int K = 2>
__device__ __forceinline__ void thread_rounds(int (&x)[R], int i0, int k0) {
  if constexpr (K < R) {
    if (K >= k0) reg_stages<R, K>(x, K / 2);
    thread_rounds<R, 2 * K>(x, i0, k0);
  } else if (R >= k0) {
    const bool down = (i0 & R) != 0;
    flip(x, down);
    reg_stages<R, 0>(x, R / 2);
    flip(x, down);
  }
}

// Stages j = jtop .. 1 of round k > R in the contiguous layout
// (jtop < 32 R): the direction is bit k of i0 for every key of the thread
// and of its shuffle partners (k > j >= R).
template <int R>
__device__ __forceinline__ void contiguous_stages(int (&x)[R], int i0, int jtop, int k) {
  const bool down = (i0 & k) != 0;
  flip(x, down);
  int j = jtop;
  for (; j >= R; j >>= 1) shfl_stage<R>(x, j);
  reg_stages<R, 0>(x, j);
  flip(x, down);
}

// The in-thread stages j = jtop .. T of round k in the strided layout
// (i0 = base + t): the round's bit k is bit k / T of r while k < T R (a
// constant: one instance per value), else bit k of i0.
template <int T, int R, int KB = 2>
__device__ __forceinline__ void strided_stages(int (&x)[R], int i0, int k, int jtop) {
  if constexpr (KB < R) {
    if (k == KB * T) {
      reg_stages<R, KB>(x, jtop / T);
      return;
    }
    strided_stages<T, R, 2 * KB>(x, i0, k, jtop);
  } else {
    const bool down = (i0 & k) != 0;
    flip(x, down);
    reg_stages<R, 0>(x, jtop / T);
    flip(x, down);
  }
}

// Rounds k = 2 .. kmax over one warp's 32 R keys, contiguous (i0 = lane R):
// with kmax = 32 R the warp's keys end sorted ascending. No shared memory,
// no barrier.
template <int R>
__device__ __forceinline__ void warp_sort(int (&x)[R], int i0, int kmax) {
  thread_rounds<R>(x, i0, 2);
  for (int k = 2 * R; k <= kmax; k <<= 1) contiguous_stages<R>(x, i0, k >> 1, k);
}

// Layout switches of a CTA's T x R keys through shared memory s
// (pad<R>(T R) words). Each starts with a barrier, so s is free.
template <int T, int R>
__device__ __forceinline__ void to_contiguous(int (&x)[R], int* s) {
  const int t = threadIdx.x;
  __syncthreads();
#pragma unroll
  for (int r = 0; r < R; ++r) s[spos<T, R>(r, t)] = x[r];
  __syncthreads();
#pragma unroll
  for (int r = 0; r < R; ++r) x[r] = s[cpos<R>(t, r)];
}

template <int T, int R>
__device__ __forceinline__ void to_strided(int (&x)[R], int* s) {
  const int t = threadIdx.x;
  __syncthreads();
#pragma unroll
  for (int r = 0; r < R; ++r) s[cpos<R>(t, r)] = x[r];
  __syncthreads();
#pragma unroll
  for (int r = 0; r < R; ++r) x[r] = s[spos<T, R>(r, t)];
}

// Stages j = jtop .. 1 of round k > R over a CTA's T x R keys, base = the
// row index of its key 0. Enters in the layout `strided` says, leaves
// contiguous.
template <int T, int R>
__device__ __forceinline__ void block_round(int (&x)[R], int* s, bool& strided, int k, int jtop,
                                            int base) {
  static_assert(T <= 32 * R && T % R == 0, "every stage must be in-thread or a shuffle");
  const int t = threadIdx.x;
  if (jtop >= T) {
    if (!strided) to_strided<T, R>(x, s);
    strided_stages<T, R>(x, base + t, k, jtop);
    to_contiguous<T, R>(x, s);
    jtop = T / 2;
  } else if (strided) {
    to_contiguous<T, R>(x, s);
  }
  strided = false;
  contiguous_stages<R>(x, base + t * R, jtop, k);
}

// Rounds k = k0 .. k1 (see bitonic_common.cuh: network): with k1 = T R the
// CTA's keys end sorted, ascending or descending by bit T R of base;
// k0 > 2 needs aligned k0/2 blocks sorted alternately ascending /
// descending. Ends contiguous.
template <int T, int R>
__device__ __forceinline__ void block_network(int (&x)[R], int* s, bool& strided, int k0, int k1,
                                              int base) {
  if (k0 <= R) {
    if (strided) to_contiguous<T, R>(x, s);
    strided = false;
    thread_rounds<R>(x, base + threadIdx.x * R, k0);
  }
  for (int k = k0 > R ? k0 : 2 * R; k <= k1; k <<= 1)
    block_round<T, R>(x, s, strided, k, k >> 1, base);
}

}  // namespace qfr_regs
