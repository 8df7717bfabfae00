// K3: posting-window gather, out[g, :] = src[starts[g] : starts[g] + cap].
//
// Replaces qpp_fusion_rag_tpu/ops/pallas/window_gather.py:gather_windows_pallas
// (_gather_kernel), which DMAs 1024-aligned windows into VMEM and realigns
// them with rotates because Mosaic's HBM slices must start on an (8, 128)
// tile. None of that applies here: a contiguous window is a coalesced read.
//
// Bound on the H100: pure data movement. At the main path's SPLADE view
// (G = 1024 * 16 windows, cap = 2048) it reads and writes 134 MB each, so the
// floor is ~80 us at 3.35 TB/s.
//
// Design: one block per window; each thread moves 16 bytes per step. The
// load side reads the two aligned int4 words that cover the (possibly
// unaligned) 4-int span and realigns in registers, so both loads and stores
// are 16-byte and coalesced. The realign shift is uniform per block, so the
// switch does not diverge. The vector path needs P % 4 == 0, cap % 4 == 0 and
// 16-byte aligned pointers (the wrapper decides); otherwise, and for any
// window outside [0, P), a scalar path with per-element bounds runs
// (out-of-range elements read as 0, so a bad start never faults).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int4 realign(int4 lo, int4 hi, int r) {
  switch (r) {
    case 1: return make_int4(lo.y, lo.z, lo.w, hi.x);
    case 2: return make_int4(lo.z, lo.w, hi.x, hi.y);
    default: return make_int4(lo.w, hi.x, hi.y, hi.z);
  }
}

__global__ void __launch_bounds__(kThreads) gather_windows_kernel(
    const int* __restrict__ src, long long P, const int* __restrict__ starts,
    int cap, int* __restrict__ out, int vec) {
  const long long g = blockIdx.x;
  const long long s = starts[g];
  int* dst = out + g * static_cast<long long>(cap);
  if (vec && s >= 0 && s + cap <= P) {
    const long long a = s & ~3LL;  // aligned base at or below s
    const int r = static_cast<int>(s - a);
    const int4* src4 = reinterpret_cast<const int4*>(src + a);
    int4* dst4 = reinterpret_cast<int4*>(dst);
    const int n4 = cap >> 2;
    if (r == 0) {
      for (int i = threadIdx.x; i < n4; i += kThreads) dst4[i] = __ldg(src4 + i);
    } else {
      // src4[i + 1] ends at element a + 4 * n4 + 3 < P: a + cap is a
      // multiple of 4 below P because P % 4 == 0 and r > 0
      for (int i = threadIdx.x; i < n4; i += kThreads)
        dst4[i] = realign(__ldg(src4 + i), __ldg(src4 + i + 1), r);
    }
    return;
  }
  for (int i = threadIdx.x; i < cap; i += kThreads) {
    const long long p = s + i;
    dst[i] = (p >= 0 && p < P) ? src[p] : 0;
  }
}

}  // namespace

extern "C" int qfr_gather_windows(const void* src, long long P, const void* starts,
                                  long long G, int cap, void* out, int vec,
                                  void* stream) {
  gather_windows_kernel<<<static_cast<unsigned>(G), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(src), P, static_cast<const int*>(starts), cap,
      static_cast<int*>(out), vec);
  return static_cast<int>(cudaGetLastError());
}
