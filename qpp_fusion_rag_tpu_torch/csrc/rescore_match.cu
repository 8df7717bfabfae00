// K6: per candidate doc, the unscaled exact rescore sum against its packed
// doc-major term vector:
//   out[b, c] = sum_p imp(row_p) * sum_j [term(row_p) == q_terms[b, j]] * qw[b, j]
// over row = doc_packed[cand_ids[b, c]], term = row >>> imp_bits (logical),
// imp = row & (2^imp_bits - 1), qw = q_weights with pad terms (< 0) zeroed.
//
// Replaces qpp_fusion_rag_tpu/ops/pallas/row_gather.py:rescore_match_pallas
// (_one_chunk, _kernel), which computes the sums of
// ops/sparse.py:_exact_rescore_scores. Contract kept: ids are clamped into
// [0, N) here, and the caller applies doc_scale and masks the -1 ids. The
// TPU's rules (Td fixed at 128, C % 8, B*C % 128, 32,768-id chunks per call)
// do not apply: any Td, any [B, C].
//
// Per element the arithmetic keeps the reference's order: the matched query
// weight accumulates over j in order (query terms may repeat), then one
// rounded product with the impact (__fmul_rn: no contraction into the sum).
// Only the order of the final sum over the row differs from the plain
// version (rtol 4e-6 at Tq <= 16 non-negative terms).
//
// Bound on the H100: random-row DRAM reads. At the rank-safe bench shape
// (B 1024, C 256, Td 128 int32) one view reads 1024 * 256 * 512 B = 134 MB.
//
// Design: one warp per candidate. At Td = 128 each lane loads one int4, so
// the whole 512-byte row is one coalesced warp load; other Td loop over
// 128-key chunks (int4) or fall back to 4-byte loads when Td % 4 != 0 or the
// table is not 16-byte aligned. A warp-shuffle tree sums the lanes. Eight
// warps per CTA keep many independent row loads in flight per SM.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;

struct Query {
  const int* __restrict__ terms;
  const float* __restrict__ weights;
  int tq, imp_bits;
  unsigned mask;

  // sum over the n <= 4 entries e[0..n) of imp * matched weight, in order
  template <int n>
  __device__ __forceinline__ float contrib(const int (&e)[4]) const {
    int t[n];
    float matched[n];
#pragma unroll
    for (int u = 0; u < n; ++u) {
      t[u] = static_cast<int>(static_cast<unsigned>(e[u]) >> imp_bits);
      matched[u] = 0.f;
    }
    for (int j = 0; j < tq; ++j) {
      const int q = __ldg(terms + j);
      const float w = q >= 0 ? __ldg(weights + j) : 0.f;
#pragma unroll
      for (int u = 0; u < n; ++u) matched[u] = __fadd_rn(matched[u], t[u] == q ? w : 0.f);
    }
    float s = 0.f;
#pragma unroll
    for (int u = 0; u < n; ++u) {
      const float imp = static_cast<float>(static_cast<unsigned>(e[u]) & mask);
      s = __fadd_rn(s, __fmul_rn(matched[u], imp));
    }
    return s;
  }
};

__global__ void __launch_bounds__(kWarps * 32) rescore_match_kernel(
    const int* __restrict__ doc, long long N, int Td, const int* __restrict__ ids,
    long long G, int C, const int* __restrict__ q_terms, const float* __restrict__ q_weights,
    int Tq, int imp_bits, int vec, float* __restrict__ out) {
  const long long g = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (g >= G) return;  // warp-uniform
  const int lane = threadIdx.x & 31;
  const long long b = g / C;
  long long d = ids[g];
  d = d < 0 ? 0 : (d >= N ? N - 1 : d);
  const int* row = doc + d * Td;
  const Query q{q_terms + b * Tq, q_weights + b * Tq, Tq, imp_bits, (1u << imp_bits) - 1u};
  float acc = 0.f;
  if (vec) {
    for (int c = lane * 4; c < Td; c += 128) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(row + c));
      const int e[4] = {v.x, v.y, v.z, v.w};
      acc = __fadd_rn(acc, q.contrib<4>(e));
    }
  } else {
    for (int c = lane; c < Td; c += 32) {
      const int e[4] = {__ldg(row + c), 0, 0, 0};
      acc = __fadd_rn(acc, q.contrib<1>(e));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) out[g] = acc;
}

}  // namespace

extern "C" int qfr_rescore_match(const void* doc_packed, long long N, int Td, const void* cand_ids,
                                 long long G, int C, const void* q_terms, const void* q_weights,
                                 int Tq, int imp_bits, int vec, void* out, void* stream) {
  if (N < 1 || Td < 1 || C < 1 || G < 0 || G % C != 0 || Tq < 0 || imp_bits < 1 ||
      imp_bits > 30 || (vec && Td % 4 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (G == 0) return static_cast<int>(cudaSuccess);
  const long long blocks = (G + kWarps - 1) / kWarps;
  rescore_match_kernel<<<static_cast<unsigned>(blocks), kWarps * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(doc_packed), N, Td, static_cast<const int*>(cand_ids), G, C,
      static_cast<const int*>(q_terms), static_cast<const float*>(q_weights), Tq, imp_bits, vec,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
