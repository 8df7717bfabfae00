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
// A term of a row is >= 0 (a logical shift) and a pad query term < 0, so a
// pad never matches; a weight is added only where the term matches, which
// gives the reference's sums exactly (adding the reference's +0 where it
// does not match changes no sum: the running sum starts at +0 and is never
// -0). Only the order of the final sum over the row differs from the plain
// version (rtol 4e-6 at Tq <= 16 non-negative terms).
//
// MATCHED (a second instance, for the certified scorer): the row's total
// matched query weight, sum_p matched(term_p), accumulated beside the sum
// and written to a second output. It reads the same bytes and writes 4 B a
// candidate more; the instance without it keeps the code above (the same
// SASS as before the output existed). Queries of more than 32 terms take
// its 4-byte-load route whatever the table.
//
// Bound on the H100: random-row DRAM reads. At the rank-safe bench shape
// (B 1024, C 256, Td 128 int32) one view reads 1024 * 256 * 512 B = 134 MB.
//
// Design: query-major. A CTA of 8 warps takes one query b and a block of
// 64 of its candidates, 8 a warp; every thread holds the query's terms and
// weights in registers (Tq padded to a bucket of 8, 16 or 32 with terms that
// match nothing, so the j loop unrolls; longer queries loop over them in
// global memory, L1-resident), off every row's critical path. A warp reads
// its 8 candidates' ids at once (one a lane, clamped) and keeps 4 rows in
// flight: each lane loads its part of the next 4 rows before it matches any
// of them, 16 bytes a load where Td % 4 == 0 and the table is 16-byte
// aligned (one load a lane a row at Td 128), else 4 bytes (a second route of
// the kernel for any other shape). A warp-shuffle tree sums each row's
// lanes.
//
// Measured against the alternative the design left open: bulk asynchronous
// copies (cp.async.bulk completing on an mbarrier with expect_tx) into a
// ring of 2-16 row slots a warp in shared memory, the warp matching rows as
// they land, took at best 0.108 ms (Tq 8) and 0.120 ms (Tq 16) per view at
// the bench shape on an H100, where these register loads (4 rows in flight,
// 8 candidates a warp, the best of depths 2-8 and 4-32 candidates) took
// 0.068 and 0.079-0.082 (PERF.md §6): the ring adds a shared-memory round
// trip and a barrier wait to every row and issues its copies from one lane,
// without more bytes in flight. It was not kept.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kPerWarp = 8;               // candidates a warp takes
constexpr int kDepth = 4;                  // rows in flight a warp
constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------- query terms --

// TQ > 0: the query's terms and weights in registers, padded to TQ with a
// term (-1) that matches no row term.
template <int TQ>
struct Terms {
  int q[TQ];
  float w[TQ];
  __device__ __forceinline__ Terms(const int* __restrict__ qt, const float* __restrict__ qw,
                                   int tq) {
#pragma unroll
    for (int j = 0; j < TQ; ++j) {
      q[j] = j < tq ? __ldg(qt + j) : -1;
      w[j] = j < tq ? __ldg(qw + j) : 0.f;
    }
  }
  // the matched weight of row term t: the weights of the query terms equal
  // to t, summed in j order
  __device__ __forceinline__ float matched(int t) const {
    float m = 0.f;
#pragma unroll
    for (int j = 0; j < TQ; ++j)
      if (t == q[j]) m = __fadd_rn(m, w[j]);
    return m;
  }
};

// TQ == 0: queries of more than 32 terms, read from global memory (L1).
template <>
struct Terms<0> {
  const int* __restrict__ q;
  const float* __restrict__ w;
  int tq;
  __device__ __forceinline__ Terms(const int* qt, const float* qw, int n) : q(qt), w(qw), tq(n) {}
  __device__ __forceinline__ float matched(int t) const {
    float m = 0.f;
    for (int j = 0; j < tq; ++j)
      if (t == __ldg(q + j)) m = __fadd_rn(m, __ldg(w + j));
    return m;
  }
};

// One row entry's term: imp * matched weight.
template <int TQ>
__device__ __forceinline__ float contrib(const Terms<TQ>& terms, int e, int imp_bits,
                                         unsigned mask) {
  const float imp = static_cast<float>(static_cast<unsigned>(e) & mask);
  return __fmul_rn(terms.matched(static_cast<int>(static_cast<unsigned>(e) >> imp_bits)), imp);
}

__device__ __forceinline__ float warp_sum(float acc) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(kFull, acc, off);
  return acc;
}

// This warp's share of the grid: query b, candidates c0 .. c0 + n - 1 (n may
// be <= 0 at the ragged end), and their ids clamped into [0, N), the id of
// candidate c0 + k on lane k.
struct Share {
  long long b;
  int c0, n, id;
  __device__ __forceinline__ Share(const int* __restrict__ ids, long long N, int C, int blocks_c) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    b = blockIdx.x / blocks_c;
    c0 = (static_cast<int>(blockIdx.x % blocks_c) * kWarps + warp) * kPerWarp;
    n = min(kPerWarp, C - c0);
    long long d = lane < n ? ids[b * C + c0 + lane] : 0;
    d = d < 0 ? 0 : (d >= N ? N - 1 : d);
    id = static_cast<int>(d);
  }
};

// V entries a lane per 32 V-entry chunk of a row (V = 4: 16-byte loads),
// kDepth rows in flight; MATCHED: the matched weights' sum to `matched` too.
template <int TQ, int V, bool MATCHED>
__global__ void __launch_bounds__(kThreads) rescore_match_kernel(
    const int* __restrict__ doc, long long N, int Td, const int* __restrict__ ids, int C,
    int blocks_c, const int* __restrict__ q_terms, const float* __restrict__ q_weights, int Tq,
    int imp_bits, float* __restrict__ out, float* __restrict__ matched) {
  constexpr int D = kDepth;
  const Share sh(ids, N, C, blocks_c);
  if (sh.n <= 0) return;                    // warp-uniform
  const int lane = threadIdx.x & 31;
  const Terms<TQ> terms(q_terms + sh.b * Tq, q_weights + sh.b * Tq, Tq);
  const unsigned mask = (1u << imp_bits) - 1u;
  for (int k0 = 0; k0 < sh.n; k0 += D) {
    const int* row[D];
    float acc[D];
    float macc[MATCHED ? D : 1];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      row[d] = doc + static_cast<long long>(__shfl_sync(kFull, sh.id, min(k0 + d, sh.n - 1))) * Td;
      acc[d] = 0.f;
      if constexpr (MATCHED) macc[d] = 0.f;
    }
    // one chunk of every row at a time: the rows in flight come from the d
    // loops, and an unrolled chunk loop would only hold more registers
#pragma unroll 1
    for (int cb = 0; cb < Td; cb += 32 * V) {
      const int i = cb + lane * V;
      int e[D][V];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        if (k0 + d < sh.n && i < Td) {
          if constexpr (V == 4) {
            const int4 u = __ldg(reinterpret_cast<const int4*>(row[d] + i));
            e[d][0] = u.x;
            e[d][1] = u.y;
            e[d][2] = u.z;
            e[d][3] = u.w;
          } else {
            e[d][0] = __ldg(row[d] + i);
          }
        }
      }
      if (i < Td) {
#pragma unroll
        for (int d = 0; d < D; ++d) {
          if (k0 + d < sh.n) {
#pragma unroll
            for (int u = 0; u < V; ++u) {
              if constexpr (MATCHED) {
                const unsigned x = static_cast<unsigned>(e[d][u]);
                const float m = terms.matched(static_cast<int>(x >> imp_bits));
                acc[d] = __fadd_rn(acc[d], __fmul_rn(m, static_cast<float>(x & mask)));
                macc[d] = __fadd_rn(macc[d], m);
              } else {
                acc[d] = __fadd_rn(acc[d], contrib(terms, e[d][u], imp_bits, mask));
              }
            }
          }
        }
      }
    }
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float s = warp_sum(acc[d]);
      if (lane == 0 && k0 + d < sh.n) out[sh.b * C + sh.c0 + k0 + d] = s;
      if constexpr (MATCHED) {
        const float m = warp_sum(macc[d]);
        if (lane == 0 && k0 + d < sh.n) matched[sh.b * C + sh.c0 + k0 + d] = m;
      }
    }
  }
}

template <int TQ, int V>
cudaError_t launch(unsigned grid, cudaStream_t st, const int* doc, long long N, int Td,
                   const int* ids, int C, int blocks_c, const int* qt, const float* qw, int Tq,
                   int imp_bits, float* out, float* matched) {
  if (matched) {
    // over 32 query terms with 16-byte loads ptxas spilled this instance's
    // registers (12 bytes): it takes the 4-byte loads, which read any table
    constexpr int VM = TQ == 0 ? 1 : V;
    rescore_match_kernel<TQ, VM, true><<<grid, kThreads, 0, st>>>(
        doc, N, Td, ids, C, blocks_c, qt, qw, Tq, imp_bits, out, matched);
  } else {
    rescore_match_kernel<TQ, V, false><<<grid, kThreads, 0, st>>>(
        doc, N, Td, ids, C, blocks_c, qt, qw, Tq, imp_bits, out, matched);
  }
  return cudaGetLastError();
}

// Calls launch<TQ, V> for Tq's bucket of query terms (with 4-byte loads, no
// bucket of 32).
template <int V>
cudaError_t launch_bucket(unsigned grid, cudaStream_t st, const int* doc, long long N, int Td,
                          const int* ids, int C, int blocks_c, const int* qt, const float* qw,
                          int Tq, int imp_bits, float* out, float* matched) {
  if (Tq <= 8)
    return launch<8, V>(grid, st, doc, N, Td, ids, C, blocks_c, qt, qw, Tq, imp_bits, out,
                        matched);
  if (Tq <= 16)
    return launch<16, V>(grid, st, doc, N, Td, ids, C, blocks_c, qt, qw, Tq, imp_bits, out,
                         matched);
  if constexpr (V == 4) {       // with 4-byte loads ptxas spilled this bucket's registers
    if (Tq <= 32)
      return launch<32, V>(grid, st, doc, N, Td, ids, C, blocks_c, qt, qw, Tq, imp_bits, out,
                           matched);
  }
  return launch<0, V>(grid, st, doc, N, Td, ids, C, blocks_c, qt, qw, Tq, imp_bits, out,
                      matched);
}

}  // namespace

// vec: 16-byte loads (Td % 4 == 0 and a 16-byte-aligned table), else 4-byte.
// matched: null, or a second [B, C] output of each row's matched weight.
extern "C" int qfr_rescore_match(const void* doc_packed, long long N, int Td, const void* cand_ids,
                                 int B, int C, const void* q_terms, const void* q_weights, int Tq,
                                 int imp_bits, int vec, void* out, void* matched, void* stream) {
  if (N < 1 || N > (1ll << 31) || Td < 1 || B < 0 || C < 1 || Tq < 0 || imp_bits < 1 ||
      imp_bits > 30 || (vec && Td % 4 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  const int blocks_c = (C + kWarps * kPerWarp - 1) / (kWarps * kPerWarp);
  const long long blocks = static_cast<long long>(B) * blocks_c;
  if (blocks > 0x7fffffffll) return static_cast<int>(cudaErrorInvalidValue);
  const auto grid = static_cast<unsigned>(blocks);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto doc = static_cast<const int*>(doc_packed);
  const auto ids = static_cast<const int*>(cand_ids);
  const auto qt = static_cast<const int*>(q_terms);
  const auto qw = static_cast<const float*>(q_weights);
  const auto o = static_cast<float*>(out);
  const auto m = static_cast<float*>(matched);
  return static_cast<int>(
      vec ? launch_bucket<4>(grid, st, doc, N, Td, ids, C, blocks_c, qt, qw, Tq, imp_bits, o, m)
          : launch_bucket<1>(grid, st, doc, N, Td, ids, C, blocks_c, qt, qw, Tq, imp_bits, o, m));
}
