"""Port parity and soundness, the certified sparse mode (q8c):
qpp_fusion_rag_tpu_torch.ops.sparse.sparse_score_topk_q8_certified against
the JAX package's, and the port alone against brute-force float64 scoring.

Parity is held against JAX called with bitonic=True (its Pallas kernels in
interpret mode): the port's pool follows the TPU's bitonic route, which
orders tied bound sums highest position first where lax.top_k takes the
lowest index first (tests/test_torch_sparse.py). The pools then agree bit
for bit and the rescored f32 sums to rtol 4e-6, so scores are held to rtol
4e-6, ids equal up to adjacent near-tie swaps, slack within the tie band
1e-5 · (|ret_lb| + |bound|), and `certified` equal wherever the slack lies
outside that band around the decision point -tau.

Soundness is the JAX package's contract (tests/test_sparse_certified.py):
wherever the certificate fires, the returned ids carry the true top-k of
the stored f32 weights, scored exhaustively in float64 on the host.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qpp_fusion_rag_tpu.ops import sparse as JSP
from qpp_fusion_rag_tpu_torch.data.synthetic import zipf_bm25_csr, zipf_queries
from qpp_fusion_rag_tpu_torch.ops import sparse as TSP

N_DOCS, B, K = 4096, 16, 10
RTOL = 4e-6                 # f32 rescore sums in another order
TIE = 1e-5                  # the scorer's tie_rel_eps


@pytest.fixture(scope="module")
def csr():
    offsets, docs, weights, _ = zipf_bm25_csr(N_DOCS, vocab_size=1024, avg_doc_len=24.0,
                                              seed=3)
    return offsets, docs, weights


@pytest.fixture(scope="module")
def index(csr):
    """Both posting layouts, the uncut and the doc_cap-cut doc vectors (with
    their tails), the exact f32 vectors, and 16 queries of 8 terms."""
    offsets, docs, weights = csr
    bits = TSP.doc_vector_imp_bits(len(offsets) - 1)
    packed, scales = TSP.pack_postings(docs, weights, offsets)
    dp, ds, _ = TSP.pack_doc_vectors(offsets, docs, weights, N_DOCS, imp_bits=bits)
    doc_lens = np.bincount(docs, minlength=N_DOCS)
    cap = max(int(np.percentile(doc_lens[doc_lens > 0], 99)), 4)
    dpc, dsc, td, tail = TSP.pack_doc_vectors(offsets, docs, weights, N_DOCS, imp_bits=bits,
                                              doc_cap=cap, return_tail=True)
    assert td == cap and (tail > 0).any()           # the cut really drops terms
    doc_terms, doc_w, _ = TSP.pack_doc_vectors_exact(offsets, docs, weights, N_DOCS)
    qt, qw = zipf_queries(offsets, B, n_terms=8, seed=11)
    qt[1, -2:] = -1
    return dict(bits=bits, plain=(packed, offsets.astype(np.int32)), scales=scales,
                full=(dp, ds), cut=(dpc, dsc), tail=tail, exact=(doc_terms, doc_w),
                qt=qt, qw=qw)


def _presorted(csr, ix, p_cap):
    offsets, docs, weights = csr
    packed, off2, _ = TSP.pack_postings_presorted(docs, weights, offsets, cap=p_cap,
                                                  scales=ix["scales"])
    return packed, off2.astype(np.int32)


def host_scores(csr, q_terms, q_weights):
    """Exhaustive scores of the stored f32 weights, accumulated in float64."""
    offsets, docs, weights = csr
    out = np.zeros((q_terms.shape[0], N_DOCS), np.float64)
    for b in range(q_terms.shape[0]):
        for t, w in zip(q_terms[b], q_weights[b]):
            if t >= 0:
                lo, hi = int(offsets[t]), int(offsets[t + 1])
                out[b] += np.bincount(docs[lo:hi], weights=w * weights[lo:hi].astype(np.float64),
                                      minlength=N_DOCS)
    return out


def assert_true_topk(true_row, ids_row, k):
    """The returned ids carry the k largest true scores (ties may swap)."""
    got = np.sort(true_row[ids_row[:k]])[::-1]
    best = np.sort(true_row)[::-1][:k]
    np.testing.assert_allclose(got, best, rtol=1e-5, atol=1e-5)


def _port(postings, ix, doc, **kw):
    """The port's scorer on CPU tensors -> Certificate of numpy arrays."""
    args = (*postings, ix["scales"], *doc, ix["qt"], ix["qw"])
    extra = {name: torch.as_tensor(v) for name, v in kw.items()
             if name in ("tail_max", "doc_terms", "doc_w")}
    rest = {name: v for name, v in kw.items() if name not in extra}
    out = TSP.certify(*map(torch.as_tensor, args), k=K, imp_bits=ix["bits"], **extra, **rest)
    return TSP.Certificate(*(x.numpy() for x in out))


def _assert_ids_equal_up_to_near_ties(ti, ts, ji):
    for b in range(ti.shape[0]):
        i = 0
        while i < ti.shape[1]:
            if ti[b, i] == ji[b, i]:
                i += 1
                continue
            assert i + 1 < ti.shape[1], (b, i)
            assert ti[b, i] == ji[b, i + 1] and ti[b, i + 1] == ji[b, i], (b, i)
            assert abs(ts[b, i] - ts[b, i + 1]) <= RTOL * abs(ts[b, i]), (b, i)
            i += 2


# ------------------------------------------------- parity with JAX --------

# (layout, p_cap, candidates, doc vectors, tails): the plain layout at M =
# 1024 with 256 candidates takes the full-sort pool (K5), at M = 2048 the
# top-bs pool (K4); the presorted layout at M = 2048 the top-bs pool; the
# f32 route at 1024 candidates pools the whole row (topk_first on both
# sides, the outside bound then -inf).
PARITY = {
    "plain-k5-full": ("plain", 128, 256, "full", False),
    "plain-k4-cut-tails": ("plain", 256, 256, "cut", True),
    "presorted-k4-cut-tails": ("presorted", 256, 256, "cut", True),
    "plain-whole-row-f32": ("plain", 128, 1024, "exact", False),
}


@pytest.fixture(scope="module")
def parity_runs(csr, index):
    """Each PARITY case run once on both packages (one JAX compile each)."""
    runs = {}
    for name, (layout, p_cap, cand, doc, tails) in PARITY.items():
        ix = index
        postings = ix["plain"] if layout == "plain" else _presorted(csr, ix, p_cap)
        vec = ix["full"] if doc == "exact" else ix[doc]
        kw = dict(p_cap=p_cap, candidates=cand, presorted=layout == "presorted")
        if tails:
            kw["tail_max"] = ix["tail"]
        if doc == "exact":
            kw["doc_terms"], kw["doc_w"] = ix["exact"]
        jargs = [jnp.asarray(x) for x in (*postings, ix["scales"], *vec, ix["qt"], ix["qw"])]
        jkw = {n: jnp.asarray(v) if isinstance(v, np.ndarray) else v for n, v in kw.items()}
        j = [np.asarray(x) for x in JSP.sparse_score_topk_q8_certified(
            *jargs, k=K, imp_bits=ix["bits"], bitonic=True, **jkw)]
        runs[name] = (_port(postings, ix, vec, **kw), j)
    return runs


@pytest.mark.parametrize("case", list(PARITY))
def test_certified_matches_jax_bitonic_route(parity_runs, case):
    t, (js, ji, jc, jsl) = parity_runs[case]
    assert t.ids.dtype == ji.dtype == np.int32 and t.ids.shape == ji.shape == (B, K)
    np.testing.assert_allclose(t.scores, js, rtol=RTOL, atol=0)
    _assert_ids_equal_up_to_near_ties(t.ids, t.scores, ji)
    band = TIE * (np.abs(t.ret_lb) + np.abs(t.bound))
    finite = np.isfinite(t.slack)
    np.testing.assert_array_equal(finite, np.isfinite(jsl))
    assert (np.abs(t.slack - jsl)[finite] <= band[finite]).all()
    clear = ~finite | (np.abs(t.slack + band) > band)
    np.testing.assert_array_equal(t.certified[clear], jc[clear])
    assert t.certified.any()


def test_tails_and_f32_route_reach_the_certificate(parity_runs, index):
    """The tail bound widens the pooled docs' upper bounds, so it lowers
    the slack of some query and raises none; the f32 route has no rescore
    slack, so its ret_lb is the k-th score itself."""
    kw = dict(p_cap=256, candidates=256)
    tails = _port(index["plain"], index, index["cut"], tail_max=index["tail"], **kw)
    none = _port(index["plain"], index, index["cut"], **kw)
    assert (tails.slack <= none.slack).all() and (tails.slack < none.slack).any()
    t = parity_runs["plain-whole-row-f32"][0]
    kth = t.scores[:, K - 1]
    ok = np.isfinite(kth)
    assert ok.any()
    np.testing.assert_array_equal(t.ret_lb[ok], kth[ok])


# ------------------------------------------- soundness, brute force -------

@pytest.mark.parametrize("p_cap,candidates", [(128, 256), (512, 512)])
def test_certified_queries_are_exact(csr, index, p_cap, candidates):
    t = _port(index["plain"], index, index["full"], p_cap=p_cap, candidates=candidates)
    true = host_scores(csr, index["qt"], index["qw"])
    for b in range(B):
        if t.certified[b]:
            assert_true_topk(true[b], t.ids[b], K)
    # a certificate needs a full finite top-k and a slack within the band
    assert not (t.certified & ~np.isfinite(t.scores[:, K - 1])).any()
    assert not (t.certified & (t.slack < -1e-3 * np.abs(t.scores[:, 0]))).any()


def test_certificate_not_vacuous(index):
    """At a window that covers most lists the certificate fires."""
    t = _port(index["plain"], index, index["full"], p_cap=2048, candidates=1024)
    assert t.certified.mean() > 0.5


def test_tight_window_forces_uncertified(index):
    t = _port(index["plain"], index, index["full"], p_cap=16, candidates=64)
    assert (~t.certified).any()


def test_certified_presorted_is_sound(csr, index):
    """The dual layout's hidden-mass bound takes the window's least stored
    impact; the plain and presorted layouts score the same windows, so
    their certified counts agree up to pool-edge ties."""
    true = host_scores(csr, index["qt"], index["qw"])
    for p_cap in (128, 512):
        t = _port(_presorted(csr, index, p_cap), index, index["full"], p_cap=p_cap,
                  candidates=256, presorted=True)
        assert np.isfinite(t.slack).all()
        assert t.certified.any(), f"nothing certified at p_cap={p_cap}"
        for b in range(B):
            if t.certified[b]:
                assert_true_topk(true[b], t.ids[b], K)
        plain = _port(index["plain"], index, index["full"], p_cap=p_cap, candidates=256)
        assert abs(int(t.certified.sum()) - int(plain.certified.sum())) <= 2


def test_certified_capped_doc_vectors_sound(csr, index):
    """Rows cut at doc_cap under-count long docs; with tail_max the
    certificate stays sound and certifies no more than the uncut rows."""
    true = host_scores(csr, index["qt"], index["qw"])
    t = _port(index["plain"], index, index["cut"], p_cap=512, candidates=256,
              tail_max=index["tail"])
    assert t.certified.any(), "nothing certified with a generous window"
    for b in range(B):
        if t.certified[b]:
            assert_true_topk(true[b], t.ids[b], K)
    full = _port(index["plain"], index, index["full"], p_cap=512, candidates=256)
    assert int(t.certified.sum()) <= int(full.certified.sum())


# ------------------------------------------------------------ parts -------

def test_pack_doc_vectors_exact_byte_equal_to_jax(csr):
    offsets, docs, weights = csr
    for t, j in zip(TSP.pack_doc_vectors_exact(offsets, docs, weights, N_DOCS),
                    JSP.pack_doc_vectors_exact(offsets, docs, weights, N_DOCS)):
        if isinstance(j, np.ndarray):
            assert t.dtype == j.dtype and t.tobytes() == j.tobytes()
        else:
            assert t == j


@pytest.fixture(scope="module")
def long_lists():
    """Lists long enough that 64-term rows at p_cap 2048 exceed 65,536 keys."""
    offsets, docs, weights, _ = zipf_bm25_csr(8000, vocab_size=400, avg_doc_len=60.0, seed=9)
    return offsets, docs, weights


@pytest.mark.parametrize("tq,p_cap,presorted", [(8, 64, True), (8, 64, False),
                                                (64, 2048, True)])
def test_plus_one_sums_and_win_min_match_jax(long_lists, tq, p_cap, presorted):
    """The bound sums (q8 + 1 per contribution) and each window's least
    stored impact equal JAX's lax.sort route (bitonic=False) on both of
    the port's row routes: K2's plain version (M <= 65,536) and
    _sort_row_sums (M = 131,072); pads sum nothing, an empty window reads
    255."""
    offsets, docs, weights = long_lists
    if presorted:
        packed, offs, scales = TSP.pack_postings_presorted(docs, weights, offsets, cap=p_cap)
    else:
        (packed, scales), offs = TSP.pack_postings(docs, weights, offsets), offsets
    qt, qw = zipf_queries(offsets, 4, n_terms=tq, seed=tq + p_cap)
    qt[0, -3:] = -1
    args = (packed, offs.astype(np.int32), scales, qt, qw)
    j_sums, j_sids, j_wmax, _, j_win = JSP._q8_row_sums(
        *map(jnp.asarray, args), p_cap=p_cap, dma_gather=False, bitonic=False,
        presorted=presorted, plus_one=True, return_win_min=True)
    sums, sids, wmax, win = TSP._q8_row_sums(*map(torch.as_tensor, args), p_cap=p_cap,
                                             presorted=presorted, plus_one=True,
                                             return_win_min=True)
    assert sums.shape[1] == tq * p_cap
    np.testing.assert_array_equal(wmax.numpy(), np.asarray(j_wmax))
    np.testing.assert_array_equal(win.numpy(), np.asarray(j_win))
    assert win.dtype == torch.int32 and (win.numpy()[0, -3:] == 255).all()
    j_sums, j_sids = np.asarray(j_sums), np.asarray(j_sids)
    for b in range(4):
        j_pairs = sorted(zip(j_sids[b][j_sums[b] >= 0], j_sums[b][j_sums[b] >= 0]))
        t_pairs = sorted(zip(sids.numpy()[b][sums.numpy()[b] >= 0],
                             sums.numpy()[b][sums.numpy()[b] >= 0]))
        assert j_pairs == t_pairs
    plain, _, _ = TSP._q8_row_sums(*map(torch.as_tensor, args), p_cap=p_cap,
                                   presorted=presorted)
    real = sums.numpy() >= 0
    assert (sums.numpy()[real] > plain.numpy()[real]).all()    # every run gained its count
