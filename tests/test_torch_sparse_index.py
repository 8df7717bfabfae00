"""Port parity, sparse index layer: qpp_fusion_rag_tpu_torch.index against
qpp_fusion_rag_tpu.index on the CPU.

- The native binding (the port's own g++ build of native/sparse_index.cpp)
  exports the same CSR arrays, vocabulary and query terms as the JAX
  package's, embedded NULs included.
- SparseIndex, built from text and from raw CSR: encode_queries is equal,
  and an index saved by either package loads in the other.
- search, per engine, plain and presorted, f32 and quantize()d: "exact"
  and "q8" give equal ids and bit-equal scores. q8's exact selection is the
  bitonic pool, whose tie order is the TPU's (highest position first, where
  lax.top_k takes the lowest), so its ids are compared with JAX called with
  bitonic=True on the JAX index's own arrays, and its scores with JAX's
  search. "q8r" holds to JAX's bitonic=True route within rtol 4e-6 (ids up
  to adjacent near-tie swaps), and to JAX's search where the pool holds the
  whole row.
- search_certified: the three index-level tests of
  tests/test_sparse_certified.py, mirrored, each also held against JAX's
  results outside the certificate's tie band."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qpp_fusion_rag_tpu.data.synthetic import zipf_bm25_csr, zipf_queries
from qpp_fusion_rag_tpu.index.native import NativeIndexBuilder as JBuilder
from qpp_fusion_rag_tpu.index.sparse import SparseIndex as JIndex
from qpp_fusion_rag_tpu.ops import sparse as JSP
from qpp_fusion_rag_tpu_torch.index import engines as TE
from qpp_fusion_rag_tpu_torch.index import native as TN
from qpp_fusion_rag_tpu_torch.index.native import NativeIndexBuilder as TBuilder
from qpp_fusion_rag_tpu_torch.index.sparse import SparseIndex as TIndex
from qpp_fusion_rag_tpu_torch.ops import sparse as TSP

K, P_CAP, RTOL, TIE_REL_EPS = 20, 128, 4e-6, 1e-5


def zipf_text_corpus(n_docs, vocab, seed, lengths=(8, 30)):
    """(docno, text) pairs of Zipf-distributed words w<j>: the frequent
    words' posting lists run far past P_CAP, so the windows truncate."""
    rng = np.random.default_rng(seed)
    words = np.array([f"w{j}" for j in range(vocab)])
    p = 1.0 / np.arange(1, vocab + 1)
    p /= p.sum()
    return [(f"d{i}", " ".join(rng.choice(words, rng.integers(*lengths), p=p)))
            for i in range(n_docs)], words


def query_texts(words, n, seed):
    rng = np.random.default_rng(seed)
    qs = [" ".join(rng.choice(words[:150], rng.integers(2, 7))) for _ in range(n - 2)]
    return qs + [f"{words[3]} {words[3]} {words[40]}",   # a repeated term: qtf 2
                 "nothing here matches"]                  # no term of the vocabulary


@pytest.fixture(scope="module")
def built():
    corpus, words = zipf_text_corpus(1500, 500, seed=0)
    return corpus, query_texts(words, 8, seed=1)


def _pair(corpus, quantized=False):
    j, t = JIndex.build_bm25(corpus), TIndex.build_bm25(corpus, device="cpu")
    if quantized:
        j.quantize()
        t.quantize()
    return j, t


def assert_ids_equal_up_to_near_ties(ti, ts, ji, rtol=RTOL):
    """Equal ids up to the order inside a tie group: a maximal run of
    positions whose consecutive scores differ by at most rtol (f32 sums
    taken in another order turn exact ties into near-ties). A run must hold
    the same ids in both rankings, except the run that reaches the last
    position, which may continue past k with docs of the same score."""
    for b in range(ti.shape[0]):
        lo = 0
        while lo < ti.shape[1]:
            hi = lo + 1
            while hi < ti.shape[1] and (ts[b, hi] == ts[b, hi - 1] or abs(
                    ts[b, hi] - ts[b, hi - 1]) <= rtol * abs(ts[b, hi - 1])):
                hi += 1
            if hi < ti.shape[1]:
                assert sorted(ti[b, lo:hi]) == sorted(ji[b, lo:hi]), (b, lo, hi)
            lo = hi


# ----------------------------------------------------- native binding ------

NATIVE_TEXTS = ["The quick brown fox jumps over the lazy dog",
                "Running runners ran; the runner's RUN\x00hidden after a NUL",
                "café naïve résumé -- unicode and punctuation!!",
                "", "dogs and foxes and dogs again", "x" * 300]


def test_native_builder_matches_jax():
    jb, tb = JBuilder(k1=1.1, b=0.6), TBuilder(k1=1.1, b=0.6)
    jb.add_doc(NATIVE_TEXTS[0])
    tb.add_doc(NATIVE_TEXTS[0])
    jb.add_docs(NATIVE_TEXTS[1:])
    tb.add_docs(NATIVE_TEXTS[1:])
    for b in (jb, tb):
        b.finalize(bm25_weights=True)
    assert (tb.num_terms, tb.num_docs, tb.num_postings) == \
        (jb.num_terms, jb.num_docs, jb.num_postings)
    assert tb.num_docs == len(NATIVE_TEXTS)          # the NUL did not split a doc
    for a, b in zip(tb.export(), jb.export()):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert tb.vocab_dump() == jb.vocab_dump()
    for text in ("quick foxes RUN", "run\x00dog", "unknownword", "dog dog fox"):
        for mt in (64, 2):
            for a, b in zip(tb.query_terms(text, mt), jb.query_terms(text, mt)):
                np.testing.assert_array_equal(a, b)
    fresh = TBuilder()
    fresh.vocab_load(jb.vocab_dump())                # a vocabulary-only instance
    np.testing.assert_array_equal(fresh.query_terms("dog fox")[0],
                                  jb.query_terms("dog fox")[0])
    for b in (jb, tb, fresh):
        b.close()
    tb.close()                                       # closing twice is a no-op


def test_native_library_builds_under_build_not_native():
    path = TN.build_library()
    assert path.parent == TN.BUILD_DIR and path.parent.name == "torch_native"
    assert TN.build_library() == path                # hashed: built once
    assert path.name.startswith("lib") and TN.NATIVE_DIR not in path.parents
    assert path == TN.library_path()


# ------------------------------------------- SparseIndex host methods ------

def test_encode_queries_match_jax(built):
    corpus, queries = built
    j, t = _pair(corpus)
    assert t.device.type == "cpu" and t.params == j.params
    for mt in (None, 64):
        for a, b in zip(t.encode_queries(queries, mt), j.encode_queries(queries, mt)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert t.encode_queries(queries)[0].shape == (len(queries), 8)   # trimmed to 8
    long_q = [" ".join(f"w{j}" for j in range(20))]
    for a, b in zip(t.encode_queries(long_q), j.encode_queries(long_q)):
        np.testing.assert_array_equal(a, b)
    assert t.encode_queries(long_q)[0].shape == (1, 32)
    for name in ("num_docs", "num_terms", "num_postings", "max_df"):
        assert getattr(t, name) == getattr(j, name), name
    assert t.docno(7) == j.docno(7) == "d7"


def test_encode_queries_truncates_by_the_native_rule(built):
    """More known terms than max_terms: the native rule keeps the rarest
    (df ascending, then term id). JAX's index asks its vocabulary-only
    handle, whose rule reads postings it does not hold (a segfault: ROADMAP
    Queue 3, F6); the port applies the rule with the index's df, which must
    equal what a handle WITH postings returns."""
    corpus, queries = built
    t = TIndex.build_bm25(corpus, device="cpu")
    full = JBuilder()
    full.add_docs([x for _, x in corpus])
    full.finalize(bm25_weights=True)
    many = queries + [" ".join(f"w{j}" for j in range(0, 300, 7))]
    for mt in (1, 3, 5):
        ids, wts = t.encode_queries(many, mt)
        assert ids.shape == (len(many), mt)
        for r, text in enumerate(many):
            want_i, want_w = full.query_terms(text, mt)
            n = len(want_i)
            np.testing.assert_array_equal(ids[r, :n], want_i)
            np.testing.assert_array_equal(wts[r, :n], want_w)
            assert (ids[r, n:] == -1).all() and (wts[r, n:] == 0).all()
    full.close()


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_save_load_round_trip_across_packages(built, tmp_path, quantized, writer):
    corpus, queries = built
    j, t = _pair(corpus, quantized)
    (j if writer == "jax" else t).save(tmp_path / "ix")
    jl, tl = JIndex.load(tmp_path / "ix"), TIndex.load(tmp_path / "ix", device="cpu")
    for a in ("offsets", "docs", "weights", "doc_lens", "term_scales"):
        x, y = getattr(tl, a), getattr(jl, a)
        if x is None or y is None:
            assert x is None and y is None and not quantized, a
            continue
        assert x.dtype == y.dtype, a
        np.testing.assert_array_equal(x, y, err_msg=a)
    assert tl.docnos == jl.docnos and tl.vocab_dump == jl.vocab_dump
    assert tl.params == jl.params
    js, ji = jl.search(queries, k=K, p_cap=P_CAP)
    ts, ti = tl.search(queries, k=K, p_cap=P_CAP)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(ts, js)


def test_export_doc_vectors_matches_jax(built, tmp_path):
    corpus, _ = built
    j, t = _pair(corpus[:200], quantized=True)
    for weighting, top in (("bm25", 0), ("tfidf", 3), ("tf", 0)):
        nj = j.export_doc_vectors(tmp_path / "j.tsv", weighting, top)
        nt = t.export_doc_vectors(tmp_path / "t.tsv", weighting, top)
        assert nt == nj == 200
        assert (tmp_path / "t.tsv").read_bytes() == (tmp_path / "j.tsv").read_bytes()
    with pytest.raises(ValueError, match="weighting"):
        t.export_doc_vectors(tmp_path / "x.tsv", "bm42")


# ------------------------------------------------------ search engines ------

@pytest.fixture(scope="module", params=[False, True], ids=["f32", "quantized"])
def pair(request, built):
    corpus, queries = built
    j, t = _pair(corpus, request.param)
    assert j.max_df > 2 * P_CAP                      # the windows truncate
    return j, t, queries


@pytest.mark.parametrize("p_cap", [P_CAP, None])
def test_search_exact_matches_jax(pair, p_cap):
    """p_cap None: min(max_df, 4096) = max_df here, so every posting."""
    j, t, queries = pair
    js, ji = j.search(queries, k=K, p_cap=p_cap)
    ts, ti = t.search(queries, k=K, p_cap=p_cap)
    assert ti.dtype == np.int32 and ts.dtype == np.float32
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(ts, js)
    assert (ti[-1] == -1).all()                      # the query with no known term


@pytest.mark.parametrize("presorted", [False, True])
def test_search_q8_matches_jax(pair, presorted):
    j, t, queries = pair
    kw = dict(k=K, p_cap=P_CAP, engine="q8", presorted=presorted)
    # approximate selection: topk_first on both sides, lax.top_k's order
    js, ji = j.search(queries, exact_topk=False, **kw)
    ts, ti = t.search(queries, exact_topk=False, **kw)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(ts, js)
    # exact selection: the port's bitonic pool (the TPU's tie order)
    js, _ = j.search(queries, **kw)
    ts, ti = t.search(queries, **kw)
    np.testing.assert_array_equal(ts, js)
    qt, qw = j.encode_queries(queries)
    packed, offs, sc = j._device_packed(P_CAP if presorted else 0)
    bs, bi = JSP.sparse_score_topk_q8(packed, offs, sc, jnp.asarray(qt), jnp.asarray(qw),
                                      k=K, p_cap=P_CAP, exact_topk=True, bitonic=True,
                                      presorted=presorted)
    np.testing.assert_array_equal(ti, np.asarray(bi))
    np.testing.assert_array_equal(ts, np.asarray(bs))
    # the index's lazily built layout is JAX's, byte for byte
    for a, b in zip(t._device_packed(P_CAP if presorted else 0), (packed, offs, sc)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("presorted", [False, True])
@pytest.mark.parametrize("candidates", [100, 512])
def test_search_q8r_matches_jax_bitonic_route(pair, presorted, candidates):
    """M = 8 x 128 = 1024: 100 candidates take the top-bs pool (K4's route
    at bs 1024 is the full sort here: 2·bs > M), 512 too; JAX with
    bitonic=True takes the same routes on its own index arrays."""
    j, t, queries = pair
    ts, ti = t.search(queries, k=K, p_cap=P_CAP, engine="q8r", candidates=candidates,
                      presorted=presorted)
    qt, qw = j.encode_queries(queries)
    packed, offs, sc = j._device_packed(P_CAP if presorted else 0)
    dp, ds, bits = j._device_doc_vectors()
    js, ji = map(np.asarray, JSP.sparse_score_topk_q8_rescored(
        packed, offs, sc, dp, ds, jnp.asarray(qt), jnp.asarray(qw), k=K, p_cap=P_CAP,
        candidates=candidates, imp_bits=bits, presorted=presorted, bitonic=True))
    np.testing.assert_allclose(ts, js, rtol=RTOL, atol=0)
    assert_ids_equal_up_to_near_ties(ti, ts, ji)
    tdp, tds, tbits = t._device_doc_vectors()
    assert tbits == bits
    np.testing.assert_array_equal(tdp.numpy(), np.asarray(dp))
    np.testing.assert_array_equal(tds.numpy(), np.asarray(ds))


@pytest.mark.parametrize("presorted", [False, True])
def test_search_q8r_whole_row_pool_matches_jax_search(pair, presorted):
    """candidates >= M: the pool is the whole row and both packages take a
    plain top-k, so JAX's own search is the reference."""
    j, t, queries = pair
    kw = dict(k=K, p_cap=P_CAP, engine="q8r", candidates=2048, presorted=presorted)
    js, ji = j.search(queries, **kw)
    ts, ti = t.search(queries, **kw)
    np.testing.assert_allclose(ts, js, rtol=RTOL, atol=0)
    assert_ids_equal_up_to_near_ties(ti, ts, ji)


def test_sparse_index_from_raw_csr_matches_jax():
    """An index over raw CSR arrays with a query_encoder hook (no
    vocabulary): every engine against JAX."""
    offsets, docs, weights, doc_lens = zipf_bm25_csr(3000, vocab_size=800, avg_doc_len=20.0,
                                                     seed=5)
    qt, qw = zipf_queries(offsets, 8, n_terms=8, seed=6)
    row = {f"q{i}": i for i in range(8)}

    def encoder(texts, max_terms):
        r = [row[x] for x in texts]
        return qt[r], qw[r]

    docnos = [f"d{i}" for i in range(3000)]
    j = JIndex(offsets, docs, weights, doc_lens, docnos, vocab_dump="")
    t = TIndex(offsets, docs, weights, doc_lens, docnos, vocab_dump="", device="cpu")
    j.query_encoder = t.query_encoder = encoder
    texts = list(row)
    for a, b in zip(t.encode_queries(texts), j.encode_queries(texts)):
        np.testing.assert_array_equal(a, b)
    for engine, kw in (("exact", {}), ("q8", dict(exact_topk=False)),
                       ("q8r", dict(candidates=4096))):
        js, ji = j.search(texts, k=K, p_cap=P_CAP, engine=engine, **kw)
        ts, ti = t.search(texts, k=K, p_cap=P_CAP, engine=engine, **kw)
        if engine == "q8r":
            np.testing.assert_allclose(ts, js, rtol=RTOL, atol=0)
            assert_ids_equal_up_to_near_ties(ti, ts, ji)
        else:
            np.testing.assert_array_equal(ti, ji, err_msg=engine)
            np.testing.assert_array_equal(ts, js, err_msg=engine)


def test_search_refusals_match_jax(built):
    corpus, queries = built
    for idx in _pair(corpus[:100]):
        with pytest.raises(ValueError, match="unknown engine"):
            idx.search(queries[:1], engine="q4")
        with pytest.raises(ValueError, match="presorted"):
            idx.search(queries[:1], engine="exact", presorted=True)
        with pytest.raises(ValueError, match="presorted"):
            idx.search(queries[:1], engine="certified", presorted=True)


def test_device_arrays_are_lazy_cached_and_guarded(built, monkeypatch):
    corpus, _ = built
    t = TIndex.build_bm25(corpus[:100], device="cpu")
    assert getattr(t, "_engine_cache", None) is None and t._device is None
    a = t._device_packed(0)
    assert t._device_packed(0) is a and t._device_doc_vectors() is t._device_doc_vectors()
    assert all(x.device.type == "cpu" for x in a)
    dt, dw = t._device_doc_vectors_exact()
    assert dt.dtype == torch.int32 and dw.dtype == torch.float32
    # both int32 guards: postings past 2^31 refuse the device
    big = np.array([0, 2**31], np.int64)
    t.offsets = big
    with pytest.raises(OverflowError, match="int32"):
        t._device_arrays()
    monkeypatch.setattr(t, "_packed_source", lambda: (None, None, big, None))
    monkeypatch.setattr(TE, "pack_postings", lambda *a, **k: (np.zeros(4, np.int32),
                                                               np.ones(1, np.float32)))
    monkeypatch.setattr(TE, "pack_postings_presorted", lambda *a, **k: (
        np.zeros(4, np.int32), big, np.ones(1, np.float32)))
    for cap in (7, 8):
        t._engine_cache.pop(cap, None)
    with pytest.raises(OverflowError, match="int32"):
        t._device_packed(8)
    t._engine_cache.pop(0)
    with pytest.raises(OverflowError, match="int32"):
        t._device_packed(0)


def test_index_defaults_to_the_card(built):
    """No device means the card, never a quiet move to the CPU: without one,
    the first search raises."""
    corpus, queries = built
    idx = TIndex.build_bm25(corpus[:50])
    assert idx.device.type == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            idx.search(queries[:1], k=5)


# ------------------------------------------------- search_certified ------

CERT_DOCS = [(f"d{i}", x) for i, x in enumerate([
    "the quick brown fox jumps over the lazy dog",
    "a fast brown fox leaps across lazy dogs daily",
    "information retrieval systems rank documents by relevance",
    "neural retrieval models learn dense representations of documents",
    "the dog sleeps all day and dreams of foxes",
    "ranking documents with learned sparse representations",
    "dense retrieval needs large document collections indexed well",
    "sparse impact lists rank fox documents quickly",
] * 40)]


def _ladder_clear(t, queries, k, p_cap, candidates, max_rounds):
    """Replay the port's ladder with ops.sparse.certify: True for a query
    whose slack lies outside the tie band in every round it took part in
    (there the certificate decides the same in both packages)."""
    qt, qw = t.encode_queries(queries)
    packed, offs, sc = t._device_packed()
    dp, ds, bits = t._device_doc_vectors()
    dt, dw = t._device_doc_vectors_exact()
    clear = np.ones(len(queries), bool)
    pending, cap, cand = np.arange(len(queries)), t._default_p_cap(p_cap), candidates
    for _ in range(max_rounds):
        if not len(pending):
            break
        c = TSP.certify(packed, offs, sc, dp, ds, torch.as_tensor(qt[pending]),
                        torch.as_tensor(qw[pending]), k=k, p_cap=cap,
                        candidates=min(max(cand, k), max(t.num_docs, 1)), imp_bits=bits,
                        doc_terms=dt, doc_w=dw)
        band = TIE_REL_EPS * (c.ret_lb.abs() + c.bound.abs())
        fin = torch.isfinite(c.slack)
        clear[pending] &= (~fin | ((c.slack + band).abs() > band)).numpy()
        pending = pending[~c.certified.numpy()]
        if cap >= t.max_df:
            break
        cap, cand = min(cap * 4, t.max_df), min(cand * 2, max(t.num_docs, k))
    return clear


def _certified_matches_jax(j, t, queries, **kw):
    js, ji, jinfo = j.search_certified(queries, **kw)
    ts, ti, tinfo = t.search_certified(queries, **kw)
    clear = _ladder_clear(t, queries, kw["k"], kw.get("p_cap"), kw.get("candidates", 1024),
                          kw.get("max_rounds", 2))
    assert clear.any()
    assert tinfo["certified_round"].dtype == jinfo["certified_round"].dtype
    np.testing.assert_array_equal(tinfo["certified_round"][clear],
                                  jinfo["certified_round"][clear])
    np.testing.assert_allclose(ts[clear], js[clear], rtol=RTOL, atol=0)
    assert_ids_equal_up_to_near_ties(ti[clear], ts[clear], ji[clear])
    if clear.all():
        assert tinfo["rounds"] == jinfo["rounds"]
    return ts, ti, tinfo


def test_search_certified_is_exhaustive_exact():
    """tests/test_sparse_certified.py:129: the ladder returns full
    exhaustive results for EVERY query, certified or escalated."""
    j, t = _pair(CERT_DOCS)
    qs = ["brown fox documents", "dense sparse retrieval",
          "lazy dog sleeps", "ranking relevance systems"]
    s_cert, i_cert, info = _certified_matches_jax(j, t, qs, k=8, p_cap=4, candidates=16,
                                                  max_rounds=2)
    s_ex, i_ex = t.search(qs, k=8, p_cap=t.max_df, exact_topk=True, engine="exact")
    np.testing.assert_allclose(np.sort(s_cert, axis=1), np.sort(s_ex, axis=1),
                               rtol=1e-3, atol=1e-3)
    assert info["certified_round"].shape == (4,)
    assert len(info["rounds"]) >= 1


def test_search_certified_no_escalation_when_generous():
    """tests/test_sparse_certified.py:146: distinct docs (tie-free scores)
    at a full window certify every query in round 0."""
    rng = np.random.default_rng(5)
    words = ("fox dog retrieval dense sparse rank document neural learn "
             "impact list index query term weight score fusion brown "
             "lazy quick systems relevance representations").split()
    docs = [(f"u{i}", " ".join(rng.choice(words, size=rng.integers(6, 14))))
            for i in range(300)]
    j, t = _pair(docs)
    qs = ["brown fox documents", "dense sparse retrieval"]
    _, _, info = _certified_matches_jax(j, t, qs, k=5, p_cap=t.max_df, candidates=512)
    assert (info["certified_round"] == 0).all()


def test_search_certified_engine_alias():
    """tests/test_sparse_certified.py:236: search(engine='certified') runs
    the ladder and matches the exact engine's result set."""
    n_docs, k = 8192, 10
    offsets, docs, weights, _ = zipf_bm25_csr(n_docs, vocab_size=2048, avg_doc_len=24.0,
                                              seed=3)
    doc_lens = np.bincount(docs, minlength=n_docs)
    qt, qw = zipf_queries(offsets, 4, n_terms=8, seed=21)
    docnos = [f"d{i}" for i in range(n_docs)]
    j = JIndex(offsets, docs, weights, doc_lens, docnos, vocab_dump="")
    t = TIndex(offsets, docs, weights, doc_lens, docnos, vocab_dump="", device="cpu")
    j.query_encoder = t.query_encoder = lambda texts, mt: (qt[:len(texts)], qw[:len(texts)])
    s_c, i_c = t.search(["q"] * 4, k=k, engine="certified")
    s_e, i_e = t.search(["q"] * 4, k=k, engine="exact")
    np.testing.assert_allclose(np.sort(s_c, axis=1), np.sort(s_e, axis=1),
                               rtol=1e-4, atol=1e-4)
    ts, ti, _ = _certified_matches_jax(j, t, ["q"] * 4, k=k)
    np.testing.assert_array_equal(ts, s_c)
    np.testing.assert_array_equal(ti, i_c)
