"""Port parity, sparse and two-stage retrievers: qpp_fusion_rag_tpu_torch
.retrievers.{bm25,splade,two_stage}, the registry, write_results_trec and
the loaders they use, against the JAX package on the CPU.

SpladeIndex's engines are held as SparseIndex's are
(tests/test_torch_sparse_index.py): "exact" and "q8" bit for bit (q8's
bitonic pool ids against JAX with bitonic=True), "q8r" within rtol 4e-6
against JAX's bitonic=True route and against JAX's own search where the
pool holds the whole row. The retrievers take stub encoders and scorers
with the attributes the JAX code reads; no checkpoint is loaded."""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest

from qpp_fusion_rag_tpu.data import loaders as JL
from qpp_fusion_rag_tpu.index.sparse import SparseIndex as JSparse
from qpp_fusion_rag_tpu.ops import sparse as JSP
from qpp_fusion_rag_tpu.retrievers import base as JB
from qpp_fusion_rag_tpu.retrievers.bm25 import BM25Retriever as JBM25
from qpp_fusion_rag_tpu.retrievers.splade import SpladeIndex as JSplade
from qpp_fusion_rag_tpu.retrievers.splade import SpladeRetriever as JSpladeR
from qpp_fusion_rag_tpu.retrievers import two_stage as JT
from qpp_fusion_rag_tpu_torch import retrievers as TRG
from qpp_fusion_rag_tpu_torch.data import loaders as TL
from qpp_fusion_rag_tpu_torch.index.sparse import SparseIndex as TSparse
from qpp_fusion_rag_tpu_torch.retrievers import base as TB
from qpp_fusion_rag_tpu_torch.retrievers import splade as TS
from qpp_fusion_rag_tpu_torch.retrievers import two_stage as TT
from qpp_fusion_rag_tpu_torch.retrievers.bm25 import BM25Retriever as TBM25
from qpp_fusion_rag_tpu_torch.retrievers.dense import DenseIndex as TDense
from qpp_fusion_rag_tpu_torch.retrievers.splade import SpladeIndex as TSplade
from qpp_fusion_rag_tpu_torch.retrievers.splade import SpladeRetriever as TSpladeR

from test_torch_sparse_index import (
    assert_ids_equal_up_to_near_ties,
    query_texts,
    zipf_text_corpus,
)

K, P_CAP, RTOL, V = 20, 128, 4e-6, 1024


@pytest.fixture(scope="module")
def corpus():
    docs, words = zipf_text_corpus(1500, 500, seed=2)
    queries = query_texts(words, 8, seed=3)
    return docs, {f"q{i}": q for i, q in enumerate(queries)}


class StubSplade:
    """A SPLADE encoder stand-in: word hashes as wordpiece ids, impacts
    from term counts (the attributes JAX's SpladeRetriever reads)."""

    max_len = 48
    cfg = SimpleNamespace(pad_token_id=0, vocab_size=V)

    def tokenizer(self, text):
        return [1 + (sum(map(ord, w)) * 31 + len(w)) % (V - 1) for w in text.split()]

    def top_impacts(self, ids, mask, k):
        tid = np.zeros((ids.shape[0], k), np.int32)
        tw = np.zeros((ids.shape[0], k), np.float32)
        for b in range(ids.shape[0]):
            u, c = np.unique(ids[b][mask[b] > 0], return_counts=True)
            w = (np.log1p(c) + (u % 7) / 8.0).astype(np.float32)
            order = np.lexsort((u, -w))[:k]
            tid[b, :len(order)], tw[b, :len(order)] = u[order], w[order]
        return tid, tw


@pytest.fixture(scope="module")
def splade(corpus):
    docs, queries = corpus
    enc = StubSplade()
    jr = JSpladeR.build(enc, docs, doc_top_terms=16, query_top_terms=8)
    tr = TSpladeR.build(enc, docs, doc_top_terms=16, query_top_terms=8, device="cpu")
    return enc, jr, tr, queries


def test_pad_sequences_matches_jax():
    from qpp_fusion_rag_tpu.encoders.heads import pad_sequences as jpad

    seqs = [[5, 6, 7], list(range(1, 40)), [], [9] * 17]
    for max_len, pad, bucket in ((32, 0, True), (64, 3, True), (20, 1, False)):
        for a, b in zip(TS.pad_sequences(seqs, max_len, pad, bucket),
                        jpad(seqs, max_len, pad, bucket)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_splade_index_build_and_round_trip_match_jax(splade, tmp_path):
    _, jr, tr, _ = splade
    for a in ("offsets", "docs", "weights"):
        np.testing.assert_array_equal(getattr(tr.index, a), getattr(jr.index, a), err_msg=a)
    assert tr.index.docnos == jr.index.docnos and tr.index.max_df == jr.index.max_df
    assert tr.index.max_df > 2 * P_CAP and tr.index.device.type == "cpu"
    jr.index.save(tmp_path / "j")
    tr.index.save(tmp_path / "t")
    for d in ("j", "t"):
        jl, tl = JSplade.load(tmp_path / d), TSplade.load(tmp_path / d, device="cpu")
        for a in ("offsets", "docs", "weights", "docnos", "vocab_size"):
            np.testing.assert_array_equal(getattr(tl, a), getattr(jl, a), err_msg=a)
    assert (tmp_path / "t" / "docnos.txt").read_bytes() == \
        (tmp_path / "j" / "docnos.txt").read_bytes()


def _impacts(jr, queries):
    return jr._encode_queries(list(queries.values()))


@pytest.mark.parametrize("p_cap", [P_CAP, None])
def test_splade_search_impacts_exact_matches_jax(splade, p_cap):
    _, jr, tr, queries = splade
    qt, qw = _impacts(jr, queries)
    js, ji = jr.index.search_impacts(qt, qw, k=K, p_cap=p_cap)
    ts, ti = tr.index.search_impacts(qt, qw, k=K, p_cap=p_cap)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(ts, js)


@pytest.mark.parametrize("presorted", [False, True])
def test_splade_search_impacts_q8_matches_jax(splade, presorted):
    _, jr, tr, queries = splade
    qt, qw = _impacts(jr, queries)
    assert qt.shape == (8, 8)
    kw = dict(k=K, p_cap=P_CAP, engine="q8", presorted=presorted)
    js, ji = jr.index.search_impacts(qt, qw, exact_topk=False, **kw)
    ts, ti = tr.index.search_impacts(qt, qw, exact_topk=False, **kw)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(ts, js)
    ts, ti = tr.index.search_impacts(qt, qw, **kw)
    packed, offs, sc = jr.index._device_packed(P_CAP if presorted else 0)
    bs, bi = JSP.sparse_score_topk_q8(packed, offs, sc, jnp.asarray(qt), jnp.asarray(qw),
                                      k=K, p_cap=P_CAP, exact_topk=True, bitonic=True,
                                      presorted=presorted)
    np.testing.assert_array_equal(ti, np.asarray(bi))
    np.testing.assert_array_equal(ts, np.asarray(bs))


@pytest.mark.parametrize("presorted", [False, True])
def test_splade_search_impacts_q8r_matches_jax(splade, presorted):
    _, jr, tr, queries = splade
    qt, qw = _impacts(jr, queries)
    ts, ti = tr.index.search_impacts(qt, qw, k=K, p_cap=P_CAP, engine="q8r", candidates=256,
                                     presorted=presorted)
    packed, offs, sc = jr.index._device_packed(P_CAP if presorted else 0)
    dp, ds, bits = jr.index._device_doc_vectors()
    js, ji = map(np.asarray, JSP.sparse_score_topk_q8_rescored(
        packed, offs, sc, dp, ds, jnp.asarray(qt), jnp.asarray(qw), k=K, p_cap=P_CAP,
        candidates=256, imp_bits=bits, presorted=presorted, bitonic=True))
    np.testing.assert_allclose(ts, js, rtol=RTOL, atol=0)
    assert_ids_equal_up_to_near_ties(ti, ts, ji)
    kw = dict(k=K, p_cap=P_CAP, engine="q8r", candidates=4096, presorted=presorted)
    js, ji = jr.index.search_impacts(qt, qw, **kw)           # the pool holds the row
    ts, ti = tr.index.search_impacts(qt, qw, **kw)
    np.testing.assert_allclose(ts, js, rtol=RTOL, atol=0)
    assert_ids_equal_up_to_near_ties(ti, ts, ji)


def test_splade_refusals_match_jax(splade):
    _, jr, tr, queries = splade
    qt, qw = _impacts(jr, queries)
    for idx in (jr.index, tr.index):
        with pytest.raises(ValueError, match="unknown engine"):
            idx.search_impacts(qt, qw, engine="q4")
        with pytest.raises(ValueError, match="presorted"):
            idx.search_impacts(qt, qw, presorted=True)
    with pytest.raises(RuntimeError, match="encoder"):
        TSpladeR(tr.index).retrieve("w1 w2", "q")
    with pytest.raises(RuntimeError, match="encoder"):
        TSpladeR(tr.index).retrieve_batch({"q": "w1"})


@pytest.mark.parametrize("engine", ["exact", "q8r"])
def test_splade_retriever_matches_jax(splade, engine):
    enc, jr, tr, queries = splade
    kw = dict(query_top_terms=8, engine=engine, candidates=4096)
    j = JSpladeR(jr.index, encoder=enc, **kw)
    t = TSpladeR(tr.index, encoder=enc, **kw)
    jres = j.retrieve_batch(queries, top_k=K, batch_size=3)
    tres = t.retrieve_batch(queries, top_k=K, batch_size=3)
    assert list(tres) == list(jres)
    for qid in queries:
        _same_results(tres[qid], jres[qid], engine != "exact")
    _same_results(t.retrieve(queries["q1"], "q1", top_k=K), jres["q1"], engine != "exact")


def _same_results(t, j, rescored):
    """Two RetrieverResults: the same docnos and scores (rescored: scores
    within rtol 4e-6, docnos up to adjacent near-tie swaps)."""
    assert t.query_id == j.query_id and t.latency_ms > 0
    if not rescored:
        assert t.results == j.results
        return
    ts = np.array([[s for _, s, _ in t.results]])
    js = np.array([[s for _, s, _ in j.results]])
    np.testing.assert_allclose(ts, js, rtol=RTOL, atol=0)
    names = sorted({d for d, _, _ in t.results + j.results})
    ti = np.array([[names.index(d) for d, _, _ in t.results]])
    ji = np.array([[names.index(d) for d, _, _ in j.results]])
    assert_ids_equal_up_to_near_ties(ti, ts, ji)
    assert [r for _, _, r in t.results] == list(range(1, len(t.results) + 1))


# ------------------------------------------------------------- BM25 ------

@pytest.fixture(scope="module")
def bm25(corpus):
    docs, queries = corpus
    return JSparse.build_bm25(docs), TSparse.build_bm25(docs, device="cpu"), queries


@pytest.mark.parametrize("engine,kw", [("exact", {}), ("exact", dict(p_cap=P_CAP)),
                                       ("q8r", dict(p_cap=P_CAP, candidates=4096)),
                                       ("certified", {})])
def test_bm25_retriever_matches_jax(bm25, engine, kw):
    jidx, tidx, queries = bm25
    j, t = JBM25(jidx, engine=engine, **kw), TBM25(tidx, engine=engine, **kw)
    jres = j.retrieve_batch(queries, top_k=K, batch_size=5)
    tres = t.retrieve_batch(queries, top_k=K, batch_size=5)
    assert list(tres) == list(jres)
    rescored = engine in ("q8r", "certified")
    for qid in queries:
        _same_results(tres[qid], jres[qid], rescored)
    _same_results(t.retrieve(queries["q2"], "q2", top_k=K), jres["q2"], rescored)
    assert tres["q7"].results == []                  # no known term


def test_bm25_constructors_match_jax(corpus, bm25, tmp_path):
    docs, queries = corpus
    jidx, _, _ = bm25
    jidx.save(tmp_path / "bm25")
    j = JBM25.from_index_dir(tmp_path / "bm25", engine="exact")
    for t in (TBM25.from_index_dir(tmp_path / "bm25", engine="exact", device="cpu"),
              TBM25.from_corpus(docs, device="cpu")):
        assert t.index.device.type == "cpu" and t.engine == "exact"
        jres, tres = j.retrieve_batch(queries, top_k=K), t.retrieve_batch(queries, top_k=K)
        for qid in queries:
            assert tres[qid].results == jres[qid].results
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        TBM25.from_terrier(tmp_path / "terrier")


# ------------------------------------------------------- two-stage ------

class StubScorer:
    """A cross-encoder stand-in: word overlap plus a length tie-break."""

    def score_pairs(self, pairs):
        return np.array([len(set(q.split()) & set(d.split())) + len(d) / 1e4
                         for q, d in pairs], np.float32)


def stub_embed(texts):
    """Integer-valued embeddings: dot products exact in any order."""
    out = np.zeros((len(texts), 16), np.float32)
    for i, t in enumerate(texts):
        for w in t.split():
            out[i, sum(map(ord, w)) % 16] += 1.0
    return out


@pytest.mark.parametrize("kind", ["cross", "dense"])
def test_two_stage_matches_jax(bm25, corpus, kind):
    jidx, tidx, queries = bm25
    docs, _ = corpus
    if kind == "cross":
        jr, tr = JT.CrossEncoderReranker(StubScorer(), 7), TT.CrossEncoderReranker(StubScorer(), 7)
    else:
        jr, tr = JT.DenseReranker(stub_embed), TT.DenseReranker(stub_embed)
    j = JT.TwoStageRetriever(JBM25(jidx), jr, dict(docs), first_stage_k=30, name="two")
    t = TT.TwoStageRetriever(TBM25(tidx), tr, dict(docs), first_stage_k=30, name="two")
    assert t.name == "two" and t.first_stage_k == 30
    jres, tres = j.retrieve_batch(queries, top_k=10), t.retrieve_batch(queries, top_k=10)
    for qid in queries:
        assert tres[qid].results == jres[qid].results, qid
    assert tres["q7"].results == []
    one = t.retrieve(queries["q0"], "q0", top_k=10)
    assert one.results == j.retrieve(queries["q0"], "q0", top_k=10).results
    assert [s for _, s, _ in one.results] == sorted((s for _, s, _ in one.results), reverse=True)
    assert TT.TwoStageRetriever(TBM25(tidx), tr, {}).first_stage_k == 100
    assert TT.CrossEncoderReranker(StubScorer()).batch_size == 256
    assert tr.score("w1", []).shape == (0,)


def test_two_stage_reads_get_text_corpora(bm25, corpus):
    """doc_text's lazy-reader branch: any object with get_text."""
    jidx, tidx, queries = bm25
    docs, _ = corpus

    class Reader:
        def __init__(self):
            self.d = dict(docs)

        def get_text(self, docno):
            return self.d[docno]

    j = JT.TwoStageRetriever(JBM25(jidx), JT.DenseReranker(stub_embed), Reader(),
                             first_stage_k=15)
    t = TT.TwoStageRetriever(TBM25(tidx), TT.DenseReranker(stub_embed), Reader(),
                             first_stage_k=15)
    assert t.retrieve(queries["q3"], "q3", 5).results == \
        j.retrieve(queries["q3"], "q3", 5).results


# -------------------------------------------- run files and loaders ------

def test_loaders_match_jax(tmp_path):
    corpus = {"a": "plain text", "b": {"title": "T", "text": "body"}, "c": {"text": "only"}}
    for d in ("a", "b", "c", "missing"):
        assert TL.doc_text(corpus, d) == JL.doc_text(corpus, d)
    qids = ["10", "2", "test3", "test12", "abc", "1f", "test", "0"]
    assert sorted(qids, key=TL.qid_sort_key) == sorted(qids, key=JL.qid_sort_key)
    run = {"10": [("d1", 0.5), ("d2", 1.25)], "2": [("d3", -1.0)], "test1": []}
    TL.write_run_file(run, tmp_path / "t" / "run.res", tag="x")
    JL.write_run_file(run, tmp_path / "j" / "run.res", tag="x")
    assert (tmp_path / "t" / "run.res").read_bytes() == (tmp_path / "j" / "run.res").read_bytes()


@pytest.mark.parametrize("normalize", [False, True])
def test_write_results_trec_matches_jax(bm25, tmp_path, normalize):
    jidx, tidx, queries = bm25
    jres = JBM25(jidx).retrieve_batch(queries, top_k=K)
    tres = TBM25(tidx).retrieve_batch(queries, top_k=K)
    JB.write_results_trec(jres, tmp_path / "j.res", "bm25", normalize=normalize)
    TB.write_results_trec(tres, tmp_path / "t.res", "bm25", normalize=normalize)
    TRG.write_results_trec(tres, tmp_path / "t2.res", "bm25", normalize=normalize)
    want = (tmp_path / "j.res").read_bytes()
    assert want and (tmp_path / "t.res").read_bytes() == want
    assert (tmp_path / "t2.res").read_bytes() == want


# ---------------------------------------------------------- registry ------

def test_get_retriever(bm25, splade, corpus, tmp_path):
    jidx, tidx, queries = bm25
    enc, _, tr, _ = splade
    docs, _ = corpus
    jidx.save(tmp_path / "bm25")
    tr.index.save(tmp_path / "splade")
    emb = stub_embed([x for _, x in docs[:300]])
    TDense(emb, [d for d, _ in docs[:300]], device="cpu").save(tmp_path / "dense")
    assert set(TRG.RETRIEVER_REGISTRY) == {"bm25", "bge", "tct_colbert", "splade",
                                           "bm25_tct", "bm25_monot5"}
    with pytest.raises(KeyError, match="Unknown retriever"):
        TRG.get_retriever("bm26", tmp_path / "bm25")
    r = TRG.get_retriever("bm25", tmp_path / "bm25", device="cpu", engine="exact")
    assert r.retrieve(queries["q0"], "q0", K).results == \
        TBM25(tidx).retrieve(queries["q0"], "q0", K).results
    # the branches that would load a Hugging Face checkpoint
    for name, kw, where in (("splade", {}, "splade"), ("bge", {}, "dense"),
                            ("tct_colbert", {}, "dense"),
                            ("bm25_tct", dict(corpus=dict(docs)), "x"),
                            ("bm25_monot5", dict(corpus=dict(docs)), "x")):
        with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
            TRG.get_retriever(name, tmp_path / where, device="cpu", **kw)
    with pytest.raises(ValueError, match="corpus"):
        TRG.get_retriever("bm25_tct", tmp_path / "x", device="cpu", reranker=object())
    # with the caller's encoder or reranker they serve
    s = TRG.get_retriever("splade", tmp_path / "splade", device="cpu", encoder=enc,
                          query_top_terms=8)
    assert s.retrieve(queries["q0"], "q0", K).results == \
        TSpladeR(tr.index, encoder=enc, query_top_terms=8).retrieve(queries["q0"], "q0",
                                                                    K).results
    two = TRG.get_retriever("bm25_tct", tmp_path / "x", device="cpu", corpus=dict(docs),
                            reranker=TT.DenseReranker(stub_embed), first_stage_k=20)
    assert two.name == "bm25_tct" and two.retrieve(queries["q0"], "q0", 5).results
    mono = TRG.get_retriever("bm25_monot5", tmp_path / "x", device="cpu", corpus=dict(docs),
                             reranker=TT.CrossEncoderReranker(StubScorer()))
    assert mono.name == "bm25_monot5"
    dense = TRG.get_retriever("bge", tmp_path / "dense", device="cpu", encoder=stub_embed)
    assert len(dense.retrieve(docs[5][1], "q", 3).results) == 3
