"""Port parity, retriever layer: DenseIndex.search on its three engines
("stream": chunked bf16 matmul; "int8": K1; "int8r": K1's pool reranked on
the int8 rows), the row shuffle, the save/load round trip, DenseRetriever
and the retriever contract helpers, against the JAX package.

The embeddings are integer-valued, so the bf16 stream scores and the int8
kernel's scores are exact and equal bit for bit; the int8r rerank sums
bf16-rounded products in another order (rtol 1e-5, ids up to adjacent
near-tie swaps, as in tests/test_torch_ensemble.py)."""

import numpy as np
import pytest
import torch

from qpp_fusion_rag_tpu.retrievers import base as JB
from qpp_fusion_rag_tpu.retrievers.dense import DenseIndex as JDenseIndex
from qpp_fusion_rag_tpu.retrievers.dense import DenseRetriever as JDenseRetriever
from qpp_fusion_rag_tpu_torch.retrievers import base as TB
from qpp_fusion_rag_tpu_torch.retrievers.dense import DenseIndex, DenseRetriever

N, D, B, K = 1500, 32, 6, 15


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(0)
    emb = rng.integers(-3, 4, (N, D)).astype(np.float32)
    docnos = [f"doc{i}" for i in range(N)]
    q = rng.integers(-2, 3, (B, D)).astype(np.float32)
    return emb, docnos, q


def _swaps_only(ti, ts, ji, tol):
    for b in range(ti.shape[0]):
        i = 0
        while i < ti.shape[1]:
            if ti[b, i] == ji[b, i]:
                i += 1
                continue
            assert i + 1 < ti.shape[1] and ti[b, i] == ji[b, i + 1], (b, i)
            assert ti[b, i + 1] == ji[b, i] and abs(ts[b, i] - ts[b, i + 1]) < tol, (b, i)
            i += 2


@pytest.mark.parametrize("engine", ["stream", "int8", "int8r"])
def test_dense_index_search_matches_jax(corpus, engine):
    emb, docnos, q = corpus
    jidx = JDenseIndex(emb, docnos)
    tidx = DenseIndex(emb, docnos, device="cpu")
    assert tidx.docnos == jidx.docnos                     # the same shuffle
    np.testing.assert_array_equal(tidx.embeddings, jidx.embeddings)
    js, ji = jidx.search(q, k=K, engine=engine, exact=True, rescore_pool=40)
    ts, ti = tidx.search(q, k=K, engine=engine, rescore_pool=40)
    assert ts.shape == ti.shape == (B, K) and isinstance(ts, np.ndarray)
    if engine == "int8r":
        np.testing.assert_allclose(ts, js, rtol=1e-5, atol=1e-6)
        _swaps_only(ti, ts, ji, 1e-5)
    else:
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(ts, js)


def test_dense_index_save_load_round_trip(corpus, tmp_path):
    emb, docnos, q = corpus
    tidx = DenseIndex(emb, docnos, normalize=True, seed=3, device="cpu")
    tidx.save(tmp_path / "t")
    jloaded = JDenseIndex.load(tmp_path / "t")            # the same directory layout
    tloaded = DenseIndex.load(tmp_path / "t", device="cpu")
    assert tloaded.docnos == tidx.docnos == jloaded.docnos
    np.testing.assert_array_equal(tloaded.embeddings, tidx.embeddings)
    for a, b in zip(tloaded.search(q, k=K), tidx.search(q, k=K)):
        np.testing.assert_array_equal(a, b)
    JDenseIndex(emb, docnos, normalize=True, seed=3).save(tmp_path / "j")
    assert DenseIndex.load(tmp_path / "j", device="cpu").docnos == tidx.docnos


def test_dense_retriever_matches_jax(corpus):
    emb, docnos, q = corpus
    queries = {f"q{i}": f"text {i}" for i in range(B)}
    row = {text: i for i, text in enumerate(queries.values())}

    def encoder(texts):
        return q[[row[t] for t in texts]]

    jr = JDenseRetriever(JDenseIndex(emb, docnos), encoder=encoder, exact=True)
    tr = DenseRetriever(DenseIndex(emb, docnos, device="cpu"), encoder=encoder)
    jres = jr.retrieve_batch(queries, top_k=K, batch_size=4)
    tres = tr.retrieve_batch(queries, top_k=K, batch_size=4)
    assert list(tres) == list(jres)
    for qid in queries:
        assert tres[qid].results == jres[qid].results
        assert tres[qid].to_trec_lines("t") == jres[qid].to_trec_lines("t")
        assert tres[qid].latency_ms > 0
    one = tr.retrieve("text 2", "q2", top_k=K)
    assert one.results == jres["q2"].results
    with pytest.raises(RuntimeError, match="encoder"):
        DenseRetriever(tr.index).retrieve("x", "q")


def test_result_helpers_match_jax():
    results = [("a", 3.0, 1), ("b", 1.5, 2), ("c", -2.0, 3)]
    assert TB.normalize_scores(results) == JB.normalize_scores(results)
    assert TB.normalize_scores([("a", 2.0, 1), ("b", 2.0, 2)]) == \
        JB.normalize_scores([("a", 2.0, 1), ("b", 2.0, 2)])
    assert TB.normalize_scores([]) == []
    scores, rows = np.array([0.5, 0.25, -np.inf]), np.array([7, 2, -1])
    names = "abcdefgh".__getitem__
    assert TB.rows_to_results(scores, rows, names) == JB.rows_to_results(scores, rows, names)


def test_dense_index_refuses_mesh_and_unknown_engine(corpus):
    emb, docnos, q = corpus
    idx = DenseIndex(emb, docnos, device="cpu")
    with pytest.raises(ValueError, match="mesh=None"):
        idx.search(q, mesh=object())
    with pytest.raises(ValueError, match="mesh=None"):
        DenseRetriever(idx, mesh=object())
    with pytest.raises(ValueError, match="unknown engine"):
        idx.search(q, engine="hnsw")
    assert idx.device_matrix().dtype == torch.bfloat16
    rows, scale = idx.device_int8()
    assert rows.dtype == torch.int8 and scale.shape == (N,)


def test_dense_index_defaults_to_the_card(corpus):
    """No device means the card, never a quiet move to the CPU: without one,
    the first search raises."""
    emb, docnos, q = corpus
    idx = DenseIndex(emb, docnos)
    assert idx.device.type == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            idx.search(q, k=K)
