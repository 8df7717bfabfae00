"""Port parity, autotuners: qpp_fusion_rag_tpu_torch.index.autotune's
autotune_sparse (over the port's SparseIndex) and autotune_dense (over the
port's DenseIndex) pick the same configuration as the JAX package's on the
same index and sample, sweep the same points at the same cost, and flag an
unreachable target as JAX does.

The sparse sweep's exact selections (q8's top-k, q8r's pool where it is a
strict part of the row) take the bitonic pool in the port, the TPU's tie
order, and lax.top_k in JAX on the CPU. So each sweep point's recall is
held against its own scorers: with the port's scorers told to take
lax.top_k's order (bitonic=False), the port's autotune_sparse returns
JAX's result exactly, sweep included; with the bitonic pool, its sweep
points and costs are JAX's, each recall is its bitonic scorers', and its
choice follows JAX's rule (equal to JAX's wherever the two tie orders give
the same recalls). The dense sweep's recalls are equal: integer-valued
embeddings make every score exact."""

from dataclasses import asdict

import numpy as np
import pytest
import torch

from qpp_fusion_rag_tpu.index import autotune as JA
from qpp_fusion_rag_tpu.index.sparse import SparseIndex as JSparse
from qpp_fusion_rag_tpu.retrievers.dense import DenseIndex as JDense
from qpp_fusion_rag_tpu_torch.index import autotune as TA
from qpp_fusion_rag_tpu_torch.index import engines as TE
from qpp_fusion_rag_tpu_torch.index.sparse import SparseIndex as TSparse
from qpp_fusion_rag_tpu_torch.ops import sparse as TSP
from qpp_fusion_rag_tpu_torch.retrievers.dense import DenseIndex as TDense


@pytest.fixture(scope="module")
def sparse_pair():
    """The JAX test's index (tests/test_autotune.py): 800 docs of 14 words
    from 120, quantized; 24 three-word queries."""
    rng = np.random.default_rng(7)
    vocab = [f"w{j}" for j in range(120)]
    docs = [(f"d{i}", " ".join(rng.choice(vocab, 14))) for i in range(800)]
    queries = [" ".join(rng.choice(vocab, 3)) for _ in range(24)]
    j, t = JSparse.build_bm25(docs), TSparse.build_bm25(docs, device="cpu")
    j.quantize()
    t.quantize()
    return j, t, queries


def _bitonic_recalls(t, queries, sweep, k):
    """Each sweep point's recall through the port's scorers called directly
    with the bitonic pool (the route of the port's search)."""
    k_deep = min(max(4 * k, k + 16), t.num_docs)
    es, ei = t.search(queries, k=k_deep, p_cap=t.max_df, engine="exact")
    qt, qw = map(torch.as_tensor, t.encode_queries(queries))
    packed, offs, sc = t._device_packed()
    dp, ds, bits = t._device_doc_vectors()
    out = []
    for s in sweep:
        if s["engine"] == "q8":
            _, got = TSP.sparse_score_topk_q8(packed, offs, sc, qt, qw, k=k, p_cap=s["p_cap"],
                                              exact_topk=True)
        else:
            _, got = TSP.sparse_score_topk_q8_rescored(
                packed, offs, sc, dp, ds, qt, qw, k=k, p_cap=s["p_cap"],
                candidates=s["candidates"], imp_bits=bits)
        out.append(TA._recall_at_k(es, ei, got.numpy(), k))
    return out


def _lax_order(monkeypatch):
    """The port's index scorers with lax.top_k's tie order (bitonic=False)."""
    for name in ("sparse_score_topk_q8", "sparse_score_topk_q8_rescored"):
        fn = getattr(TE, name)
        monkeypatch.setattr(TE, name, lambda *a, _fn=fn, **kw: _fn(*a, bitonic=False, **kw))


def _rule(sweep, target):
    """JAX's choice rule: the cheapest feasible point, else the best recall."""
    feasible = [s for s in sweep if s["recall"] >= target]
    return min(feasible, key=lambda s: s["cost"]) if feasible else \
        max(sweep, key=lambda s: s["recall"])


def _check_sparse(j, t, queries, monkeypatch, **kw):
    jc = JA.autotune_sparse(j, queries, **kw)
    tc = TA.autotune_sparse(t, queries, **kw)
    with monkeypatch.context() as m:
        _lax_order(m)
        assert asdict(TA.autotune_sparse(t, queries, **kw)) == asdict(jc)   # JAX's result
    keys = ("engine", "p_cap", "candidates", "cost")
    assert [[x[a] for a in keys] for x in tc.sweep] == [[x[a] for a in keys] for x in jc.sweep]
    assert [x["recall"] for x in tc.sweep] == _bitonic_recalls(t, queries, tc.sweep, kw["k"])
    best = _rule(tc.sweep, kw["target_recall"])
    assert (tc.engine, tc.p_cap, tc.candidates, tc.recall, tc.cost) == \
        (best["engine"], best["p_cap"], best["candidates"], best["recall"], best["cost"])
    if [x["recall"] for x in tc.sweep] == [x["recall"] for x in jc.sweep]:
        assert asdict(tc) == asdict(jc)
    return tc, jc


@pytest.mark.parametrize("target,p_caps,cands,same", [
    (0.9, (16, 64), (64, 256), False),     # the JAX test's sweep
    (0.995, (8, 32, 64), (16, 128), True),
])
def test_autotune_sparse_matches_jax(sparse_pair, monkeypatch, target, p_caps, cands, same):
    """`same`: whether the two tie orders pick the same configuration on
    this sample. At JAX's own sweep they do not: lax.top_k's pool of 64
    misses a tied doc the bitonic pool keeps, so JAX's q8r recall at 64
    candidates is below 0.9 and it pays for 256."""
    j, t, queries = sparse_pair
    tc, jc = _check_sparse(j, t, queries, monkeypatch, k=10, target_recall=target,
                           p_caps=p_caps, candidate_sizes=cands)
    assert ((tc.engine, tc.p_cap, tc.candidates) == (jc.engine, jc.p_cap, jc.candidates)) \
        == same
    assert len(tc.sweep) == len(p_caps) * (1 + len(cands))
    if tc.meets_target:
        assert tc.recall >= target
    # the chosen config reproduces its recall through the public search API
    s_ex, i_ex = t.search(queries, k=40, p_cap=t.max_df, engine="exact", exact_topk=True)
    _, got = t.search(queries, k=10, p_cap=tc.p_cap, engine=tc.engine,
                      candidates=tc.candidates or 2048)
    assert abs(TA._recall_at_k(s_ex, i_ex, got, 10) - tc.recall) < 1e-9


def test_autotune_sparse_unreachable_target_matches_jax(sparse_pair, monkeypatch):
    j, t, queries = sparse_pair
    tc, jc = _check_sparse(j, t, queries, monkeypatch, k=10, target_recall=1.01,
                           p_caps=(1,), candidate_sizes=(16,), baseline_chunk=5)
    assert not tc.meets_target and not jc.meets_target
    assert tc.recall == max(s["recall"] for s in tc.sweep)
    with pytest.raises(ValueError, match="sample"):
        TA.autotune_sparse(t, [])


def test_recall_at_k_matches_jax():
    rng = np.random.default_rng(0)
    es = -np.sort(-rng.integers(0, 6, (5, 12)).astype(np.float32), axis=1)
    ei = np.stack([rng.permutation(30)[:12] for _ in range(5)]).astype(np.int32)
    ei[4, 7:] = -1
    got = np.stack([rng.permutation(30)[:4] for _ in range(5)]).astype(np.int32)
    got[1, 2] = -1
    for k in (1, 4):
        assert TA._recall_at_k(es, ei, got, k) == JA._recall_at_k(es, ei, got, k)
    assert TA._recall_at_k(es, np.full_like(ei, -1), got, 4) == 0.0


@pytest.fixture(scope="module")
def dense_pair():
    """Integer-valued embeddings: the stream and int8 scores are exact, so
    both packages rank alike (tests/test_torch_retrievers.py)."""
    rng = np.random.default_rng(3)
    emb = rng.integers(-3, 4, (600, 48)).astype(np.float32)
    q = emb[rng.choice(600, 20, replace=False)] + rng.integers(-1, 2, (20, 48))
    docnos = [f"d{i}" for i in range(600)]
    return (JDense(emb, docnos, shuffle=False), TDense(emb, docnos, shuffle=False, device="cpu"),
            q.astype(np.float32))


@pytest.mark.parametrize("target,pools", [(0.9, (32, 128)), (0.999, (16, 64, 256))])
def test_autotune_dense_matches_jax(dense_pair, target, pools):
    j, t, q = dense_pair
    kw = dict(k=10, target_recall=target, rescore_pools=pools)
    jc, tc = JA.autotune_dense(j, q, **kw), TA.autotune_dense(t, q, **kw)
    for f in ("engine", "rescore_pool", "recall", "cost", "meets_target"):
        assert getattr(tc, f) == getattr(jc, f), f
    assert tc.sweep == jc.sweep
    assert len(tc.sweep) >= 1 + sum(p >= 10 for p in pools)


def test_autotune_dense_unreachable_target_escalates_as_jax(dense_pair):
    j, t, q = dense_pair
    kw = dict(k=10, target_recall=1.01, rescore_pools=(32,))
    jc, tc = JA.autotune_dense(j, q, **kw), TA.autotune_dense(t, q, **kw)
    assert (tc.engine, tc.recall, tc.meets_target) == ("stream", 1.0, False)
    assert tc.sweep == jc.sweep and tc.cost == jc.cost
    with pytest.raises(ValueError, match="embedding"):
        TA.autotune_dense(t, np.zeros((0, 48), np.float32))
