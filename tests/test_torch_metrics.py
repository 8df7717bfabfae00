"""Port parity, ops/metrics.py: the five metric reductions (rtol 1e-6: the
discounts' log2 and the f32 sums may differ by an ulp between XLA's CPU
backend and torch), align_relevance (host numpy: equal), compute_measures
over every measure string of config.evaluation.ir_metrics and its errors,
aggregate_measures (1e-6 absolute) and compute_ndcg (equal)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qpp_fusion_rag_tpu.config import config as JCFG
from qpp_fusion_rag_tpu.data.vocab import DocVocab as JVocab
from qpp_fusion_rag_tpu.ops import metrics as JM
from qpp_fusion_rag_tpu_torch.config import config as TCFG
from qpp_fusion_rag_tpu_torch.data.vocab import DocVocab as TVocab
from qpp_fusion_rag_tpu_torch.ops import metrics as TM

RTOL = 1e-6
Q, K = 48, 30


def _gains(seed):
    rng = np.random.default_rng(seed)
    gains = (rng.integers(0, 3, (Q, K)) * (rng.uniform(size=(Q, K)) < 0.3)).astype(np.float32)
    gains[:4] = 0                                   # queries with no relevant doc retrieved
    gains[5, :] = 0
    gains[5, K - 1] = 2                             # only the last rank
    n_rel = ((gains > 0).sum(-1) + rng.integers(0, 4, Q)).astype(np.int32)
    n_rel[:2] = 0                                   # unjudged: no relevant doc at all
    ideal = np.zeros((Q, K + 10), np.float32)
    for q in range(Q):
        pos = np.sort(np.concatenate([gains[q][gains[q] > 0],
                                      rng.integers(1, 3, n_rel[q] - (gains[q] > 0).sum())]))
        ideal[q, :len(pos)] = pos[::-1][:K + 10]
    return gains, n_rel, ideal


@pytest.mark.parametrize("k", [5, K, K + 7])
@pytest.mark.parametrize("fn", ["ndcg_at", "rr_at", "recall_at", "precision_at"])
def test_cutoff_metrics_match_jax(fn, k):
    gains, n_rel, ideal = _gains(k)
    args = {"ndcg_at": (gains, ideal), "rr_at": (gains,), "recall_at": (gains, n_rel),
            "precision_at": (gains,)}[fn]
    want = np.asarray(getattr(JM, fn)(*map(jnp.asarray, args), k=k))
    got = getattr(TM, fn)(*map(torch.as_tensor, args), k=k)
    assert got.dtype == torch.float32 and got.shape == (Q,)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)
    assert (got.numpy() > 0).any() and (got.numpy() == 0).any()


def test_average_precision_and_first_relevant_rank():
    gains, n_rel, _ = _gains(1)
    want = np.asarray(JM.average_precision(jnp.asarray(gains), jnp.asarray(n_rel)))
    got = TM.average_precision(torch.as_tensor(gains), torch.as_tensor(n_rel)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    g = torch.tensor([[0, 0, 2, 1], [1, 0, 0, 0], [0, 0, 0, 0], [0, 0, 0, 3]], dtype=torch.float32)
    np.testing.assert_array_equal(TM.rr_at(g, 4).numpy(), np.float32([1 / 3, 1, 0, 0.25]))
    np.testing.assert_array_equal(TM.rr_at(g, 2).numpy(), [0, 1, 0, 0])


def test_align_relevance_matches_jax():
    rng = np.random.default_rng(2)
    docnos = [f"d{i}" for i in range(60)]
    tv, jv = TVocab(docnos), JVocab(docnos)
    doc_ids = rng.integers(-1, 60, (12, 15)).astype(np.int32)
    qids = [f"q{i}" for i in range(12)]
    qrels = {f"q{i}": {f"d{d}": int(g) for d, g in zip(rng.choice(80, 6, replace=False),
                                                        rng.integers(-1, 3, 6))}
             for i in range(0, 12, 2)}            # d60..d79 are unknown to the vocab
    qrels["q4"] = {}
    for ideal_k in (None, 25):
        got = TM.align_relevance(doc_ids, qids, qrels, tv, ideal_k=ideal_k)
        want = JM.align_relevance(doc_ids, qids, qrels, jv, ideal_k=ideal_k)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    # n_rel counts relevant docs that no run retrieved (or the vocab lacks)
    assert (got[1] >= (got[0] > 0).sum(-1)).all() and got[1].sum() > (got[0] > 0).sum()


def test_compute_measures_every_configured_measure():
    names = list(TCFG.evaluation.ir_metrics) + ["MRR@3", "recall@7", "precision@4", "MAP",
                                                "nDCG", "RR", "R@50", "nDCG@40"]
    assert list(TCFG.evaluation.ir_metrics) == list(JCFG.evaluation.ir_metrics)
    gains, n_rel, ideal = _gains(3)
    want = JM.compute_measures(names, *map(jnp.asarray, (gains, n_rel, ideal)))
    for got in (TM.compute_measures(names, gains, n_rel, ideal, device="cpu"),
                TM.compute_measures(names, *map(torch.as_tensor, (gains, n_rel, ideal)))):
        assert list(got) == list(want) == names
        for name in names:
            assert got[name].device.type == "cpu"
            np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                       rtol=RTOL, atol=0, err_msg=name)
    for bad in ("R", "P", "recall", "foo@3", "ERR@10"):
        for mod in (TM, JM):
            with pytest.raises(ValueError):
                mod.compute_measures([bad], gains, n_rel, ideal, *([] if mod is JM else ["cpu"]))
    assert TM.parse_measure("nDCG@10") == JM.parse_measure("nDCG@10") == ("nDCG", 10)
    assert TM.parse_measure("AP") == JM.parse_measure("AP") == ("AP", None)


def test_aggregate_measures_matches_jax():
    gains, n_rel, ideal = _gains(4)
    names = list(TCFG.evaluation.ir_metrics)
    judged = np.random.default_rng(4).uniform(size=Q) < 0.7
    got = TM.aggregate_measures(TM.compute_measures(names, gains, n_rel, ideal, device="cpu"),
                                judged)
    want = JM.aggregate_measures(JM.compute_measures(names, gains, n_rel, ideal), judged)
    assert list(got) == list(want)
    for name in names:
        assert isinstance(got[name], float)
        assert abs(got[name] - want[name]) <= 1e-6, name
    none = TM.aggregate_measures({"AP": torch.ones(Q)}, np.zeros(Q, bool))
    assert none == JM.aggregate_measures({"AP": np.ones(Q)}, np.zeros(Q, bool)) == {"AP": 0.0}


@pytest.mark.parametrize("case", range(6))
def test_compute_ndcg_equals_jax(case):
    ranked = [f"d{i}" for i in range(12)]
    qrels = [{"d0": 1, "d5": 2, "x": 2}, {"d11": 1}, {}, {"d3": 0, "d4": -1},
             {f"d{i}": 1 for i in range(20)}, {"d1": 2}][case]
    for k in (1, 5, 10, 30):
        for docs in (ranked, ranked[:3], []):
            got = TM.compute_ndcg(docs, qrels, k=k)
            assert got == JM.compute_ndcg(docs, qrels, k=k)
            assert 0.0 <= got <= 1.0
