"""Sparse- and dense-engine autotuners: pick the cheapest production
configuration that meets a recall target on YOUR index and query mix.

Counterpart of qpp_fusion_rag_tpu/index/autotune.py, the same algorithm
and cost models. The production sparse engines trade exactness for
throughput along two axes, window depth `p_cap` and, for the rank-safe
`q8r` engine, the rescore pool `candidates`; the dense ones along the int8
scores and the int8r rescore pool. These functions measure recall@k
against full-depth exact scoring on a query sample and return the cheapest
configuration meeting the target. The searches run wherever the index's
`device` puts them (the card by default).

Cost model (relative, not wall-clock): the q8 kernels' dominant costs
scale with the gathered window area B·Tq·p_cap (HBM traffic and sort
stages); the q8r rescore adds candidates·Td row-gather traffic. The model
only needs to ORDER configurations.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np


@dataclass
class TunedConfig:
    engine: str                 # "q8" | "q8r"
    p_cap: int
    candidates: int             # 0 for q8
    recall: float               # measured recall@k vs full-depth exact
    cost: float                 # relative cost-model units
    meets_target: bool
    sweep: List[dict] = field(default_factory=list)


def _recall_at_k(exact_scores: np.ndarray, exact_ids: np.ndarray,
                 got_ids: np.ndarray, k: int,
                 rel_tol: float = 1e-5) -> float:
    """TIE-AWARE recall@k: a returned doc counts as a hit if its exact
    score reaches the exact k-th score (within rel_tol) — any doc tied
    at the boundary is as good as the one the exact tie-break happened
    to pick. Plain set-recall would punish tie-ORDER divergence between
    engines, systematically underrating the rescored engines on tied
    score distributions. exact_ids/exact_scores should be deeper than k
    (boundary ties extend past position k)."""
    hits, total = 0, 0
    for sc, a, b in zip(exact_scores, exact_ids, got_ids):
        valid = a >= 0
        if not valid[:k].any():
            continue
        kth = sc[:k][valid[:k]].min()
        thresh = kth - rel_tol * max(abs(kth), 1.0)
        good = set(int(x) for x, s, v in zip(a, sc, valid)
                   if v and s >= thresh)
        got = [int(x) for x in b[:k] if x >= 0]
        hits += sum(1 for g in got if g in good)
        total += min(k, int(valid.sum()))
    return hits / max(total, 1)


def autotune_sparse(
    index,
    sample_queries: Sequence[str],
    k: int = 10,
    target_recall: float = 0.99,
    p_caps: Sequence[int] = (1024, 2048, 4096),
    candidate_sizes: Sequence[int] = (512, 1024, 2048),
    max_sample: int = 256,
    avg_query_terms: Optional[float] = None,
    baseline_chunk: int = 8,
) -> TunedConfig:
    """-> the cheapest (engine, p_cap, candidates) meeting target_recall
    at recall@`k` vs full-depth exact scoring on `sample_queries`.

    `index` is a SparseIndex (index/sparse.py). Sweeps q8 over `p_caps`
    and q8r over the (p_cap, candidates) grid, measures each config's
    recall on the sample, and returns the feasible config with the
    lowest modeled cost; if nothing meets the target the best-recall
    config is returned with meets_target=False (escalate to
    `search_certified` or engine="exact" in that case).

    Every configuration (including the exact baseline) is measured at
    this `k`; use the k you actually serve.
    """
    qs = list(sample_queries)[:max_sample]
    if not qs:
        raise ValueError("need at least one sample query")
    # 4k-deep exact baseline: boundary ties extend past position k, and
    # the tie-aware measure needs their scores. Full-depth exact search
    # materializes [B, Tq, max_df] windows — possibly GBs per query
    # batch on a production index (SparseIndex.search docstring) — so
    # the baseline runs in small chunks; slow is fine, OOM is not.
    k_deep = min(max(4 * k, k + 16), max(index.num_docs, 1))
    es, ei = [], []
    for i in range(0, len(qs), max(baseline_chunk, 1)):
        s, d = index.search(qs[i:i + baseline_chunk], k=k_deep,
                            p_cap=index.max_df, engine="exact",
                            exact_topk=True)
        es.append(s)
        ei.append(d)
    exact_s, exact_i = np.concatenate(es), np.concatenate(ei)

    if avg_query_terms is None:
        q_terms, _ = index.encode_queries(qs)
        avg_query_terms = float(np.mean((q_terms >= 0).sum(axis=1)))
    # q8r rescore rows: one int32 per stored (doc, term) entry, padded to
    # the longest doc — approximate Td by mean postings per doc
    td_est = max(1.0, index.num_postings / max(index.num_docs, 1))

    sweep: List[dict] = []
    for p_cap in p_caps:
        pc = min(p_cap, index.max_df)
        _, got = index.search(qs, k=k, p_cap=pc, engine="q8")
        r = _recall_at_k(exact_s, exact_i, got, k)
        sweep.append({"engine": "q8", "p_cap": pc, "candidates": 0,
                      "recall": r, "cost": avg_query_terms * pc})
        for cand in candidate_sizes:
            _, got = index.search(qs, k=k, p_cap=pc, engine="q8r",
                                  candidates=cand)
            r = _recall_at_k(exact_s, exact_i, got, k)
            sweep.append({"engine": "q8r", "p_cap": pc,
                          "candidates": cand, "recall": r,
                          "cost": avg_query_terms * pc + cand * td_est})

    feasible = [s for s in sweep if s["recall"] >= target_recall]
    if feasible:
        best = min(feasible, key=lambda s: s["cost"])
        meets = True
    else:
        best = max(sweep, key=lambda s: s["recall"])
        meets = False
    return TunedConfig(engine=best["engine"], p_cap=best["p_cap"],
                       candidates=best["candidates"], recall=best["recall"],
                       cost=best["cost"], meets_target=meets, sweep=sweep)


@dataclass
class TunedDenseConfig:
    engine: str                 # "int8" | "int8r" | "stream"
    rescore_pool: int           # 0 for int8/stream
    recall: float               # measured recall@k vs f32 exact
    cost: float                 # relative cost-model units
    meets_target: bool
    sweep: List[dict] = field(default_factory=list)


def autotune_dense(
    index,
    sample_query_embeddings: np.ndarray,
    k: int = 10,
    target_recall: float = 0.99,
    rescore_pools: Sequence[int] = (128, 256, 512, 1024),
    max_sample: int = 256,
    gather_cost: float = 32.0,
) -> TunedDenseConfig:
    """Dense-engine counterpart of autotune_sparse: sweep the int8 engine
    (K1) and the int8r pool-rescored engine against the exact "stream"
    baseline and return the cheapest config meeting `target_recall` at
    recall@`k`.

    `index` is a DenseIndex (retrievers/dense.py). Cost model (relative,
    orders configs only): the matmul streams N int8 bytes/dim for int8
    engines and N*dtype_bytes for the stream engine; the int8r pool
    rescore adds `pool * gather_cost` (row gathers move the same bytes
    as `pool` stream elements but at gather, not stream, efficiency).
    If nothing meets the target, the stream engine (exact=True) is
    returned as the escalation with meets_target still False only when
    even it misses (it cannot: it IS the baseline — so escalation is
    always feasible and the flag reports whether an int8 engine met it).
    """
    q = np.asarray(sample_query_embeddings, dtype=np.float32)[:max_sample]
    if q.size == 0:
        raise ValueError("need at least one sample query embedding")
    k_deep = min(max(4 * k, k + 16), max(index.num_docs, 1))
    exact_s, exact_i = index.search(q, k=k_deep, engine="stream", exact=True)

    n = max(index.num_docs, 1)
    sweep: List[dict] = []
    _, got = index.search(q, k=k, engine="int8")
    sweep.append({"engine": "int8", "rescore_pool": 0,
                  "recall": _recall_at_k(exact_s, exact_i, got, k),
                  "cost": float(n)})
    for pool in rescore_pools:
        if pool < k:
            continue
        _, got = index.search(q, k=k, engine="int8r", rescore_pool=pool)
        sweep.append({"engine": "int8r", "rescore_pool": pool,
                      "recall": _recall_at_k(exact_s, exact_i, got, k),
                      "cost": float(n) + pool * gather_cost})

    feasible = [s for s in sweep if s["recall"] >= target_recall]
    if feasible:
        best = min(feasible, key=lambda s: s["cost"])
        meets = True
    else:
        # escalation: the exact stream engine always meets the target
        # (it is the baseline); meets_target=False records that no int8
        # engine did, so serving pays full-precision bandwidth
        dtype_bytes = 4 if "32" in str(
            getattr(index, "embeddings", np.zeros(0, np.float32)).dtype) \
            else 2
        best = {"engine": "stream", "rescore_pool": 0, "recall": 1.0,
                "cost": float(n) * dtype_bytes}
        meets = False
        sweep.append(best)
    return TunedDenseConfig(
        engine=best["engine"], rescore_pool=best["rescore_pool"],
        recall=best["recall"], cost=best["cost"], meets_target=meets,
        sweep=sweep)
