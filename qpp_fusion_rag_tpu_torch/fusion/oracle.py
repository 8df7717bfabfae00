"""Oracle baseline: per-query best-ranker selection (the upper bound).

Counterpart of qpp_fusion_rag_tpu/fusion/oracle.py: the per-query
per-ranker metric (evaluation.ir_evaluator.per_query_metric on `device`),
the oracle run that takes each query's best ranker's list, the upper bound
and the selection histogram.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from qpp_fusion_rag_tpu_torch.data.runtensor import RunTensor
from qpp_fusion_rag_tpu_torch.evaluation.ir_evaluator import IREvaluator, per_query_metric


def oracle_selection(
    rt: RunTensor,
    qrels: Dict[str, Dict[str, int]],
    metric: str = "nDCG@10",
    device=None,
) -> Dict:
    """-> {selection [Q] int, per_query [R, Q], histogram, oracle_metric,
    per_retriever_metric}."""
    quality = per_query_metric(rt, qrels, metric=metric, device=device)   # [R, Q]
    selection = np.argmax(quality, axis=0)                                # [Q]
    judged = np.array([q in qrels for q in rt.qids])

    hist = {
        rt.retrievers[r]: int(np.sum(selection[judged] == r))
        for r in range(rt.R)
    }
    oracle_vals = quality[selection, np.arange(rt.Q)]
    denom = max(int(judged.sum()), 1)
    return {
        "selection": selection,
        "per_query": quality,
        "histogram": hist,
        "oracle_metric": float(oracle_vals[judged].sum() / denom),
        "per_retriever_metric": {
            rt.retrievers[r]: float(quality[r][judged].sum() / denom)
            for r in range(rt.R)
        },
        "metric": metric,
    }


def oracle_run(rt: RunTensor, selection: np.ndarray, name: str = "oracle") -> RunTensor:
    """The oracle RunTensor: query qi takes retriever selection[qi]'s list."""
    doc_ids = rt.doc_ids[selection, np.arange(rt.Q)][None]   # [1, Q, K]
    scores = rt.scores[selection, np.arange(rt.Q)][None]
    return RunTensor(doc_ids, scores, rt.qids, [name], rt.vocab)


def oracle_report(
    rt: RunTensor,
    qrels: Dict[str, Dict[str, int]],
    metric: str = "nDCG@10",
    extra_metrics: Optional[Sequence[str]] = None,
    device=None,
) -> Dict:
    """Stage 10: upper bound, histogram and the oracle run's evaluation."""
    sel = oracle_selection(rt, qrels, metric=metric, device=device)
    orun = oracle_run(rt, sel["selection"])
    metrics = list(extra_metrics or [metric, "RR@10", "R@100"])
    ev = IREvaluator(metrics, device=device)
    oracle_eval = ev.evaluate(orun, qrels)
    best_single = max(sel["per_retriever_metric"].values())
    return {
        "metric": metric,
        "oracle": oracle_eval,
        "oracle_metric": sel["oracle_metric"],
        "per_retriever": sel["per_retriever_metric"],
        "best_single": best_single,
        "headroom": sel["oracle_metric"] - best_single,
        "selection_histogram": sel["histogram"],
        "selection": sel["selection"],
    }
