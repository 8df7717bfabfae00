"""Fairness metrics + stochastic tie-breaking for evaluation.

Counterpart of qpp_fusion_rag_tpu/evaluation/fairness.py, copied (host
Python and numpy; the seeded tie breakers draw from the same numpy
generators).

Re-expresses the reference's qrels-package extras (reference
qrels/Metric.java AWRF entry + qrels/FairnessMetrics.java, and the
EvalMetricTieBreaker family — NoTieBreaker, NoisePerturbationTieBreaker
(±δ noise), PermAggrTieBreaker / SampledPermAggrTieBreaker (permutation
aggregation over tied blocks)).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np


# =============================================================================
# AWRF — attention-weighted rank fairness
# =============================================================================

def awrf(
    doc_groups: np.ndarray,     # [Q, K] int group id per retrieved doc (-1 pad)
    n_groups: int,
    target: Optional[np.ndarray] = None,   # [n_groups] target exposure dist
    k: Optional[int] = None,
) -> np.ndarray:
    """Per-query AWRF = 1 − ½·L1(exposure, target).

    Exposure of group g = Σ_{ranks r with group g} 1/log2(r+1), normalized
    per query; target defaults to uniform. 1.0 = exposure matches target.
    """
    doc_groups = np.asarray(doc_groups)
    Q, K = doc_groups.shape
    kk = min(k or K, K)
    if target is None:
        target = np.full(n_groups, 1.0 / n_groups)
    target = np.asarray(target, np.float64)
    target = target / max(target.sum(), 1e-12)

    disc = 1.0 / np.log2(np.arange(1, kk + 1) + 1.0)
    out = np.zeros(Q)
    for qi in range(Q):
        exp = np.zeros(n_groups)
        for r in range(kk):
            g = doc_groups[qi, r]
            if 0 <= g < n_groups:
                exp[g] += disc[r]
        s = exp.sum()
        if s <= 0:
            out[qi] = 0.0
            continue
        out[qi] = 1.0 - 0.5 * np.abs(exp / s - target).sum()
    return out


# =============================================================================
# Tie-breakers (stochastic re-evaluation of near-tied rankings)
# =============================================================================

class NoTieBreaker:
    """Identity: evaluate the ranking as-is."""

    def evaluate(self, metric_fn: Callable[[np.ndarray], float],
                 scores: np.ndarray) -> Dict[str, float]:
        v = metric_fn(np.argsort(-scores, kind="stable"))
        return {"mean": float(v), "std": 0.0}


class NoisePerturbationTieBreaker:
    """Re-evaluate under ±δ score noise; ties resolve differently per sample
    (reference NoisePerturbationTieBreaker semantics)."""

    def __init__(self, delta: float = 0.05, n_samples: int = 30, seed: int = 0):
        self.delta = delta
        self.n_samples = n_samples
        self.seed = seed

    def evaluate(self, metric_fn: Callable[[np.ndarray], float],
                 scores: np.ndarray) -> Dict[str, float]:
        rng = np.random.default_rng(self.seed)
        vals = []
        for _ in range(self.n_samples):
            noisy = scores + rng.uniform(-self.delta, self.delta, scores.shape)
            vals.append(metric_fn(np.argsort(-noisy, kind="stable")))
        return {"mean": float(np.mean(vals)), "std": float(np.std(vals))}


class SampledPermAggrTieBreaker:
    """Aggregate the metric over sampled permutations of exactly-tied score
    blocks (reference PermAggr/SampledPermAggrTieBreaker)."""

    def __init__(self, n_samples: int = 30, seed: int = 0):
        self.n_samples = n_samples
        self.seed = seed

    def evaluate(self, metric_fn: Callable[[np.ndarray], float],
                 scores: np.ndarray) -> Dict[str, float]:
        rng = np.random.default_rng(self.seed)
        order = np.argsort(-scores, kind="stable")
        sorted_scores = scores[order]
        # tied blocks in the sorted order
        blocks = []
        start = 0
        for i in range(1, len(scores) + 1):
            if i == len(scores) or sorted_scores[i] != sorted_scores[start]:
                if i - start > 1:
                    blocks.append((start, i))
                start = i
        if not blocks:
            return {"mean": float(metric_fn(order)), "std": 0.0}
        vals = []
        for _ in range(self.n_samples):
            perm = order.copy()
            for s, e in blocks:
                perm[s:e] = rng.permutation(perm[s:e])
            vals.append(metric_fn(perm))
        return {"mean": float(np.mean(vals)), "std": float(np.std(vals))}


class PreEvaluatedResults:
    """Per-query metrics loaded from a headered TSV/CSV — evaluate QPP
    against precomputed targets without an index or qrels in reach.

    Mirrors qrels/PreEvaluatedResults.java:13-37 (reference): the file's
    first line is a header; each row carries qid plus named metric
    columns (the reference hardcodes ndcg/awrf/combined; here any header
    column works). `compute(qid, metric)` returns -1 for unknown qids,
    like the reference.
    """

    def __init__(self, per_query_metrics_file, delimiter: str = None):
        import re

        self.per_query: dict = {}
        with open(per_query_metrics_file) as f:
            lines = [ln.strip() for ln in f if ln.strip()]
        if not lines:
            self.columns = []
            return
        split = (lambda s: s.split(delimiter)) if delimiter else (
            lambda s: re.split(r"[,\t ]+", s))
        header = split(lines[0])
        self.columns = [c.strip().lower() for c in header[1:]]
        for ln in lines[1:]:
            parts = split(ln)
            qid = parts[0]
            vals = {}
            for name, raw in zip(self.columns, parts[1:]):
                try:
                    vals[name] = float(raw)
                except ValueError:
                    continue
            self.per_query[qid] = vals

    def compute(self, qid: str, metric: str) -> float:
        row = self.per_query.get(str(qid))
        if row is None:
            return -1.0
        return row.get(metric.lower(), -1.0)

    def query_ids(self):
        return set(self.per_query.keys())
