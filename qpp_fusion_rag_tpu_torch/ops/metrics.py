"""IR metrics as batched reductions over aligned relevance tensors.

Counterpart of qpp_fusion_rag_tpu/ops/metrics.py. The alignment of sparse
qrels to a run is host numpy (align_relevance, copied); the metrics are
torch reductions on the device their inputs lie on:

    gains   : float32 [Q, K]   relevance gain of the doc at each rank
                               (0 for non-relevant / padding)
    n_rel   : int32   [Q]      number of relevant docs per query
    ideal   : float32 [Q, K']  each query's positive grades, descending,
                               padded with 0 (the IDCG's gains)

Formulas as trec_eval's (linear gain, 1 / log2(rank + 1) discount) for the
measure strings nDCG@k, RR@k, R@k, P@k and AP.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


# =============================================================================
# Host-side alignment
# =============================================================================

def align_relevance(
    doc_ids: np.ndarray,
    qid_list: Sequence[str],
    qrels: Dict[str, Dict[str, int]],
    vocab,
    ideal_k: int | None = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Align sparse qrels to a run.

    Args:
        doc_ids: int32 [Q, K] retrieved doc ids (PAD=-1).
        qid_list: Q query ids (row order of doc_ids).
        qrels: {qid: {docno: rel}}.
        vocab: DocVocab mapping docno <-> id.
        ideal_k: length of the ideal-gain vector (defaults to K).

    Returns:
        (gains [Q, K] f32, n_rel [Q] i32, ideal [Q, ideal_k] f32)
    """
    Q, K = doc_ids.shape
    ideal_k = ideal_k or K
    gains = np.zeros((Q, K), dtype=np.float32)
    n_rel = np.zeros((Q,), dtype=np.int32)
    ideal = np.zeros((Q, ideal_k), dtype=np.float32)

    # one gain table indexed by vocab id, set and reset per query
    rel_arr = np.zeros(len(vocab) + 1, dtype=np.float32)
    for qi, qid in enumerate(qid_list):
        rels = qrels.get(qid)
        if not rels:
            continue
        ids = np.asarray([vocab.id_of(d) for d in rels], dtype=np.int64)
        vals = np.asarray(list(rels.values()), dtype=np.float32)
        # n_rel counts every positively judged doc, retrieved or not
        # (recall's denominator); the gain table needs the in-vocab ones
        n_rel[qi] = int(np.sum(vals > 0))
        known = ids >= 0
        ids, vals = ids[known], vals[known]
        rel_arr[ids] = np.maximum(vals, 0.0)
        row = doc_ids[qi]
        gains[qi] = rel_arr[np.clip(row, 0, len(vocab))] * (row >= 0)
        rel_arr[ids] = 0.0
        pos = sorted((r for r in rels.values() if r > 0), reverse=True)[:ideal_k]
        ideal[qi, : len(pos)] = pos
    return gains, n_rel, ideal


# =============================================================================
# Metrics — all [Q, K] -> [Q], on the inputs' device
# =============================================================================

def _discounts(K: int, device=None) -> torch.Tensor:
    ranks = torch.arange(1, K + 1, dtype=torch.float32, device=device)
    return 1.0 / torch.log2(ranks + 1.0)


def ndcg_at(gains: torch.Tensor, ideal: torch.Tensor, k: int) -> torch.Tensor:
    """nDCG@k: DCG_k / IDCG_k, linear gain, log2(rank+1) discount. The IDCG
    sums min(k, ideal width) ideal gains whatever the run depth, as
    trec_eval does for a cutoff deeper than the run: size `ideal` to the
    deepest cutoff (align_relevance's ideal_k)."""
    K = gains.shape[-1]
    Ki = ideal.shape[-1]
    kk = min(k, K)
    ki = min(k, Ki)
    dcg = (gains[..., :kk] * _discounts(K, gains.device)[:kk]).sum(-1)
    idcg = (ideal[..., :ki] * _discounts(Ki, ideal.device)[:ki]).sum(-1)
    return torch.where(idcg > 0, dcg / torch.clamp(idcg, min=1e-30), 0.0)


def rr_at(gains: torch.Tensor, k: int) -> torch.Tensor:
    """RR@k: reciprocal rank of the first relevant doc within top-k, else 0."""
    K = gains.shape[-1]
    kk = min(k, K)
    rel = (gains[..., :kk] > 0).to(torch.int32)
    first = torch.argmax(rel, dim=-1)    # the first maximum; 0 if none (guarded)
    any_rel = rel.amax(dim=-1) > 0
    return torch.where(any_rel, 1.0 / (first.to(torch.float32) + 1.0), 0.0)


def recall_at(gains: torch.Tensor, n_rel: torch.Tensor, k: int) -> torch.Tensor:
    """R@k: |relevant in top-k| / n_rel."""
    K = gains.shape[-1]
    kk = min(k, K)
    hits = (gains[..., :kk] > 0).sum(-1).to(torch.float32)
    n = n_rel.to(torch.float32)
    return torch.where(n > 0, hits / torch.clamp(n, min=1.0), 0.0)


def precision_at(gains: torch.Tensor, k: int) -> torch.Tensor:
    """P@k: |relevant in top-k| / k (fixed denominator, trec_eval's)."""
    K = gains.shape[-1]
    kk = min(k, K)
    hits = (gains[..., :kk] > 0).sum(-1).to(torch.float32)
    return hits / float(k)


def average_precision(gains: torch.Tensor, n_rel: torch.Tensor) -> torch.Tensor:
    """AP over the full run depth: the sum of P@i at relevant ranks / n_rel."""
    rel = (gains > 0).to(torch.float32)
    cum_hits = torch.cumsum(rel, dim=-1)
    ranks = torch.arange(1, gains.shape[-1] + 1, dtype=torch.float32, device=gains.device)
    ap_sum = (cum_hits / ranks * rel).sum(-1)
    n = n_rel.to(torch.float32)
    return torch.where(n > 0, ap_sum / torch.clamp(n, min=1.0), 0.0)


# =============================================================================
# Metric-string dispatch ("nDCG@10", "RR@5", "AP", ...)
# =============================================================================

def parse_measure(name: str) -> Tuple[str, int | None]:
    if "@" in name:
        base, k = name.split("@", 1)
        return base, int(k)
    return name, None


def compute_measures(
    names: Sequence[str],
    gains,
    n_rel,
    ideal,
    device=None,
) -> Dict[str, torch.Tensor]:
    """Named measures -> {name: per-query [Q] tensor}. The inputs (numpy
    from align_relevance, or tensors) go to `device`: by default the
    device of `gains` when it is a tensor, else the card."""
    if device is None:
        device = gains.device if isinstance(gains, torch.Tensor) else "cuda"
    gains = torch.as_tensor(gains, device=device)
    n_rel = torch.as_tensor(n_rel, device=device)
    ideal = torch.as_tensor(ideal, device=device)
    out: Dict[str, torch.Tensor] = {}
    for name in names:
        base, k = parse_measure(name)
        b = base.lower()
        if b == "ndcg":
            out[name] = ndcg_at(gains, ideal, k or gains.shape[-1])
        elif b in ("rr", "mrr"):
            out[name] = rr_at(gains, k or gains.shape[-1])
        elif b in ("r", "recall"):
            if k is None:
                raise ValueError(f"{name}: recall needs a cutoff")
            out[name] = recall_at(gains, n_rel, k)
        elif b in ("p", "precision"):
            if k is None:
                raise ValueError(f"{name}: precision needs a cutoff")
            out[name] = precision_at(gains, k)
        elif b in ("ap", "map"):
            out[name] = average_precision(gains, n_rel)
        else:
            raise ValueError(f"Unknown measure {name!r}")
    return out


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def aggregate_measures(per_query: Dict[str, torch.Tensor], judged: np.ndarray) -> Dict[str, float]:
    """Mean over judged queries only (trec_eval averages over qrels queries);
    host numpy over the f32 values."""
    judged = np.asarray(judged, dtype=bool)
    denom = max(int(judged.sum()), 1)
    return {
        name: float(_host(vals)[judged].sum() / denom)
        for name, vals in per_query.items()
    }


def compute_ndcg(ranked_docs: List[str], qrels: Dict[str, int], k: int = 10) -> float:
    """nDCG@k of one ranked list of docnos against {docid: rel} (host numpy)."""
    kk = min(k, len(ranked_docs)) if ranked_docs else 0
    gains = np.zeros((1, max(kk, 1)), dtype=np.float32)
    for i, d in enumerate(ranked_docs[:kk]):
        r = qrels.get(d, 0)
        if r > 0:
            gains[0, i] = r
    pos = sorted((r for r in qrels.values() if r > 0), reverse=True)[:k]
    ideal = np.zeros((1, max(len(pos), 1)), dtype=np.float32)
    ideal[0, : len(pos)] = pos
    d_run = 1.0 / np.log2(np.arange(1, gains.shape[1] + 1) + 1.0)
    d_ideal = 1.0 / np.log2(np.arange(1, ideal.shape[1] + 1) + 1.0)
    dcg = float((gains[0] * d_run).sum())
    idcg = float((ideal[0] * d_ideal).sum())
    return dcg / idcg if idcg > 0 else 0.0
