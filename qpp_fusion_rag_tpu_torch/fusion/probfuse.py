"""ProbFuse: segment-probability fusion (Lillis et al. 2006).

Counterpart of qpp_fusion_rag_tpu/fusion/probfuse.py: each ranker's top-L
splits into x segments; a training split gives P(rel | segment, ranker)
over judged docs ("judged") or over all docs ("all"); a test run's doc
scores the sum over rankers of its segment's probability over the
segment's 1-based number. The tables are host numpy; the fusion is
ops/fusion.py:fuse on `device` (None: the card).
"""

from __future__ import annotations

from typing import Dict, Literal, Sequence

import numpy as np

from qpp_fusion_rag_tpu_torch.data.runtensor import RunTensor
from qpp_fusion_rag_tpu_torch.ops.metrics import align_relevance


def _segment_index(K: int, x: int) -> np.ndarray:
    """rank position (0-based) -> segment id 0..x-1: the reference's
    ceil(pos*x/L) on 1-based positions, seg = ceil((i+1)*x/K) - 1 (the
    floor formula's segments differ at the boundaries when K % x != 0)."""
    seg = -(-(np.arange(K) + 1) * x // K) - 1
    return np.minimum(np.maximum(seg, 0), x - 1)


class ProbFuse:
    def __init__(self, x: int = 25, depth: int = 100,
                 variant: Literal["judged", "all"] = "judged"):
        self.x = x
        self.depth = depth
        self.variant = variant
        self.probs: Dict[str, np.ndarray] = {}   # ranker -> [x] P(rel | seg)

    # -- training ------------------------------------------------------
    def train(self, rt: RunTensor, qrels: Dict[str, Dict[str, int]]) -> Dict[str, np.ndarray]:
        """Estimate per-ranker segment probabilities on the given queries."""
        K = min(self.depth, rt.K)
        seg = _segment_index(K, self.x)                     # [K]
        judged_q = np.array([q in qrels for q in rt.qids])
        # a retrieved doc is judged when qrels hold any grade for it; docs
        # absent from the vocab (id -1, the pad sentinel too) are dropped,
        # or every pad slot would count as judged
        judged_ids = {
            qi: {rt.vocab.id_of(d) for d in qrels[q]} - {-1}
            for qi, q in enumerate(rt.qids) if q in qrels
        }
        for r, name in enumerate(rt.retrievers):
            gains, _n_rel, _ideal = align_relevance(
                rt.doc_ids[r][:, :K], rt.qids, qrels, rt.vocab
            )
            rel = gains[judged_q] > 0                        # [Qj, K]
            doc_ids = rt.doc_ids[r][judged_q, :K]
            valid = doc_ids >= 0
            judged_mask = np.zeros_like(valid)
            for row, qi in enumerate(np.flatnonzero(judged_q)):
                ids = judged_ids.get(int(qi), set())
                judged_mask[row] = np.isin(doc_ids[row], list(ids))
            judged_mask &= valid
            p = np.zeros(self.x, dtype=np.float64)
            for s in range(self.x):
                cols = seg == s
                if self.variant == "judged":
                    denom = judged_mask[:, cols].sum()
                else:
                    denom = valid[:, cols].sum()
                num = rel[:, cols].sum()
                p[s] = num / denom if denom > 0 else 0.0
            self.probs[name] = p
        return self.probs

    # -- fusion --------------------------------------------------------
    def fuse(self, rt: RunTensor, k_out: int = 100, name: str = "probfuse",
             device=None) -> RunTensor:
        """Fused score(d) = sum_r P_r(rel | segment of d in r's list) / k,
        k the 1-based segment number (the Lillis et al. rank discount)."""
        if not self.probs:
            raise RuntimeError("ProbFuse.train() first")
        from qpp_fusion_rag_tpu_torch.ops import fusion as F

        K = min(self.depth, rt.K)
        seg = _segment_index(K, self.x)
        # the per-(retriever, rank) contribution P(rel | seg) / (seg+1) is
        # constant over queries: it is the "scores" tensor, fused with
        # uniform weights and no min-max
        contrib = np.zeros((rt.R, rt.Q, K), dtype=np.float32)
        discount = (seg + 1).astype(np.float64)
        for r, rname in enumerate(rt.retrievers):
            contrib[r, :, :] = (self.probs[rname][seg] / discount)[None, :]
        valid = rt.doc_ids[:, :, :K] >= 0
        contrib = np.where(valid, contrib, -np.inf).astype(np.float32)

        ids, scores = F.fuse(
            rt.doc_ids[:, :, :K], contrib,
            weights=np.ones((rt.R, rt.Q), np.float32),
            method="combsum", minmax_norm=False,
            k_out=min(k_out, rt.R * K), device=device,
        )
        return RunTensor(
            ids.cpu().numpy()[None], scores.cpu().numpy()[None],
            rt.qids, [name], rt.vocab,
        )


def probfuse_experiment(
    rt: RunTensor,
    qrels: Dict[str, Dict[str, int]],
    train_qids: Sequence[str],
    test_qids: Sequence[str],
    x: int = 25,
    depth: int = 100,
    variant: str = "judged",
    metric: str = "nDCG@10",
    device=None,
) -> Dict:
    """Train on train_qids, fuse and evaluate on test_qids, on `device`."""
    from qpp_fusion_rag_tpu_torch.evaluation.ir_evaluator import IREvaluator

    pf = ProbFuse(x=x, depth=depth, variant=variant)  # type: ignore[arg-type]
    pf.train(rt.select_queries(list(train_qids)), qrels)
    fused = pf.fuse(rt.select_queries(list(test_qids)), device=device)
    ev = IREvaluator([metric], device=device)
    return {
        "probs": {k: v.tolist() for k, v in pf.probs.items()},
        metric: ev.evaluate(fused, qrels)[metric],
        "fused": fused,
    }
