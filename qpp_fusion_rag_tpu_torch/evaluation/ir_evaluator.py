"""Host-side IR evaluation API over the metric reductions.

Counterpart of qpp_fusion_rag_tpu/evaluation/ir_evaluator.py: evaluate
one run or many against qrels, per query or aggregated. The alignment is
host numpy; the metrics (ops/metrics.py) run on the evaluator's `device`,
by default the card.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from qpp_fusion_rag_tpu_torch.config import config
from qpp_fusion_rag_tpu_torch.data.runtensor import RunTensor
from qpp_fusion_rag_tpu_torch.data.vocab import DocVocab
from qpp_fusion_rag_tpu_torch.ops import metrics as M

RunDict = Dict[str, List[Tuple[str, float]]]


def _run_dict_to_tensor(run: RunDict, vocab: Optional[DocVocab] = None) -> Tuple[np.ndarray, List[str], DocVocab]:
    """{qid: [(docid, score)]} -> rank-ordered doc_ids [Q, K], qids in
    plain lexicographic order (as JAX sorts them here, not qid_sort_key)."""
    vocab = vocab or DocVocab()
    qids = sorted(run.keys())
    K = max((len(v) for v in run.values()), default=1)
    doc_ids = np.full((len(qids), K), -1, dtype=np.int32)
    for qi, qid in enumerate(qids):
        entries = sorted(run[qid], key=lambda x: -x[1])
        for ki, (docid, _s) in enumerate(entries[:K]):
            doc_ids[qi, ki] = vocab.add(docid)
    return doc_ids, qids, vocab


class IREvaluator:
    """Evaluate runs against qrels with the configured metric set, the
    metrics on `device` (None: the card)."""

    def __init__(self, metrics: Optional[Sequence[str]] = None, device=None):
        self.metric_names = list(metrics or config.evaluation.ir_metrics)
        self.device = device
        for m in self.metric_names:
            M.parse_measure(m)  # validate eagerly

    # ------------------------------------------------------------------
    def evaluate(
        self,
        run: Union[RunDict, RunTensor],
        qrels: Dict[str, Dict[str, int]],
        per_query: bool = False,
        retriever: Union[int, str] = 0,
    ) -> Dict:
        """Evaluate a single run.

        Args:
            run: {qid: [(docid, score)]} or a RunTensor (one retriever row,
                 selected via `retriever`).
            qrels: {qid: {docid: rel}}.
            per_query: if True return {metric: {qid: value}}.
        """
        if isinstance(run, RunTensor):
            r = retriever if isinstance(retriever, int) else run.retrievers.index(retriever)
            doc_ids, qids, vocab = run.doc_ids[r], run.qids, run.vocab
        else:
            doc_ids, qids, vocab = _run_dict_to_tensor(run)

        gains, n_rel, ideal = M.align_relevance(
            doc_ids, qids, qrels, vocab,
            ideal_k=_ideal_depth(self.metric_names, doc_ids.shape[1]))
        per_q = M.compute_measures(self.metric_names, gains, n_rel, ideal, device=self.device)
        per_q = {name: vals.cpu().numpy() for name, vals in per_q.items()}
        judged = np.array([q in qrels for q in qids])

        if per_query:
            return {
                name: {qid: float(v) for qid, v, j in zip(qids, vals, judged) if j}
                for name, vals in per_q.items()
            }
        return M.aggregate_measures(per_q, judged)

    # ------------------------------------------------------------------
    def evaluate_multiple(
        self,
        runs: Dict[str, Union[RunDict, RunTensor]],
        qrels: Dict[str, Dict[str, int]],
    ):
        """Evaluate several runs -> pandas DataFrame (rows=runs, cols=metrics)."""
        import pandas as pd

        rows = {name: self.evaluate(run, qrels) for name, run in runs.items()}
        return pd.DataFrame.from_dict(rows, orient="index")[self.metric_names]

    # ------------------------------------------------------------------
    def evaluate_runtensor(
        self,
        rt: RunTensor,
        qrels: Dict[str, Dict[str, int]],
    ) -> Dict[str, Dict[str, float]]:
        """Evaluate every retriever row of a RunTensor -> {retriever: {metric: v}}."""
        return {name: self.evaluate(rt, qrels, retriever=name) for name in rt.retrievers}


def _ideal_depth(metric_names, run_depth: int) -> int:
    """Ideal-gain vector width: the deepest @cutoff among the metrics, or
    the run depth if larger (a truncated run evaluated at a deeper cutoff
    still needs min(k, n_rel) ideal gains, ops.metrics.ndcg_at)."""
    depth = run_depth
    for name in metric_names:
        if "@" in name:
            try:
                depth = max(depth, int(name.split("@", 1)[1]))
            except ValueError:
                pass
    return depth


def per_query_metric(
    rt: RunTensor,
    qrels: Dict[str, Dict[str, int]],
    metric: str = "nDCG@10",
    device=None,
) -> np.ndarray:
    """Per-(retriever, query) metric matrix [R, Q] (host f32), each
    retriever's row computed on `device` (None: the card)."""
    out = np.zeros((rt.R, rt.Q), dtype=np.float32)
    for r in range(rt.R):
        gains, n_rel, ideal = M.align_relevance(
            rt.doc_ids[r], rt.qids, qrels, rt.vocab,
            ideal_k=_ideal_depth([metric], rt.K))
        out[r] = M.compute_measures([metric], gains, n_rel, ideal, device=device)[metric].cpu().numpy()
    return out


compute_ndcg = M.compute_ndcg
