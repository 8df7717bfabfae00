"""Adaptive retriever selection by argmax QPP (per-query winner-takes-all).

Counterpart of qpp_fusion_rag_tpu/fusion/argmax_qpp.py: for each QPP
column, each query takes the full list of the ranker with the highest
score in that column; every column is evaluated to find the signal that
selects best. Columns are named in the kernel's layout (config
qpp.methods).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from qpp_fusion_rag_tpu_torch.config import config
from qpp_fusion_rag_tpu_torch.data.runtensor import RunTensor
from qpp_fusion_rag_tpu_torch.evaluation.ir_evaluator import IREvaluator
from qpp_fusion_rag_tpu_torch.fusion.engine import QppData, weights_from_qpp
from qpp_fusion_rag_tpu_torch.fusion.oracle import oracle_run


def qpp_index_names() -> Dict[int, str]:
    """index -> QPP method name in the kernel's column order."""
    return {i: str(m) for i, m in enumerate(config.qpp.methods)}


def argmax_qpp_run(
    rt: RunTensor,
    qpp_data: QppData,
    qpp_index: int,
    name: Optional[str] = None,
) -> RunTensor:
    """Per query, take the list of the ranker with max QPP[qpp_index]."""
    W = weights_from_qpp(qpp_data, rt.qids, rt.retrievers, qpp_index)  # [R, Q]
    selection = np.argmax(W, axis=0)
    return oracle_run(rt, selection, name=name or f"argmax_qpp_{qpp_index}")


def argmax_qpp_experiment(
    rt: RunTensor,
    qpp_data: QppData,
    qrels: Dict[str, Dict[str, int]],
    qpp_indices: Optional[Sequence[int]] = None,
    metric: str = "nDCG@10",
    device=None,
) -> Dict[str, Dict]:
    """Evaluate argmax selection for every QPP column on `device`
    -> {qpp_name: {metric, histogram, qpp_index}}."""
    names = qpp_index_names()
    qpp_indices = list(qpp_indices) if qpp_indices is not None else sorted(names)
    ev = IREvaluator([metric], device=device)
    out: Dict[str, Dict] = {}
    for idx in qpp_indices:
        W = weights_from_qpp(qpp_data, rt.qids, rt.retrievers, idx)
        selection = np.argmax(W, axis=0)
        run = oracle_run(rt, selection, name=f"argmax_{idx}")
        hist = {
            rt.retrievers[r]: int(np.sum(selection == r)) for r in range(rt.R)
        }
        out[names.get(idx, str(idx))] = {
            metric: ev.evaluate(run, qrels)[metric],
            "histogram": hist,
            "qpp_index": idx,
        }
    return out
