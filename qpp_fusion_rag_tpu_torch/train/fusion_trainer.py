"""Learned-fusion training: QPP features -> per-retriever quality soft
targets (stage 04).

Counterpart of qpp_fusion_rag_tpu/train/fusion_trainer.py:
  * X = the flattened QPP feature matrix per query (13 x R),
  * Y = per-query per-retriever nDCG@10 row-normalized to sum 1, one
    metric pass per retriever on `device`,
  * a sequential train / test split, the validation cut taken from the
    end of the train slice,
  * per_retriever / multioutput GBDT and MLP, built with `device`,
  * uniform vs learned vs oracle fused nDCG@10 on the test slice.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from qpp_fusion_rag_tpu_torch.config import config
from qpp_fusion_rag_tpu_torch.data.runtensor import RunTensor
from qpp_fusion_rag_tpu_torch.evaluation.ir_evaluator import IREvaluator, per_query_metric
from qpp_fusion_rag_tpu_torch.fusion.engine import combsum
from qpp_fusion_rag_tpu_torch.models import (
    BaseFusionModel,
    build_features,
    compute_targets,
    get_model_class,
)


def build_training_data(
    rt: RunTensor,
    qpp_data: Dict[str, Dict[str, List[float]]],
    qrels: Dict[str, Dict[str, int]],
    target_metric: str = "nDCG@10",
    device=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, List[str]]:
    """-> (X [Q, 13R], Y [Q, R] soft targets, quality [R, Q], qids), over
    the queries present in both qrels and qpp_data."""
    keep = [q for q in rt.qids if q in qrels and q in qpp_data]
    rt_k = rt.select_queries(keep)
    quality = per_query_metric(rt_k, qrels, metric=target_metric, device=device)   # [R, Q]
    X, _ = build_features(qpp_data, rt_k.retrievers, qids=keep)
    Y = compute_targets(quality)
    return X, Y, quality, keep


def evaluate_weights(
    rt: RunTensor,
    qids: Sequence[str],
    weights: np.ndarray,     # [Q, R]
    qrels: Dict[str, Dict[str, int]],
    metric: str = "nDCG@10",
    device=None,
) -> float:
    """Fused quality under given per-query weights (weighted CombSUM)."""
    rt_sel = rt.select_queries(list(qids))
    fused = combsum(rt_sel, weights=np.asarray(weights, np.float32).T, device=device)
    ev = IREvaluator([metric], device=device)
    return ev.evaluate(fused, qrels)[metric]


def train_fusion_models(
    rt: RunTensor,
    qpp_data: Dict[str, Dict[str, List[float]]],
    qrels: Dict[str, Dict[str, int]],
    model_types: Sequence[str] = ("per_retriever", "multioutput", "mlp"),
    train_ratio: Optional[float] = None,
    target_metric: str = "nDCG@10",
    output_dir: Optional[Path] = None,
    seed: int = 0,
    device=None,
) -> Dict[str, Dict]:
    """Full stage-04 run on `device` (None: the card). Returns {model_type:
    {model, train_info, fused_<metric>, path}} plus the uniform / oracle
    baselines under "_baselines"; each model is saved to
    <output_dir>/fusion_<type>.pkl when output_dir is given."""
    train_ratio = train_ratio if train_ratio is not None else config.training.train_ratio
    X, Y, quality, qids = build_training_data(rt, qpp_data, qrels, target_metric, device)
    n = len(qids)
    n_train = int(n * train_ratio)          # sequential split
    te = slice(n_train, n)
    test_qids = qids[n_train:]

    R = rt.R
    uniform_w = np.full((len(test_qids), R), 1.0 / R, dtype=np.float32)
    oracle_w = compute_targets(quality[:, n_train:])
    baselines = {
        "uniform": evaluate_weights(rt, test_qids, uniform_w, qrels, target_metric, device),
        "oracle": evaluate_weights(rt, test_qids, oracle_w, qrels, target_metric, device),
        "n_train": n_train,
        "n_test": len(test_qids),
    }

    # early stopping validates on the last 20 % of the TRAIN slice: the
    # test slice is never seen before the final evaluation
    if n_train < 1:
        raise ValueError(
            f"{n} queries with train_ratio={train_ratio} leaves no "
            "training queries; lower the ratio or add queries")
    n_val = max(int(n_train * 0.2), 1) if n_train >= 5 else 0
    fit = slice(0, n_train - n_val)
    # with no validation carve-out (tiny n) pass no validation rather than
    # the fit slice again
    va = slice(n_train - n_val, n_train) if n_val else None

    results: Dict[str, Dict] = {"_baselines": baselines}
    for mtype in model_types:
        cls = get_model_class(mtype)
        model: BaseFusionModel = cls(rt.retrievers, seed=seed, device=device)
        train_info = model.train(
            X[fit], Y[fit],
            X[va] if va else None, Y[va] if va else None)
        W = model.predict(X[te])
        fused_metric = evaluate_weights(rt, test_qids, W, qrels, target_metric, device)
        results[mtype] = {
            "model": model,
            "train_info": train_info,
            f"fused_{target_metric}": fused_metric,
        }
        if output_dir is not None:
            path = Path(output_dir) / f"fusion_{mtype}.pkl"
            model.save(path)
            results[mtype]["path"] = str(path)
    return results
