"""Fusion engine: host API and method dispatcher over the fusion kernel.

Counterpart of qpp_fusion_rag_tpu/fusion/engine.py: JAX's method names,
QPP weight resolution (kernel column order, fusion mode -1) and TREC
output tags, with the aggregation in ops/fusion.py:fuse on the caller's
`device` (None: the card). The weighted methods take `device` through
their **kw, as they pass it on to the unweighted ones. Fused runs come
back as host RunTensors.
"""

from __future__ import annotations

from dataclasses import replace
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from qpp_fusion_rag_tpu_torch.config import config
from qpp_fusion_rag_tpu_torch.data.loaders import load_qpp_scores, write_run_file
from qpp_fusion_rag_tpu_torch.data.runtensor import RunTensor
from qpp_fusion_rag_tpu_torch.ops import fusion as F

QppData = Dict[str, Dict[str, List[float]]]


# =============================================================================
# QPP weights
# =============================================================================

def get_qpp_weight(
    qid: str,
    ranker: str,
    qpp_data: QppData,
    qpp_index: Optional[int] = None,
    fusion_mode: bool = False,
) -> float:
    """Single (query, ranker) weight with the reference's strict error
    surface: KeyError for a missing query or ranker, IndexError for a
    column out of range; fusion mode (or index -1) averages the columns."""
    if qpp_index is None:
        qpp_index = config.qpp.default_index
    if qid not in qpp_data:
        raise KeyError(f"QPP data missing for query '{qid}'. Run QPP computation first.")
    if ranker not in qpp_data[qid]:
        raise KeyError(
            f"QPP data missing for ranker '{ranker}' on query '{qid}'. "
            f"Available: {list(qpp_data[qid].keys())}"
        )
    scores = qpp_data[qid][ranker]
    if fusion_mode or qpp_index == -1:
        return float(sum(scores) / len(scores))
    if qpp_index >= len(scores):
        raise IndexError(f"QPP index {qpp_index} out of range. Available: 0-{len(scores) - 1}")
    return float(scores[qpp_index])


def weights_from_qpp(
    qpp_data: QppData,
    qids: Sequence[str],
    retrievers: Sequence[str],
    qpp_index: Optional[int] = None,
) -> np.ndarray:
    """The [R, Q] weight matrix of the fusion kernel (host f32)."""
    fusion_mode = qpp_index == -1
    W = np.zeros((len(retrievers), len(qids)), dtype=np.float32)
    for r, ranker in enumerate(retrievers):
        for qi, qid in enumerate(qids):
            W[r, qi] = get_qpp_weight(qid, ranker, qpp_data, qpp_index, fusion_mode)
    # min-max normalization maps a constant QPP column to 0 for every
    # query, and an all-zero weight column would rank by tie-break alone:
    # such a query's column becomes uniform ("no information in the
    # predictor" is unweighted fusion)
    dead = W.sum(axis=0) <= 1e-12
    if dead.any():
        W[:, dead] = 1.0 / max(len(retrievers), 1)
    return W


# =============================================================================
# Fusion entry points (one per reference method name)
# =============================================================================

def _fused_to_runtensor(rt: RunTensor, fused_ids, fused_scores, name: str) -> RunTensor:
    return RunTensor(
        doc_ids=fused_ids.cpu().numpy()[None],
        scores=fused_scores.cpu().numpy()[None],
        qids=rt.qids,
        retrievers=[name],
        vocab=rt.vocab,
    )


def _k_out(rt: RunTensor, k_out: Optional[int]) -> int:
    """Output depth: an explicit k_out is honored up to the R*K candidate
    bound; config.tpu.fusion.max_candidates caps only the default depth."""
    if k_out:
        return min(k_out, rt.R * rt.K)
    return min(rt.R * rt.K, int(config.tpu.fusion.max_candidates))


def combsum(rt: RunTensor, weights=None, k_out: Optional[int] = None, name: str = "combsum",
            device=None) -> RunTensor:
    ids, sc = F.fuse(rt.doc_ids, rt.scores, weights, method="combsum", k_out=_k_out(rt, k_out),
                     device=device)
    return _fused_to_runtensor(rt, ids, sc, name)


def combmnz(rt: RunTensor, weights=None, k_out: Optional[int] = None, name: str = "combmnz",
            device=None) -> RunTensor:
    ids, sc = F.fuse(rt.doc_ids, rt.scores, weights, method="combmnz", k_out=_k_out(rt, k_out),
                     device=device)
    return _fused_to_runtensor(rt, ids, sc, name)


def rrf(rt: RunTensor, weights=None, k: Optional[int] = None, k_out: Optional[int] = None,
        name: str = "rrf", device=None) -> RunTensor:
    k = k if k is not None else config.fusion.rrf_k
    ids, sc = F.fuse(rt.doc_ids, rt.scores, weights, method="rrf", rrf_k=k,
                     k_out=_k_out(rt, k_out), device=device)
    return _fused_to_runtensor(rt, ids, sc, name)


def weighted_combsum(rt: RunTensor, qpp_data: QppData, qpp_index: Optional[int] = None, **kw) -> RunTensor:
    qpp_index = qpp_index if qpp_index is not None else config.qpp.default_index
    W = weights_from_qpp(qpp_data, rt.qids, rt.retrievers, qpp_index)
    return combsum(rt, weights=W, name=kw.pop("name", "wcombsum"), **kw)


def weighted_combmnz(rt: RunTensor, qpp_data: QppData, qpp_index: Optional[int] = None, **kw) -> RunTensor:
    qpp_index = qpp_index if qpp_index is not None else config.qpp.default_index
    W = weights_from_qpp(qpp_data, rt.qids, rt.retrievers, qpp_index)
    return combmnz(rt, weights=W, name=kw.pop("name", "wcombmnz"), **kw)


def weighted_rrf(rt: RunTensor, qpp_data: QppData, qpp_index: Optional[int] = None, k: Optional[int] = None, **kw) -> RunTensor:
    qpp_index = qpp_index if qpp_index is not None else config.qpp.default_index
    W = weights_from_qpp(qpp_data, rt.qids, rt.retrievers, qpp_index)
    return rrf(rt, weights=W, k=k, name=kw.pop("name", "wrrf"), **kw)


def learned_fusion(
    rt: RunTensor,
    qpp_data: QppData,
    model,
    retrievers: Optional[List[str]] = None,
    k_out: Optional[int] = None,
    device=None,
) -> RunTensor:
    """Weighted CombSUM with per-query weights predicted from QPP features.
    `model` is any object with .predict(X [Q, n_qpp*R]) -> [Q, R] (a fusion
    model predicts on its own device); queries missing from qpp_data get
    uniform weights."""
    from qpp_fusion_rag_tpu_torch.models.base import build_features

    retrievers = retrievers or rt.retrievers
    rt_sel = rt.select_retrievers(retrievers) if retrievers != rt.retrievers else rt
    X, _ = build_features(qpp_data, retrievers, qids=rt_sel.qids)
    pred = np.asarray(model.predict(X), dtype=np.float32)  # [Q, R]
    missing = np.array([q not in qpp_data for q in rt_sel.qids])
    if missing.any():
        pred[missing] = 1.0 / len(retrievers)
    return combsum(rt_sel, weights=pred.T, k_out=k_out, name="learned", device=device)


# =============================================================================
# Dispatcher
# =============================================================================

def run_fusion(
    method: str,
    runs: Union[str, RunTensor],
    qpp: Union[None, str, QppData] = None,
    qpp_model: Optional[str] = None,
    model=None,
    model_path: Optional[str] = None,
    output_path: Optional[str] = None,
    rrf_k: Optional[int] = None,
    k_out: Optional[int] = None,
    qpp_layout: str = "kernel",
    device=None,
) -> RunTensor:
    """Run one fusion method end-to-end on `device` (None: the card).

    Args:
        method: combsum | combmnz | rrf | wcombsum | wcombmnz | wrrf | learned
        runs: runs directory (``*.norm.res``) or a RunTensor
        qpp: qpp directory or preloaded {qid: {retriever: [scores]}}
        qpp_model: QPP model name for weighting (kernel column order)
        qpp_layout: "kernel" for this framework's .qpp files (default),
            "reference" when weighting by reference-produced .qpp files
        model / model_path: learned-fusion weight model
    """
    qpp_model = qpp_model or config.qpp.default_method
    rrf_k = rrf_k if rrf_k is not None else config.fusion.rrf_k

    rt = runs if isinstance(runs, RunTensor) else RunTensor.from_trec_dir(runs, use_normalized=True)
    qpp_data = load_qpp_scores(qpp) if isinstance(qpp, (str, Path)) else qpp

    method_l = method.lower().replace("w-", "w")
    needs_qpp = method_l in ("wcombsum", "wcombmnz", "wrrf", "learned")
    if needs_qpp and qpp_data is None:
        raise ValueError(f"qpp data required for method {method!r}")

    def _idx(name):
        return config.get_qpp_index(name, layout=qpp_layout)

    kw = dict(k_out=k_out, device=device)
    if method_l == "combsum":
        fused, tag = combsum(rt, **kw), "combsum"
    elif method_l == "combmnz":
        fused, tag = combmnz(rt, **kw), "combmnz"
    elif method_l == "rrf":
        fused, tag = rrf(rt, k=rrf_k, **kw), f"rrf-k{rrf_k}"
    elif method_l == "wcombsum":
        idx = _idx(qpp_model)
        fused, tag = weighted_combsum(rt, qpp_data, idx, **kw), f"wcombsum-{qpp_model.lower()}"
    elif method_l == "wcombmnz":
        idx = _idx(qpp_model)
        fused, tag = weighted_combmnz(rt, qpp_data, idx, **kw), f"wcombmnz-{qpp_model.lower()}"
    elif method_l == "wrrf":
        idx = _idx(qpp_model)
        fused, tag = weighted_rrf(rt, qpp_data, idx, k=rrf_k, **kw), f"wrrf-{qpp_model.lower()}"
    elif method_l == "learned":
        if model is None:
            if not model_path:
                raise ValueError("--model_path required for learned fusion")
            from qpp_fusion_rag_tpu_torch.models.base import load_model
            model = load_model(model_path)
        fused, tag = learned_fusion(rt, qpp_data, model, **kw), "learned"
    else:
        raise ValueError(f"Unknown method {method!r}. Valid: {list(config.fusion.methods)}")

    fused = replace(fused, retrievers=[tag])
    if output_path:
        write_run_file(fused.to_run_dict(0), output_path, tag=tag)
    return fused
