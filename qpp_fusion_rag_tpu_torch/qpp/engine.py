"""QPP engine host API: run files / RunTensors in, .qpp artifacts out.

Counterpart of qpp_fusion_rag_tpu/qpp/engine.py. Scores go straight to
the 13-statistic reduction (ops/qpp.py) on the caller's `device` (None:
the card); results come back to the host. Files keep the
``<R>.res.mmnorm.qpp`` naming, the qid_sort_key order and the 6-decimal
format, so artifacts interoperate with the JAX package's.
"""

from __future__ import annotations

import os
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from qpp_fusion_rag_tpu_torch.config import config
from qpp_fusion_rag_tpu_torch.data.loaders import qid_sort_key, write_qpp_file
from qpp_fusion_rag_tpu_torch.data.runtensor import RunTensor
from qpp_fusion_rag_tpu_torch.ops import qpp as Q


def _device(device) -> torch.device:
    return torch.device("cuda" if device is None else device)


def compute_qpp(
    scores_by_qid: Dict[str, List[float]],
    query_texts: Optional[Dict[str, str]] = None,
    top_k: Optional[int] = None,
    normalize: Optional[str] = None,
    cutoff: Optional[int] = None,
    index=None,
    device=None,
) -> Dict[str, List[float]]:
    """The 13 statistics of {qid: [scores]} -> {qid: [13 floats]}.

    Scores are sorted desc and truncated to ``top_k`` before the kernel's
    own min(cutoff, n) cutoff; a query without text is featurized by its qid
    string, as in JAX. ``index`` (JAX's index-aware columns) is not ported
    yet and raises NotImplementedError.
    """
    top_k = top_k or config.processing.retrieval.top_k
    normalize = normalize if normalize is not None else config.qpp.normalization
    cutoff = cutoff or config.qpp.cutoff_k
    query_texts = query_texts or {}
    if index is not None:
        raise NotImplementedError(
            "compute_qpp(index=...) appends the index-aware QPP columns of "
            "qpp/index_aware.py, which the port has not ported yet (ROADMAP "
            "Queue 1 item 5)")

    qids = sorted(scores_by_qid.keys(), key=qid_sort_key)
    rows = [sorted(scores_by_qid[q], reverse=True)[:top_k] for q in qids]
    K = max([len(r) for r in rows] + [1])  # >=1 even when all lists are empty
    mat = np.zeros((len(qids), K), dtype=np.float32)
    n_valid = np.zeros((len(qids),), dtype=np.int32)
    for i, r in enumerate(rows):
        mat[i, : len(r)] = r
        n_valid[i] = len(r)

    dev = _device(device)
    feats = Q.text_features_batch([query_texts.get(q, q) for q in qids])
    raw = Q.qpp_kernel(torch.from_numpy(mat).to(dev), torch.from_numpy(n_valid).to(dev),
                       torch.from_numpy(feats).to(dev), cutoff=cutoff)
    if normalize and normalize != "none" and len(qids) > 0:
        raw = Q.normalize_qpp(raw, method=normalize)
    raw = raw.cpu().numpy()
    return {qid: raw[i].tolist() for i, qid in enumerate(qids)}


def compute_qpp_for_res_file(
    res_path: os.PathLike,
    output_path: Optional[os.PathLike] = None,
    top_k: Optional[int] = None,
    normalize: Optional[str] = None,
    queries_path: Optional[os.PathLike] = None,
    device=None,
) -> Dict[str, List[float]]:
    """Parse a .res file, compute and normalize its QPP, and write
    ``output_path`` (a .mmnorm.qpp file) when given."""
    import json

    if not os.path.exists(res_path):
        raise FileNotFoundError(f"Run file not found: {res_path}")

    query_texts: Dict[str, str] = {}
    if queries_path and os.path.exists(queries_path):
        with open(queries_path) as f:
            for line in f:
                q = json.loads(line)
                query_texts[str(q["_id"])] = q["text"]

    runs: Dict[str, List[float]] = defaultdict(list)
    with open(res_path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 5:
                runs[parts[0]].append(float(parts[4]))
    if not runs:
        raise ValueError(f"No valid entries in run file: {res_path}")

    results = compute_qpp(dict(runs), query_texts, top_k=top_k, normalize=normalize,
                          device=device)
    if output_path:
        write_qpp_file(results, output_path)
    return results


def compute_qpp_for_runtensor(
    rt: RunTensor,
    query_texts: Optional[Dict[str, str]] = None,
    normalize: Optional[str] = None,
    cutoff: Optional[int] = None,
    features: Optional[np.ndarray] = None,
    device=None,
) -> np.ndarray:
    """RunTensor -> qpp [R, Q, 13] (host f32), normalized per retriever
    across queries, computed on `device`. A fully padded row has n_valid 0
    and gives zeros. `features` lets a caller hoist the text features of a
    query set it evaluates many times."""
    normalize = normalize if normalize is not None else config.qpp.normalization
    cutoff = cutoff or config.qpp.cutoff_k
    query_texts = query_texts or {}
    feats = features if features is not None else Q.text_features_batch(
        [query_texts.get(q, q) for q in rt.qids]
    )

    dev = _device(device)
    # scores are already rank-ordered; -inf padding is masked by n_valid
    scores = torch.from_numpy(np.where(rt.valid_mask, rt.scores, 0.0).astype(np.float32)).to(dev)
    n_valid = torch.from_numpy(rt.valid_counts).to(dev)
    feats = torch.as_tensor(np.asarray(feats, np.float32), device=dev)
    out = torch.empty((rt.R, rt.Q, Q.N_METHODS), dtype=torch.float32, device=dev)
    for r in range(rt.R):
        raw = Q.qpp_kernel(scores[r], n_valid[r], feats, cutoff=cutoff)
        if normalize and normalize != "none":
            raw = Q.normalize_qpp(raw, method=normalize)
        out[r] = raw
    return out.cpu().numpy()


def qpp_tensor_to_dict(
    qpp: np.ndarray, qids: Sequence[str], retrievers: Sequence[str]
) -> Dict[str, Dict[str, List[float]]]:
    """[R, Q, 13] -> {qid: {retriever: [scores]}} (fusion-engine input shape)."""
    return {
        qid: {retrievers[r]: qpp[r, qi].tolist() for r in range(len(retrievers))}
        for qi, qid in enumerate(qids)
    }


def compute_qpp_dir(
    runs_dir: os.PathLike,
    qpp_dir: os.PathLike,
    queries_path: Optional[os.PathLike] = None,
    top_k: Optional[int] = None,
    normalize: Optional[str] = None,
    skip_existing: bool = True,
    device=None,
) -> List[Path]:
    """Stage 03: one .mmnorm.qpp per non-normalized .res in runs_dir (each
    file's queries in one device call) -> the paths written."""
    runs_dir, qpp_dir = Path(runs_dir), Path(qpp_dir)
    qpp_dir.mkdir(parents=True, exist_ok=True)
    written = []
    for res in sorted(runs_dir.glob("*.res")):
        if res.name.endswith(".norm.res"):
            continue
        out = qpp_dir / f"{res.name}.mmnorm.qpp"
        if skip_existing and out.exists():
            continue
        compute_qpp_for_res_file(res, out, top_k=top_k, normalize=normalize,
                                 queries_path=queries_path, device=device)
        written.append(out)
    return written


def _self_test(device=None) -> None:
    """Fixed-input self test: QPP of a canned 10-score list, printed."""
    scores = [0.95, 0.87, 0.82, 0.76, 0.71, 0.65, 0.58, 0.52, 0.47, 0.41]
    out = compute_qpp({"q1": scores}, {"q1": "sample test query"}, normalize="none",
                      device=device)
    names = list(config.qpp.methods)
    print("[qpp --test] 10-score fixed input:")
    for name, val in zip(names, out["q1"]):
        print(f"[qpp --test]   {name:12s} {val:.6f}")
    assert all(abs(v) < 1e6 for v in out["q1"])
    print("[qpp --test] OK")


if __name__ == "__main__":
    import sys

    if "--test" in sys.argv:
        _self_test()
    else:
        print(__doc__)
