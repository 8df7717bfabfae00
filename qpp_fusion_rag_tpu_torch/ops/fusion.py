"""Rank fusion as one segmented aggregation over padded run tensors.

Counterpart of qpp_fusion_rag_tpu/ops/fusion.py (_row_minmax,
fuse_kernel, the string-dispatch fuse and the method codes). Inputs:

    ids     : int32   [R, Q, K]  doc ids (PAD = -1), rank-ordered
    scores  : float32 [R, Q, K]  scores (-inf padding)
    weights : float32 [R, Q]     per-(retriever, query) weight

Per query: contributions (w * s, optionally row min-max normalized, or
w / (rrf_k + rank)) flatten to [R*K], sum per doc id, and the exact top
k_out runs come out. The JAX kernel vmaps over queries; here the query
axis is a batch dimension.
"""

from __future__ import annotations

from typing import Optional

import torch

from qpp_fusion_rag_tpu_torch.ops import graphs as G
from qpp_fusion_rag_tpu_torch.ops.segment import SENTINEL, segmented_topk

COMBSUM, COMBMNZ, RRF = 0, 1, 2


def _row_minmax(scores: torch.Tensor, valid: torch.Tensor,
                fill: float = 0.0) -> torch.Tensor:
    """Per-row min-max over valid entries along the last axis; equal-score
    rows map to 0; invalid entries become `fill`."""
    mn = torch.where(valid, scores, float("inf")).amin(dim=-1, keepdim=True)
    mx = torch.where(valid, scores, float("-inf")).amax(dim=-1, keepdim=True)
    rng = torch.where(mx > mn, mx - mn, 1.0)
    out = (scores - torch.where(torch.isfinite(mn), mn, 0.0)) / rng
    return torch.where(valid, out, fill)


def fuse_kernel(ids: torch.Tensor, scores: torch.Tensor, weights: torch.Tensor,
                method: int = COMBSUM, rrf_k: float = 60.0,
                minmax_norm: bool = True, k_out: int = 100):
    """Fuse R run tensors -> (fused_ids [Q, k_out], fused_scores [Q, k_out]).
    On a CUDA device a repeated call replays a captured graph of
    fuse_eager (ops/graphs.py, site "fusion"); elsewhere it runs
    fuse_eager."""
    return G.replay_or_run("fusion", fuse_eager, (ids, scores, weights),
                           {"method": method, "rrf_k": rrf_k,
                            "minmax_norm": minmax_norm, "k_out": k_out})


def fuse_eager(ids: torch.Tensor, scores: torch.Tensor, weights: torch.Tensor,
               method: int = COMBSUM, rrf_k: float = 60.0,
               minmax_norm: bool = True, k_out: int = 100):
    """fuse_kernel's eager route: the fusion op by op."""
    R, Q, K = ids.shape
    valid = ids >= 0
    if method == RRF:
        ranks = torch.arange(1, K + 1, dtype=torch.float32, device=scores.device)
        contrib = weights[..., None] / (rrf_k + ranks)
    else:
        s = _row_minmax(scores, valid) if minmax_norm else torch.where(valid, scores, 0.0)
        contrib = weights[..., None] * s
    contrib = torch.where(valid, contrib, 0.0)
    flat_ids = torch.where(valid, ids, SENTINEL).permute(1, 0, 2).reshape(Q, R * K)
    flat_vals = contrib.permute(1, 0, 2).reshape(Q, R * K)
    top_ids, top_vals, _ = segmented_topk(flat_ids, flat_vals, min(k_out, R * K),
                                          count_bonus=(method == COMBMNZ))
    return top_ids, top_vals


def fuse(ids, scores, weights=None, method: str = "combsum", rrf_k: float = 60.0,
         minmax_norm: Optional[bool] = None, k_out: int = 100, device=None):
    """String-dispatch wrapper over fuse_kernel. weights=None fuses
    unweighted (all 1) and then min-max normalizes sum / mnz rows by
    default (ranx fuse()'s default); given weights, rows are taken as
    already normalized (.norm.res scores). rrf ignores minmax_norm. Inputs
    are tensors or numpy arrays; they go to `device`, by default the device
    of `ids` when it is a tensor, else the card."""
    code = {"combsum": COMBSUM, "sum": COMBSUM, "combmnz": COMBMNZ, "mnz": COMBMNZ,
            "rrf": RRF}[method.lower()]
    if device is None:
        device = ids.device if isinstance(ids, torch.Tensor) else "cuda"
    ids = torch.as_tensor(ids, device=device)
    scores = torch.as_tensor(scores, device=device)
    if weights is None:
        weights = torch.ones(ids.shape[:2], dtype=torch.float32, device=device)
        if minmax_norm is None:
            minmax_norm = True
    else:
        weights = torch.as_tensor(weights, device=device).to(torch.float32)
        if minmax_norm is None:
            minmax_norm = False
    return fuse_kernel(ids, scores, weights, method=code, rrf_k=float(rrf_k),
                       minmax_norm=bool(minmax_norm), k_out=int(k_out))
