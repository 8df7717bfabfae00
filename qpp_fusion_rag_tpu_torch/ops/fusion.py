"""Rank fusion as one segmented aggregation over padded run tensors.

Counterpart of qpp_fusion_rag_tpu/ops/fusion.py (_row_minmax,
fuse_kernel and the method codes). Inputs:

    ids     : int32   [R, Q, K]  doc ids (PAD = -1), rank-ordered
    scores  : float32 [R, Q, K]  scores (-inf padding)
    weights : float32 [R, Q]     per-(retriever, query) weight

Per query: contributions (w * s, optionally row min-max normalized, or
w / (rrf_k + rank)) flatten to [R*K], sum per doc id, and the exact top
k_out runs come out. The JAX kernel vmaps over queries; here the query
axis is a batch dimension.
"""

from __future__ import annotations

import torch

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
    """Fuse R run tensors -> (fused_ids [Q, k_out], fused_scores [Q, k_out])."""
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
