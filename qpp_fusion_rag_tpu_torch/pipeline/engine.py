"""Shared back half of every serving step: QPP over run tensors, then
weighted fusion. Counterpart of qpp_fusion_rag_tpu/pipeline/engine.py
(qpp_from_runs, weight_and_fuse)."""

from __future__ import annotations

from typing import Optional

import torch

from qpp_fusion_rag_tpu_torch.ops import fusion as F
from qpp_fusion_rag_tpu_torch.ops import qpp as Q


def weight_and_fuse(ids, norm, weights, method: int = F.COMBSUM, k_out: int = 100):
    """Weighted segmented-aggregation fusion of already-normalized runs."""
    return F.fuse_kernel(ids, norm, weights, method=method, minmax_norm=False,
                         k_out=k_out)


def qpp_from_runs(
    vals: torch.Tensor,        # [R, B, K] raw retrieval scores (desc)
    ids: torch.Tensor,         # [R, B, K] (-1 pad)
    text_feats: torch.Tensor,  # [B, 4]
    cutoff: int = Q.DEFAULT_CUTOFF,
    normalize: bool = True,
    stats: Optional[torch.Tensor] = None,   # [R, 2, 13] frozen calibration
) -> torch.Tensor:
    """-> qpp [R, B, 13]: raw, in-batch min-max normalized, or normalized
    against frozen calibration `stats`."""
    n_valid = (ids >= 0).sum(-1).to(torch.int32)
    clean = torch.where(ids >= 0, vals, 0.0)
    qpp = Q.qpp_kernel(clean, n_valid, text_feats, cutoff=cutoff)
    if stats is not None:
        return Q.normalize_qpp_with(qpp, stats)
    if normalize:
        qpp = Q.normalize_qpp_with(qpp, None)
    return qpp
