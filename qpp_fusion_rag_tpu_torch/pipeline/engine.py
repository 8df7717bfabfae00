"""The dense flagship step (retrieve -> QPP -> weight -> fuse) and the back
half every serving step shares.

Counterpart of qpp_fusion_rag_tpu/pipeline/engine.py:

    q_emb [B, D] -- multi-view dense top-k --> scores/ids [R, B, K]
                 -- QPP (13 statistics)     --> qpp [R, B, 13]
                 -- weights (QPP column or learned MLP) --> w [R, B]
                 -- segmented-aggregation fusion --> fused [B, K_out]

Retrieval takes one of three routes, chosen as in JAX:
  * corpus_scale given: int8 rows [N, Dv] + per-doc scales [N] through K1
    (pallas_multi_view_topk_int8);
  * use_pallas=True: a bf16 corpus [N, Dv], or [Dv, N] with
    corpus_transposed=True, through K7 (pallas_multi_view_topk);
  * otherwise the chunked matmul of ops.dense (no kernel).
There is no jit: each call runs eagerly on the corpus's device, and its
other inputs (tensors or numpy arrays) move there. The training step
(make_train_state, learned_fusion_train_step) is not ported yet (ROADMAP
Queue 1).
"""

from __future__ import annotations

from typing import Optional

import torch

from qpp_fusion_rag_tpu_torch.models.mlp import mlp_apply
from qpp_fusion_rag_tpu_torch.ops import dense as D
from qpp_fusion_rag_tpu_torch.ops import fusion as F
from qpp_fusion_rag_tpu_torch.ops import qpp as Q
from qpp_fusion_rag_tpu_torch.ops.kernels.dense_topk import (
    pallas_multi_view_topk,
    pallas_multi_view_topk_int8,
)


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


def _row_minmax_scores(vals: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Per-(retriever, query) min-max: the .norm.res contract."""
    return F._row_minmax(vals, valid, fill=float("-inf"))


def _f32_on(x, device) -> torch.Tensor:
    return torch.as_tensor(x, device=device).to(torch.float32)


def _retrieve(q_emb, view_proj, corpus, k, chunk, use_pallas, corpus_transposed,
              corpus_scale):
    """The three retrieval routes. -> (vals [R, B, k], ids [R, B, k])."""
    if corpus_scale is not None:
        Dv = view_proj.shape[-1]
        N = corpus.shape[0]
        if (corpus.dim() != 2 or corpus.shape[1] != Dv or corpus_transposed
                or tuple(corpus_scale.shape) != (N,)):
            raise ValueError(
                f"the int8 route takes corpus rows [N, {Dv}] and scales [N]; got "
                f"{tuple(corpus.shape)} and {tuple(corpus_scale.shape)} (a JAX "
                "[Dv, N] + [1, N] corpus converts with "
                "pipeline.interop.flagship_corpus_from_numpy)")
        return pallas_multi_view_topk_int8(q_emb, view_proj, corpus,
                                           corpus_scale.to(torch.float32), k=k)
    if use_pallas:
        return pallas_multi_view_topk(q_emb, view_proj, corpus, k=k,
                                      transposed=corpus_transposed)
    if corpus_transposed:
        raise ValueError("transposed corpus requires use_pallas=True")
    return D.multi_view_topk(q_emb, view_proj, corpus, k=k, chunk=chunk)


def _retrieve_qpp_norm(q_emb, view_proj, corpus, text_feats, k, chunk, use_pallas,
                       corpus_transposed=False, corpus_scale=None, qpp_norm_stats=None):
    """Shared front half of both flagship steps: retrieval + QPP + the
    per-view min-max scores. -> (vals, ids, qpp, norm)."""
    dev = corpus.device
    q_emb, view_proj = _f32_on(q_emb, dev), _f32_on(view_proj, dev)
    if corpus_scale is not None:
        corpus_scale = torch.as_tensor(corpus_scale, device=dev)
    vals, ids = _retrieve(q_emb, view_proj, corpus, k, chunk, use_pallas,
                          corpus_transposed, corpus_scale)
    stats = None if qpp_norm_stats is None else _f32_on(qpp_norm_stats, dev)
    qpp = qpp_from_runs(vals, ids, _f32_on(text_feats, dev), stats=stats)
    return vals, ids, qpp, _row_minmax_scores(vals, ids >= 0)


def fused_retrieval_step(
    q_emb,                    # [B, D]
    view_proj,                # [R, D, Dv]
    corpus: torch.Tensor,     # [N, Dv] ([Dv, N] with corpus_transposed; int8 rows with corpus_scale)
    text_feats,               # [B, 4]
    k: int = 100,
    chunk: int = 16384,
    k_out: int = 100,
    method: int = F.COMBSUM,
    qpp_index: int = 5,       # RSD
    use_pallas: bool = False,
    corpus_transposed: bool = False,
    corpus_scale=None,        # [N] f32 -> int8 route
    qpp_norm_stats=None,      # [R, 2, 13] frozen calibration
):
    """One fused-retrieval forward step -> (fused_ids [B, k_out],
    fused_scores [B, k_out], qpp [R, B, 13]), weighted by QPP column
    `qpp_index`."""
    _, ids, qpp, norm = _retrieve_qpp_norm(
        q_emb, view_proj, corpus, text_feats, k, chunk, use_pallas,
        corpus_transposed=corpus_transposed, corpus_scale=corpus_scale,
        qpp_norm_stats=qpp_norm_stats)
    fused_ids, fused_scores = weight_and_fuse(ids, norm, qpp[..., qpp_index],
                                              method=method, k_out=k_out)
    return fused_ids, fused_scores, qpp


def learned_weights(mlp_params, qpp: torch.Tensor) -> torch.Tensor:
    """softmax(MLP(the [B, R*13] QPP features)) -> weights [R, B]."""
    R, B, M = qpp.shape
    feats = qpp.permute(1, 0, 2).reshape(B, R * M)
    return torch.softmax(mlp_apply(mlp_params, feats), dim=-1).T


def learned_fused_retrieval_step(
    mlp_params,               # [{"w", "b"}, ...] (interop.mlp_params_from_numpy)
    q_emb,
    view_proj,
    corpus: torch.Tensor,
    text_feats,
    k: int = 100,
    chunk: int = 16384,
    k_out: int = 100,
    use_pallas: bool = False,
    corpus_transposed: bool = False,
    corpus_scale=None,
    qpp_norm_stats=None,
):
    """Learned-fusion forward: retrieval -> QPP features -> MLP softmax
    weights -> weighted CombSUM. -> (fused_ids, fused_scores, qpp)."""
    _, ids, qpp, norm = _retrieve_qpp_norm(
        q_emb, view_proj, corpus, text_feats, k, chunk, use_pallas,
        corpus_transposed=corpus_transposed, corpus_scale=corpus_scale,
        qpp_norm_stats=qpp_norm_stats)
    fused_ids, fused_scores = weight_and_fuse(ids, norm, learned_weights(mlp_params, qpp),
                                              k_out=k_out)
    return fused_ids, fused_scores, qpp
