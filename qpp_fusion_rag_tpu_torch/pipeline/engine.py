"""The dense flagship step (retrieve -> QPP -> weight -> fuse), the back
half every serving step shares, and the learned-fusion training step.

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
other inputs (tensors or numpy arrays) move there.

The training step (make_train_state, learned_fusion_train_step) retrieves
on the plain route, computes in-batch normalized QPP features without
gradient, and takes one Adam step of the MLP's soft cross-entropy, as JAX's
does; torch.optim.Adam updates the state's parameters in place.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from qpp_fusion_rag_tpu_torch import tracing as T
from qpp_fusion_rag_tpu_torch.models.mlp import init_mlp_params, mlp_apply, soft_cross_entropy
from qpp_fusion_rag_tpu_torch.ops import dense as D
from qpp_fusion_rag_tpu_torch.ops import fusion as F
from qpp_fusion_rag_tpu_torch.ops import qpp as Q
from qpp_fusion_rag_tpu_torch.ops.kernels.dense_topk import (
    pallas_multi_view_topk,
    pallas_multi_view_topk_int8,
)


def _combine(ids, norm, weights, method: int = F.COMBSUM, k_out: int = 100):
    """weight_and_fuse inside a fusion span that is already open."""
    with T.span("fusion.combine"):
        return F.fuse_kernel(ids, norm, weights, method=method, minmax_norm=False,
                             k_out=k_out)


def weight_and_fuse(ids, norm, weights, method: int = F.COMBSUM, k_out: int = 100):
    """Weighted segmented-aggregation fusion of already-normalized runs."""
    with T.span("fusion"):
        return _combine(ids, norm, weights, method=method, k_out=k_out)


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
    with T.span("qpp"):
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
    with T.span("minmax"):
        return F._row_minmax(vals, valid, fill=float("-inf"))


def _retrieve(q_emb, view_proj, corpus, k, chunk, use_pallas, corpus_transposed,
              corpus_scale):
    """The three retrieval routes. -> (vals [R, B, k], ids [R, B, k])."""
    with T.span("flagship_retrieval"):
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
    q_emb = T.to_device(q_emb, dev, torch.float32, "q_emb")
    view_proj = T.to_device(view_proj, dev, torch.float32, "view_proj")
    if corpus_scale is not None:
        corpus_scale = T.to_device(corpus_scale, dev, None, "corpus_scale")
    vals, ids = _retrieve(q_emb, view_proj, corpus, k, chunk, use_pallas,
                          corpus_transposed, corpus_scale)
    stats = (None if qpp_norm_stats is None
             else T.to_device(qpp_norm_stats, dev, torch.float32, "qpp_norm_stats"))
    qpp = qpp_from_runs(vals, ids, T.to_device(text_feats, dev, torch.float32, "text_feats"),
                        stats=stats)
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
    with T.span("flagship_step"):
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
    with T.span("flagship_step"):
        _, ids, qpp, norm = _retrieve_qpp_norm(
            q_emb, view_proj, corpus, text_feats, k, chunk, use_pallas,
            corpus_transposed=corpus_transposed, corpus_scale=corpus_scale,
            qpp_norm_stats=qpp_norm_stats)
        fused_ids, fused_scores = weight_and_fuse(ids, norm,
                                                  learned_weights(mlp_params, qpp),
                                                  k_out=k_out)
        return fused_ids, fused_scores, qpp


# =============================================================================
# Learned-fusion training step
# =============================================================================

class TrainState(NamedTuple):
    params: list        # [{"w": [in, out], "b": [out]}, ...] leaf tensors
    opt_state: dict     # the optimizer's per-parameter state (Adam.state)


def make_train_state(
    key: torch.Generator,
    n_retrievers: int,
    n_qpp_features: int,
    hidden_sizes=(32, 16),
    learning_rate: float = 1e-3,
) -> Tuple[TrainState, torch.optim.Adam]:
    """He-init MLP [n_qpp_features, *hidden_sizes, n_retrievers] drawn from
    `key` on its device -> (TrainState, Adam over its parameters with
    optax's defaults: betas (0.9, 0.999), eps 1e-8)."""
    sizes = [n_qpp_features, *hidden_sizes, n_retrievers]
    params = [{k: v.requires_grad_(True) for k, v in layer.items()}
              for layer in init_mlp_params(key, sizes)]
    opt = torch.optim.Adam([p for layer in params for p in layer.values()],
                           lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
    return TrainState(params, opt.state), opt


def learned_fusion_train_step(
    state: TrainState,
    opt: torch.optim.Adam,
    q_emb,                    # [B, D]
    targets,                  # [B, R] soft quality targets
    view_proj,                # [R, D, Dv]
    corpus: torch.Tensor,     # [N, Dv]
    text_feats,               # [B, 4]
    k: int = 100,
    chunk: int = 8192,
) -> Tuple[TrainState, torch.Tensor]:
    """One training step: retrieval (ops.dense.multi_view_topk, no
    kernel) and in-batch normalized QPP features without gradient, then
    one Adam step on the soft cross-entropy of the MLP over the [B, R*13]
    features. JAX returns a new state; here `opt` updates state.params in
    place and the same state comes back, with the loss (0-d, detached).
    Inputs move to the corpus's device."""
    dev = corpus.device
    with torch.no_grad():
        vals, ids = D.multi_view_topk(T.to_device(q_emb, dev, torch.float32, "q_emb"),
                                      T.to_device(view_proj, dev, torch.float32, "view_proj"),
                                      corpus, k=k, chunk=chunk)
        qpp = qpp_from_runs(vals, ids, T.to_device(text_feats, dev, torch.float32,
                                                   "text_feats"))
        R, B, M = qpp.shape
        feats = qpp.permute(1, 0, 2).reshape(B, R * M)
    opt.zero_grad(set_to_none=True)
    loss = soft_cross_entropy(mlp_apply(state.params, feats),
                              T.to_device(targets, dev, torch.float32, "targets"))
    loss.backward()
    opt.step()
    return state, loss.detach()
