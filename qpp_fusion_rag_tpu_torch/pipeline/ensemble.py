"""Heterogeneous ensemble serving step in q8 and rank-safe q8r mode:

    view 1: BM25 impacts      — q8 windowed sparse scoring (K3 + K2); q8r
                                adds the bitonic pool (K4 / K5) and the
                                exact doc-vector rescore (K6)
    view 2: SPLADE impacts    — the same over a second index
    view 3: dense             — int8 scores + packed group max (K1); with
                                dense_rescore_pool, the pool reranked on
                                the rerank rows
    view 4: BM25→dense rerank — gather BM25's top-k candidate rows,
    view 5: BM25→dense rerank   rescore with a per-view projection

then the 13 QPP statistics per view and QPP-weighted fusion.

Counterpart of qpp_fusion_rag_tpu/pipeline/ensemble.py for sparse_mode
"q8" and "q8r", with QPP-column or learned MLP fusion weights; the
certified ("q8c"), "sort" and window-rescore modes raise
NotImplementedError until ported (ROADMAP Queue 1). Everything runs on the device the index tensors live on; there
is no jit: PyTorch runs eagerly.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from qpp_fusion_rag_tpu_torch.ops import fusion as F
from qpp_fusion_rag_tpu_torch.ops.kernels.dense_topk import dense_topk_int8
from qpp_fusion_rag_tpu_torch.ops.qpp import normalize_qpp_with
from qpp_fusion_rag_tpu_torch.ops.sparse import (
    sparse_score_topk_q8,
    sparse_score_topk_q8_rescored,
    validate_presorted_cap,
)
from qpp_fusion_rag_tpu_torch.pipeline.engine import (
    learned_weights,
    qpp_from_runs,
    weight_and_fuse,
)

_ROADMAP = "not ported yet (ROADMAP Queue 1)"


class EnsembleIndexes(NamedTuple):
    """Device tensors of the ensemble (shared doc-id space 0..N).

    One int8 dense layout: row-major corpus_rows [N, D] int8 serves the
    dense kernel and, unless rerank_rows is given, the rerank gather (the
    JAX package also keeps a [D, N] copy); d_scale is flat [N]. rerank_rows
    [N, D] bf16/f32, where given, is what the rerank views and the rank-safe
    dense pool gather: the JAX rank-safe index puts those rows in its
    corpus_rows. The doc-vector fields (pack_doc_vectors) serve
    sparse_mode "q8r"; doc_imp_bits is metadata, the imp_bits they were
    packed with. Build through pipeline.interop.indexes_from_numpy."""
    bm25_packed: torch.Tensor     # [P1] int32 (doc << 8 | uint8 impact)
    bm25_scales: torch.Tensor     # [T1] f32
    bm25_offsets: torch.Tensor    # [T1+1] int32
    splade_packed: torch.Tensor   # [P2] int32
    splade_scales: torch.Tensor   # [T2] f32
    splade_offsets: torch.Tensor  # [T2+1] int32
    corpus_rows: torch.Tensor     # [N, D] int8, per-doc symmetric quantization
    d_scale: torch.Tensor         # [N] f32 per-doc dequant scale
    rerank_rows: Optional[torch.Tensor] = None        # [N, D] bf16 / f32
    bm25_doc_packed: Optional[torch.Tensor] = None    # [N, Td1] int32
    bm25_doc_scale: Optional[torch.Tensor] = None     # [N] f32
    splade_doc_packed: Optional[torch.Tensor] = None  # [N, Td2] int32
    splade_doc_scale: Optional[torch.Tensor] = None   # [N] f32
    doc_imp_bits: Optional[int] = None


def make_sparse_scorer(sparse_mode: str, sparse_candidates: int, k: int,
                       p_cap: int, imp_bits: int = 8, presorted: bool = False,
                       sort_ids: bool = False):
    """-> scorer(packed, offsets, scales, terms, qw, doc_packed=None,
    doc_scale=None) -> (scores [B, k] desc, doc ids [B, k], -1 pad).

    "q8": the windowed q8 scorer (sparse_candidates must be 0: the
    sort-free window rescore is not ported). "q8r": the rank-safe scorer,
    a pool of sparse_candidates (512 when 0) rescored against the doc
    vectors, which the scorer then requires."""
    if sparse_mode in ("q8c", "sort") or (
            sparse_mode == "q8" and sparse_candidates > 0):
        raise NotImplementedError(
            f"sparse_mode={sparse_mode!r} with sparse_candidates="
            f"{sparse_candidates} is {_ROADMAP}; use sparse_mode='q8' with "
            "sparse_candidates=0, or 'q8r'")
    if sparse_mode == "q8r":
        cand = sparse_candidates if sparse_candidates > 0 else 512

        def scorer(packed, offsets, scales, terms, qw, doc_packed=None, doc_scale=None):
            if doc_packed is None or doc_scale is None:
                raise ValueError("sparse_mode='q8r' needs doc-major vectors "
                                 "(pack_doc_vectors) on the index")
            return sparse_score_topk_q8_rescored(
                packed, offsets, scales, doc_packed, doc_scale, terms, qw, k=k,
                p_cap=p_cap, candidates=cand, imp_bits=imp_bits, presorted=presorted,
                sort_ids=sort_ids)
        return scorer
    if sparse_mode != "q8":
        raise ValueError(f"unknown sparse_mode {sparse_mode!r}")

    def scorer(packed, offsets, scales, terms, qw, doc_packed=None, doc_scale=None):
        return sparse_score_topk_q8(packed, offsets, scales, terms, qw,
                                    k=k, p_cap=p_cap, presorted=presorted)
    return scorer


def dense_view_topk(q_emb: torch.Tensor, corpus_rows: torch.Tensor,
                    d_scale: torch.Tensor, k: int):
    """Dense view: int8 scores with the fused group max (K1), exact merge.
    -> (scores [B, k], ids [B, k])."""
    return dense_topk_int8(q_emb, corpus_rows, d_scale, k=k)


def score_candidates(
    q_vec: torch.Tensor,       # [..., B, D] second-stage queries
    cand: torch.Tensor,        # [B, K, D] candidate vectors (int8 or float)
    cand_ids: torch.Tensor,    # [B, K] first-stage doc ids (-1 pad)
    scale_vals: Optional[torch.Tensor] = None,  # [B, K] per-candidate scales
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Second-stage scoring with the JAX numerics: both operands rounded to
    bf16, then f32 products and f32 sums (the rounded values are upcast, so
    the product is exact and only the summation order differs), optional
    dequant scale, then a stable descending re-sort.
    -> (scores [..., B, K] desc, ids [..., B, K])."""
    qb = q_vec.to(torch.bfloat16).to(torch.float32)
    cb = cand.to(torch.bfloat16).to(torch.float32)
    s = torch.matmul(qb.unsqueeze(-2), cb.transpose(-1, -2)).squeeze(-2)
    if scale_vals is not None:
        s = s * scale_vals
    s = torch.where(cand_ids >= 0, s, float("-inf"))
    ids = torch.broadcast_to(cand_ids, s.shape)
    vals, order = torch.sort(s, dim=-1, descending=True, stable=True)
    return vals, torch.gather(ids, -1, order)


def rerank_candidates(
    q_vec: torch.Tensor,        # [B, D] or [V, B, D] second-stage queries
    cand_ids: torch.Tensor,     # [B, K] first-stage doc ids (-1 pad)
    corpus_rows: torch.Tensor,  # [N, D] int8 (per-doc scaled) or float
    d_scale: torch.Tensor,      # [N] f32 (ignored for float rows)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-stage rerank: gather candidate rows once for all stacked views,
    rescore, re-sort. -> (scores [..., B, K] desc, ids [..., B, K])."""
    B, K = cand_ids.shape
    safe = cand_ids.clamp_min(0).long()
    cand = corpus_rows[safe.reshape(-1)].reshape(B, K, -1)
    scale = d_scale[safe] if corpus_rows.dtype == torch.int8 else None
    return score_candidates(q_vec, cand, cand_ids, scale)


def dense_view_rescored(q_emb: torch.Tensor, corpus_rows: torch.Tensor,
                        d_scale: torch.Tensor, rerank_rows: torch.Tensor,
                        k: int, pool: int):
    """Rank-safe dense view: the int8 kernel (K1) pools the top
    max(pool, k) docs, the pooled rows of rerank_rows rescore them at their
    storage precision, and the top k remain. -> (scores [B, k], ids [B, k])."""
    _, ci = dense_view_topk(q_emb, corpus_rows, d_scale, max(pool, k))
    rs, ri = rerank_candidates(q_emb, ci, rerank_rows, d_scale)
    return rs[..., :k], ri[..., :k]


def fuse_tail(
    vals: torch.Tensor,        # [R, B, K] raw view scores (desc)
    ids: torch.Tensor,         # [R, B, K] global doc ids (-1 pad)
    qpp: torch.Tensor,         # [R, B, 13] normalized QPP
    method: int,
    qpp_index: int,
    k_out: int,
    mlp_params=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-view min-max (the .norm.res contract) + fusion weighted by one
    QPP column, or by a learned MLP's softmax over the [B, R*13] features
    (mlp_params: pipeline.interop.mlp_params_from_numpy)."""
    norm = F._row_minmax(vals, ids >= 0, fill=float("-inf"))
    weights = qpp[..., qpp_index] if mlp_params is None else learned_weights(mlp_params, qpp)
    return weight_and_fuse(ids, norm, weights, method=method, k_out=k_out)


def resolve_doc_imp_bits(idx_bits, kw_bits, default: int = 8) -> int:
    """Reconcile the imp_bits recorded on an index with an explicitly
    passed doc_imp_bits: inherit when not passed, refuse a conflict."""
    if idx_bits is None:
        return default if kw_bits is None else kw_bits
    if kw_bits is not None and kw_bits != idx_bits:
        raise ValueError(
            f"doc_imp_bits={kw_bits} conflicts with the index's packed "
            f"doc vectors (built with imp_bits={idx_bits})")
    return idx_bits


def _on(x, device, dtype):
    return torch.as_tensor(x, device=device).to(dtype)


def ensemble_retrieval_step(
    idx: EnsembleIndexes,
    bm25_terms,                 # [B, T_bm] int32 (-1 pad)
    bm25_qw,                    # [B, T_bm] f32
    splade_terms,               # [B, T_sp] int32
    splade_qw,                  # [B, T_sp] f32
    q_emb,                      # [B, D] dense query embedding
    rerank_proj,                # [2, D, D] second-stage projections
    text_feats,                 # [B, 4]
    k: int = 100,
    k_out: int = 100,
    p_cap: int = 2048,
    method: int = F.COMBSUM,
    qpp_index: int = 5,         # RSD
    sparse_candidates: int = 0,
    sparse_mode: str = "q8",
    mlp_params=None,
    qpp_norm_stats=None,        # [5, 2, 13] calibration min/max
    doc_imp_bits: Optional[int] = None,   # pack_doc_vectors precision
    dense_rescore_pool: int = 0,          # > 0: rank-safe dense view
    sparse_presorted: bool = False,       # dual doc-ordered posting layout
    sparse_sort_ids: bool = False,        # ascending-id rescore gather
):
    """5-view retrieve -> QPP -> weighted fuse on idx's device.
    -> (fused_ids [B, k_out], fused_scores [B, k_out], qpp [5, B, 13]).

    Inputs may be numpy arrays or tensors; they move to idx's device.
    doc_imp_bits is reconciled with idx.doc_imp_bits (resolve_doc_imp_bits).
    With sparse_presorted=True, p_cap is checked against the dual layout's
    build cap first (a smaller p_cap silently reads doc-id-prefix subsets);
    the check is cached per offsets tensor, so steady-state serving pays
    nothing. The rerank views and the dense pool gather idx.rerank_rows
    where given, else the int8 corpus_rows."""
    imp_bits = resolve_doc_imp_bits(idx.doc_imp_bits, doc_imp_bits)
    dev = idx.bm25_packed.device
    if sparse_presorted:
        validate_presorted_cap(idx.bm25_offsets, p_cap)
        validate_presorted_cap(idx.splade_offsets, p_cap)
    sparse = make_sparse_scorer(sparse_mode, sparse_candidates, k, p_cap,
                                imp_bits=imp_bits, presorted=sparse_presorted,
                                sort_ids=sparse_sort_ids)
    bm25_s, bm25_i = sparse(idx.bm25_packed, idx.bm25_offsets, idx.bm25_scales,
                            _on(bm25_terms, dev, torch.int32),
                            _on(bm25_qw, dev, torch.float32),
                            idx.bm25_doc_packed, idx.bm25_doc_scale)
    splade_s, splade_i = sparse(idx.splade_packed, idx.splade_offsets, idx.splade_scales,
                                _on(splade_terms, dev, torch.int32),
                                _on(splade_qw, dev, torch.float32),
                                idx.splade_doc_packed, idx.splade_doc_scale)
    q_emb = _on(q_emb, dev, torch.float32)
    rows = idx.corpus_rows if idx.rerank_rows is None else idx.rerank_rows
    if dense_rescore_pool > 0:
        dense_s, dense_i = dense_view_rescored(q_emb, idx.corpus_rows, idx.d_scale, rows,
                                               k, dense_rescore_pool)
    else:
        dense_s, dense_i = dense_view_topk(q_emb, idx.corpus_rows, idx.d_scale, k)
    qv = torch.einsum("bd,vdw->vbw", q_emb, _on(rerank_proj, dev, torch.float32))
    rr_s, rr_i = rerank_candidates(qv, bm25_i, rows, idx.d_scale)

    vals = torch.stack([bm25_s, splade_s, dense_s, rr_s[0], rr_s[1]])  # [5, B, K]
    ids = torch.stack([bm25_i, splade_i, dense_i, rr_i[0], rr_i[1]])
    qpp_raw = qpp_from_runs(vals, ids, _on(text_feats, dev, torch.float32),
                            normalize=False)
    stats = None if qpp_norm_stats is None else _on(qpp_norm_stats, dev, torch.float32)
    qpp = normalize_qpp_with(qpp_raw, stats)
    fused_ids, fused_scores = fuse_tail(vals, ids, qpp, method, qpp_index,
                                        k_out, mlp_params)
    return fused_ids, fused_scores, qpp
