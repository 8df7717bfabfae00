"""Dense retrieval as a chunked matmul top-k, with no kernel: the
``use_pallas=False`` route of the flagship step and DenseIndex's "stream"
engine.

Counterpart of qpp_fusion_rag_tpu/ops/dense.py (plain XLA there too). The
corpus streams in document chunks; each chunk's scores ([B, chunk] f32,
products of the corpus-dtype operands summed in f32) give up their top k,
and one merge over all chunks' candidates picks the final k, so the full
[B, N] score matrix never exists. Every selection is exact with
lax.top_k's tie order (``topk_first``): the JAX function's approx_max_k
per chunk returns lax.top_k's result on the CPU, and its final merge is
exact. The last chunk is sliced short instead of padded with zero docs,
so no pad doc needs a mask.
"""

from __future__ import annotations

import torch

from qpp_fusion_rag_tpu_torch.ops.segment import topk_first

NEG = float("-inf")


def _chunk_topk(s: torch.Tensor, k: int):
    """Per-chunk candidates, padded to exactly k columns (-inf, index 0).
    -> (values [..., k], indices [..., k] int64)."""
    v, i = topk_first(s, min(k, s.shape[-1]))
    pad = k - v.shape[-1]
    if pad:
        v = torch.nn.functional.pad(v, (0, pad), value=NEG)
        i = torch.nn.functional.pad(i, (0, pad), value=0)
    return v, i


def _final_merge(vals: torch.Tensor, ids: torch.Tensor, k: int):
    """One merge over all chunks' candidates [..., n_chunks*k] -> top-k
    (values, ids)."""
    mv, top = topk_first(vals, min(k, vals.shape[-1]))
    return mv, torch.gather(ids, -1, top)


def dense_topk(queries: torch.Tensor, corpus: torch.Tensor, k: int = 100,
               chunk: int = 16384):
    """Inner-product top-k: -> (scores [B, k] f32 desc, ids [B, k] int32,
    -1 pad). Queries round to the corpus dtype; peak memory is
    O(B * (k + chunk))."""
    if chunk < 1:
        raise ValueError(f"chunk={chunk} must be positive")
    if corpus.shape[0] == 0:
        raise ValueError("the corpus is empty")
    qf = queries.to(corpus.dtype).to(torch.float32)
    cand_v, cand_i = [], []
    for n0 in range(0, corpus.shape[0], chunk):
        v, i = _chunk_topk(qf @ corpus[n0:n0 + chunk].to(torch.float32).T, k)
        cand_v.append(v)
        cand_i.append(i + n0)
    vals, ids = _final_merge(torch.cat(cand_v, -1), torch.cat(cand_i, -1).to(torch.int32), k)
    return vals, torch.where(torch.isfinite(vals), ids, -1)


def multi_view_topk(queries: torch.Tensor, view_proj: torch.Tensor, corpus: torch.Tensor,
                    k: int = 100, chunk: int = 16384):
    """R retriever views over one corpus -> (scores [R, B, k], ids [R, B, k]):
    queries [B, D] project per view ([R, D, Dv], in f32), round to the
    corpus dtype, and share one corpus stream as R*B rows."""
    qv = torch.einsum("bd,rdv->rbv", queries.to(torch.float32),
                      view_proj.to(torch.float32))
    R, B, Dv = qv.shape
    vals, ids = dense_topk(qv.reshape(R * B, Dv), corpus, k, chunk)
    return vals.reshape(R, B, k), ids.reshape(R, B, k)


def merge_topk(vals_a: torch.Tensor, ids_a: torch.Tensor, vals_b: torch.Tensor,
               ids_b: torch.Tensor, k: int):
    """Merge two top-k buffers along the last axis -> (values, ids)."""
    return _final_merge(torch.cat([vals_a, vals_b], -1), torch.cat([ids_a, ids_b], -1), k)
