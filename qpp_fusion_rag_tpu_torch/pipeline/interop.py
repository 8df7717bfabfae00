"""Carry built indexes, flagship corpora and MLP parameters over from the
JAX package's layouts.

The JAX package's ``EnsembleIndexes`` holds the int8 dense corpus as
``corpus_int`` [D, N] (its TPU kernel layout) and ``corpus_rows`` [N, D]
(the rerank gather layout). Its rank-safe index puts bf16 rows in
``corpus_rows`` beside the int8 ``corpus_int``. The port keeps one int8
layout, ``corpus_rows`` [N, D], and carries float rows as ``rerank_rows``.
Sparse arrays and doc vectors are byte-equal between the packages, so one
host build serves both.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from qpp_fusion_rag_tpu_torch.pipeline.ensemble import EnsembleIndexes

_INT32_MAX = 2**31 - 1
_DOC_VECTORS = ("bm25_doc_packed", "splade_doc_packed")
_DOC_SCALES = ("bm25_doc_scale", "splade_doc_scale")


def _as_tensor(x) -> torch.Tensor:
    """numpy (bfloat16 included: ml_dtypes' dtype, which torch.from_numpy
    refuses, goes through its uint16 bits) or torch -> a CPU/device tensor."""
    if isinstance(x, torch.Tensor):
        return x
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        bits = np.require(x.view(np.uint16), requirements=["C", "W"])
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(np.require(x, requirements=["C", "W"]))


def _tensor(x, device, dtype) -> torch.Tensor:
    return _as_tensor(x).to(device=device, dtype=dtype).contiguous()


def _offsets(x, device) -> torch.Tensor:
    hi = int(x.max()) if len(x) else 0
    if hi > _INT32_MAX:
        raise ValueError(f"posting offsets reach {hi}, beyond int32")
    return _tensor(x, device, torch.int32)


def _dense_layouts(d: Mapping[str, object], device):
    """-> (int8 corpus_rows [N, D], rerank_rows [N, D] float or None)."""
    rows = _as_tensor(d["corpus_rows"])
    corpus_int = d.get("corpus_int")
    if rows.dtype == torch.int8:
        if corpus_int is not None and not torch.equal(_as_tensor(corpus_int).cpu(),
                                                      rows.cpu().T):
            raise ValueError("corpus_int is not corpus_rows.T: the two dense "
                             "layouts of the index disagree")
        return _tensor(rows, device, torch.int8), None
    if rows.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"corpus_rows must be int8, bfloat16 or float32, got {rows.dtype}")
    if corpus_int is None:
        raise ValueError("float corpus_rows (rank-safe rerank rows) need the int8 "
                         "corpus_int [D, N] beside them for the dense kernel")
    c_int = _as_tensor(corpus_int)
    want = tuple(rows.shape)[::-1]
    if c_int.dtype != torch.int8 or tuple(c_int.shape) != want:
        raise ValueError(f"corpus_int must be int8 [D, N] = {want}, "
                         f"got {c_int.dtype} {tuple(c_int.shape)}")
    return (c_int.to(device).T.contiguous(),
            rows.to(device=device).contiguous())


def indexes_from_numpy(d: Mapping[str, object], device,
                       doc_imp_bits: Optional[int] = None) -> EnsembleIndexes:
    """Arrays of a JAX ``EnsembleIndexes`` (``np.asarray`` of each field;
    numpy arrays or torch tensors) -> the port's ``EnsembleIndexes`` on
    `device`.

    int8 ``corpus_rows``: ``corpus_int``, when given, must equal its
    transpose and is dropped. bf16 / f32 ``corpus_rows`` (the rank-safe
    index) become ``rerank_rows``, and ``corpus_int`` [D, N] int8 is then
    required and transposed once into the int8 ``corpus_rows``. Offsets are
    cast to int32 and ``d_scale`` flattened to [N]. The doc vectors and
    their scales are carried where present, and ``doc_imp_bits`` records
    their precision. The certified mode's ``*_tail`` arrays are ignored
    until it is ported."""
    corpus_rows, rerank_rows = _dense_layouts(d, device)
    extra = {}
    for name in _DOC_VECTORS:
        if d.get(name) is not None:
            extra[name] = _tensor(d[name], device, torch.int32)
    for name in _DOC_SCALES:
        if d.get(name) is not None:
            extra[name] = _tensor(d[name], device, torch.float32).reshape(-1)
    return EnsembleIndexes(
        bm25_packed=_tensor(d["bm25_packed"], device, torch.int32),
        bm25_scales=_tensor(d["bm25_scales"], device, torch.float32),
        bm25_offsets=_offsets(d["bm25_offsets"], device),
        splade_packed=_tensor(d["splade_packed"], device, torch.int32),
        splade_scales=_tensor(d["splade_scales"], device, torch.float32),
        splade_offsets=_offsets(d["splade_offsets"], device),
        corpus_rows=corpus_rows,
        d_scale=_tensor(d["d_scale"], device, torch.float32).reshape(-1),
        rerank_rows=rerank_rows,
        doc_imp_bits=doc_imp_bits,
        **extra,
    )


def flagship_corpus_from_numpy(corpus, device, corpus_scale=None):
    """A JAX flagship corpus -> (corpus tensor, scales or None) on `device`
    for pipeline.engine.

    With ``corpus_scale`` (the int8 route): JAX's int8 ``[Dv, N]`` and
    ``[1, N]`` scales become the port's one int8 layout, rows ``[N, Dv]``
    (transposed once) and flat scales ``[N]``. Without it, a bf16 or f32
    corpus (``[N, Dv]``, or ``[Dv, N]`` for corpus_transposed) is carried
    as it is, bf16 through its uint16 bits."""
    c = _as_tensor(corpus)
    if corpus_scale is None:
        if c.dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"a float flagship corpus must be bfloat16 or float32, got {c.dtype}")
        return c.to(device).contiguous(), None
    scale = _as_tensor(corpus_scale).reshape(-1)
    N = scale.shape[0]
    if c.dtype != torch.int8 or c.dim() != 2 or c.shape[1] != N:
        raise ValueError(f"the int8 flagship corpus must be int8 [Dv, {N}] beside "
                         f"[1, {N}] scales, got {c.dtype} {tuple(c.shape)}")
    return (c.to(device).T.contiguous(),
            scale.to(device=device, dtype=torch.float32).contiguous())


def mlp_params_from_numpy(params, device):
    """A JAX MLP parameter list [{"w": [in, out], "b": [out]}, ...] (numpy or
    jax arrays) -> the same list of f32 tensors on `device` for
    models.mlp.mlp_apply."""
    return [{"w": _tensor(layer["w"], device, torch.float32),
             "b": _tensor(layer["b"], device, torch.float32)} for layer in params]
