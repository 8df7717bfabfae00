"""Carry a built ensemble index over from the JAX package's layout.

The JAX package's ``EnsembleIndexes`` holds the dense corpus twice, as
``corpus_int`` [D, N] (its TPU kernel layout) and ``corpus_rows`` [N, D];
the port keeps only ``corpus_rows``. Sparse arrays are byte-equal between
the packages, so one host build serves both.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from qpp_fusion_rag_tpu_torch.pipeline.ensemble import EnsembleIndexes

_INT32_MAX = 2**31 - 1


def _tensor(x, device, dtype) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.require(x, requirements=["C", "W"]))
    return x.to(device=device, dtype=dtype).contiguous()


def _offsets(x, device) -> torch.Tensor:
    hi = int(x.max()) if len(x) else 0
    if hi > _INT32_MAX:
        raise ValueError(f"posting offsets reach {hi}, beyond int32")
    return _tensor(x, device, torch.int32)


def indexes_from_numpy(d: Mapping[str, object], device) -> EnsembleIndexes:
    """Arrays of a JAX ``EnsembleIndexes`` (``np.asarray`` of each field;
    numpy arrays or torch tensors) -> the port's ``EnsembleIndexes`` on
    `device`.

    When ``corpus_int`` is given it must equal ``corpus_rows.T`` and is then
    dropped. Offsets are cast to int32 and ``d_scale`` flattened to [N];
    fields of the other sparse modes (doc vectors, tails) are ignored."""
    rows = d["corpus_rows"]
    if not isinstance(rows, torch.Tensor):
        rows = torch.from_numpy(np.require(rows, requirements=["C", "W"]))
    if rows.dtype != torch.int8:
        raise ValueError(f"corpus_rows must be int8, got {rows.dtype}")
    corpus_int = d.get("corpus_int")
    if corpus_int is not None and not np.array_equal(np.asarray(corpus_int),
                                                      rows.cpu().numpy().T):
        raise ValueError("corpus_int is not corpus_rows.T: the two dense "
                         "layouts of the index disagree")
    return EnsembleIndexes(
        bm25_packed=_tensor(d["bm25_packed"], device, torch.int32),
        bm25_scales=_tensor(d["bm25_scales"], device, torch.float32),
        bm25_offsets=_offsets(d["bm25_offsets"], device),
        splade_packed=_tensor(d["splade_packed"], device, torch.int32),
        splade_scales=_tensor(d["splade_scales"], device, torch.float32),
        splade_offsets=_offsets(d["splade_offsets"], device),
        corpus_rows=_tensor(rows, device, torch.int8),
        d_scale=_tensor(d["d_scale"], device, torch.float32).reshape(-1),
    )
