"""Shared production-engine dispatch for CSR impact indexes.

Counterpart of qpp_fusion_rag_tpu/index/engines.py. SparseIndex (BM25,
index/sparse.py) and SpladeIndex (learned impacts, retrievers/splade.py)
serve the same engines over the same device layouts: the packed postings,
optionally the dual doc-ordered layout at one cap, and the doc-major
vectors. This mixin holds the one implementation of the device-array
caching and of the q8 / q8r dispatch, so a fix to the candidates clamp or
to an int32-offset guard reaches both index families.

Host classes provide:
  _packed_source() -> (docs i32 [P], weights f32 [P], offsets int64 [T+1],
      scales f32 [T] | None): dequantized CSR postings and an optional fixed
      quantization grid;
  num_docs, device (a torch.device), and _doc_vector_terms() -> int (the
      term-id space size for doc_vector_imp_bits).

Every array is built once, on first use: the packed doc vectors on
`device` from the CSR moved there, the rest on the host and then moved to
`device`. The engines run through ops/sparse.py (K3, K2, K4 / K5, K6).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from qpp_fusion_rag_tpu_torch.ops.sparse import (
    doc_vector_imp_bits,
    pack_doc_vectors_device,
    pack_doc_vectors_exact,
    pack_postings,
    pack_postings_presorted,
    sparse_score_topk_q8,
    sparse_score_topk_q8_rescored,
)


def to_numpy(*tensors):
    """Device results -> numpy arrays on the host."""
    return tuple(t.cpu().numpy() for t in tensors)


class PackedEngineMixin:
    def _packed_source(self):
        raise NotImplementedError

    def _doc_vector_terms(self) -> int:
        raise NotImplementedError

    def _to_device(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def _device_packed(self, presorted_cap: int = 0):
        """(packed, offsets_i32, term_scales) device tensors for the q8 / q8r
        engines; presorted_cap > 0 builds the dual doc-ordered layout at
        that cap (ops.sparse.pack_postings_presorted). Cached per layout
        (plain = key 0)."""
        cache = getattr(self, "_engine_cache", None)
        if cache is None:
            cache = self._engine_cache = {}
        if presorted_cap not in cache:
            docs, weights, offsets, scales = self._packed_source()
            if presorted_cap > 0:
                packed, off2, sc = pack_postings_presorted(
                    docs, weights, offsets, cap=presorted_cap, scales=scales)
                if int(off2[-1]) >= 2**31:
                    raise OverflowError("presorted dual layout exceeds the int32 device-"
                                        "index range; shard the corpus")
                offs = off2.astype(np.int32)
            else:
                packed, sc = pack_postings(docs, weights, offsets, scales=scales)
                if int(offsets[-1]) >= 2**31:
                    raise OverflowError("postings exceed the int32 device-index range; "
                                        "shard the corpus")
                offs = offsets.astype(np.int32)
            cache[presorted_cap] = tuple(map(self._to_device, (packed, offs, sc)))
        return cache[presorted_cap]

    def _device_doc_vectors(self):
        """Packed doc-major vectors and per-doc scales for the rank-safe
        rescore, packed on `device` (ops.sparse.pack_doc_vectors_device, no
        doc_cap; impact precision sized to the term space by
        doc_vector_imp_bits). -> (doc_packed, doc_scale, imp_bits)."""
        if getattr(self, "_device_docvec", None) is None:
            docs, weights, offsets, _ = self._packed_source()
            bits = doc_vector_imp_bits(self._doc_vector_terms())
            dp, ds, _ = pack_doc_vectors_device(
                *map(self._to_device, (offsets, docs, weights)), self.num_docs, imp_bits=bits)
            self._device_docvec = (dp, ds, bits)
        return self._device_docvec

    def _device_doc_vectors_exact(self):
        """Unquantized doc-major vectors (term ids and raw f32 weights) for
        the certified engine's exact rescore (ops.sparse.pack_doc_vectors_exact):
        the per-candidate slack shrinks from the imp_bits step to the f32
        tie band. Twice the packed vectors' memory; built on first use.
        -> (doc_terms, doc_w)."""
        if getattr(self, "_device_docvec_exact", None) is None:
            docs, weights, offsets, _ = self._packed_source()
            dt, dw, _ = pack_doc_vectors_exact(offsets, docs, weights, self.num_docs)
            self._device_docvec_exact = (self._to_device(dt), self._to_device(dw))
        return self._device_docvec_exact

    def _engine_topk(
        self,
        q_terms: np.ndarray,
        q_weights: np.ndarray,
        k: int,
        p_cap: int,
        engine: str,
        candidates: int = 2048,
        presorted: bool = False,
        exact_topk: bool = True,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """q8 / q8r dispatch shared by SparseIndex.search and
        SpladeIndex.search_impacts. `engine` must be "q8" or "q8r" (callers
        run "exact" through their own pair-sort path). -> numpy (scores,
        ids)."""
        packed, offs, pscales = self._device_packed(p_cap if presorted else 0)
        qt, qw = self._to_device(q_terms), self._to_device(q_weights)
        if engine == "q8r":
            dp, ds, bits = self._device_doc_vectors()
            scores, ids = sparse_score_topk_q8_rescored(
                packed, offs, pscales, dp, ds, qt, qw, k=k, p_cap=p_cap,
                candidates=min(max(candidates, k), max(self.num_docs, 1)),
                imp_bits=bits, presorted=presorted)
        elif engine == "q8":
            scores, ids = sparse_score_topk_q8(
                packed, offs, pscales, qt, qw, k=k, p_cap=p_cap, exact_topk=exact_topk,
                presorted=presorted)
        else:
            raise ValueError(f"unknown engine {engine!r}")
        return to_numpy(scores, ids)
