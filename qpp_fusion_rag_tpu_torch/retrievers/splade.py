"""SPLADE learned-sparse retriever: encoder impacts -> CSR -> device scoring.

Counterpart of qpp_fusion_rag_tpu/retrievers/splade.py. The corpus side
runs a SPLADE encoder and assembles impact-ordered CSR postings over the
encoder's term (wordpiece) space in numpy; query impacts come from the
same encoder and score through the engines SparseIndex serves (ops/
sparse.py). The encoder is any object with the attributes the JAX code
reads: `tokenizer`, `max_len`, `cfg.pad_token_id`, `cfg.vocab_size` and
`top_impacts(ids, mask, k=...)`; the port has no encoder of its own yet.
The batch sizes and the query term cap the JAX package reads from its
config are defaults here (encoding 256, retrieval 1024, 64 terms).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from qpp_fusion_rag_tpu_torch.index.engines import PackedEngineMixin, to_numpy
from qpp_fusion_rag_tpu_torch.ops.sparse import sparse_score_topk
from qpp_fusion_rag_tpu_torch.retrievers.base import (
    BaseRetriever,
    RetrieverResult,
    rows_to_results,
)

ENCODING_BATCH, RETRIEVAL_BATCH, MAX_QUERY_TERMS = 256, 1024, 64


def pad_sequences(seqs: Sequence[Sequence[int]], max_len: int, pad_id: int = 0,
                  bucket: bool = True):
    """Host-side padding of pre-tokenized id sequences -> (ids, mask) int32
    (the JAX package's encoders/heads.py:pad_sequences). With bucket=True
    the width rounds up to a power of two >= 16, capped at max_len."""
    L = min(max((len(s) for s in seqs), default=1), max_len) or 1
    if bucket:
        b = 16
        while b < L:
            b *= 2
        L = min(b, max_len)
    ids = np.full((len(seqs), L), pad_id, dtype=np.int32)
    mask = np.zeros((len(seqs), L), dtype=np.int32)
    for i, s in enumerate(seqs):
        n = min(len(s), L)
        ids[i, :n] = s[:n]
        mask[i, :n] = 1
    return ids, mask


class SpladeIndex(PackedEngineMixin):
    """CSR impact lists over the encoder's term (wordpiece) space."""

    def __init__(self, offsets, docs, weights, docnos: List[str], vocab_size: int,
                 device=None):
        # offsets stay int64: past ~2.15B postings an int32 cast would wrap
        self.offsets = np.asarray(offsets, dtype=np.int64)
        self.docs = np.asarray(docs, dtype=np.int32)
        self.weights = np.asarray(weights, dtype=np.float32)
        self.docnos = list(docnos)
        self.vocab_size = int(vocab_size)
        self.device = torch.device("cuda" if device is None else device)
        self._device = None

    @property
    def num_docs(self) -> int:
        return len(self.docnos)

    @property
    def max_df(self) -> int:
        d = np.diff(self.offsets)
        return int(d.max()) if len(d) else 0

    @classmethod
    def from_impacts(
        cls,
        term_ids: np.ndarray,   # [N, k] int32 per-doc top impact terms
        weights: np.ndarray,    # [N, k] f32 impacts (0 = unused slot)
        docnos: List[str],
        vocab_size: int,
        device=None,
    ) -> "SpladeIndex":
        """Assemble impact-ordered CSR from per-doc encoder outputs."""
        term_ids, weights = np.asarray(term_ids), np.asarray(weights)
        N, k = term_ids.shape
        docs = np.repeat(np.arange(N, dtype=np.int32), k)
        terms = term_ids.reshape(-1).astype(np.int64)
        w = weights.reshape(-1).astype(np.float32)
        keep = w > 0
        docs, terms, w = docs[keep], terms[keep], w[keep]
        # sort by (term asc, weight desc): impact-ordered runs per term
        order = np.lexsort((-w, terms))
        docs, terms, w = docs[order], terms[order], w[order]
        counts = np.bincount(terms, minlength=vocab_size)
        offsets = np.zeros(vocab_size + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        return cls(offsets, docs, w, docnos, vocab_size, device=device)

    def save(self, path) -> None:
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(path / "splade.npz", offsets=self.offsets, docs=self.docs,
                            weights=self.weights, vocab_size=np.int64(self.vocab_size))
        (path / "docnos.txt").write_text("\n".join(self.docnos) + "\n")

    @classmethod
    def load(cls, path, device=None) -> "SpladeIndex":
        path = Path(path)
        a = np.load(path / "splade.npz")
        return cls(a["offsets"], a["docs"], a["weights"],
                   (path / "docnos.txt").read_text().splitlines(), int(a["vocab_size"]),
                   device=device)

    def _device_arrays(self):
        """(docs, weights, offsets_i32) on the device for "exact" (made once)."""
        if self._device is None:
            if len(self.offsets) and int(self.offsets[-1]) >= 2**31:
                raise ValueError(f"{int(self.offsets[-1])} postings exceed the int32 "
                                 "device-index range; shard the corpus before indexing")
            self._device = tuple(map(self._to_device, (
                self.docs, self.weights, self.offsets.astype(np.int32))))
        return self._device

    def _packed_source(self):
        """PackedEngineMixin provider (weights are stored f32)."""
        return self.docs, self.weights, self.offsets, None

    def _doc_vector_terms(self) -> int:
        return self.vocab_size

    def search_impacts(
        self,
        q_terms: np.ndarray,     # [B, Tq] int32 (-1 pad)
        q_weights: np.ndarray,   # [B, Tq] f32
        k: int = 100,
        p_cap: Optional[int] = None,
        exact_topk: bool = True,
        engine: str = "exact",
        candidates: int = 2048,
        presorted: bool = False,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """engine: "exact" (the pair-sort engine), "q8" (the quantized
        single-key sort engine) or "q8r" (rank-safe: a q8 pool rescored
        against the doc vectors), SparseIndex.search's engines; presorted
        (q8 / q8r) reads the dual doc-ordered layout built at this p_cap.
        p_cap defaults to min(max_df, 8192). -> numpy (scores, ids)."""
        q_terms = np.asarray(q_terms).astype(np.int32)
        q_weights = np.asarray(q_weights).astype(np.float32)
        p_cap = max(min(p_cap or min(self.max_df, 8192), self.max_df), 1)
        if presorted and engine not in ("q8", "q8r"):
            raise ValueError("presorted layout needs engine 'q8' or 'q8r'")
        if engine in ("q8", "q8r"):
            return self._engine_topk(q_terms, q_weights, k=k, p_cap=p_cap, engine=engine,
                                     candidates=candidates, presorted=presorted,
                                     exact_topk=exact_topk)
        if engine != "exact":
            raise ValueError(f"unknown engine {engine!r}")
        flat_docs, flat_weights, offsets = self._device_arrays()
        return to_numpy(*sparse_score_topk(
            flat_docs, flat_weights, offsets, self._to_device(q_terms),
            self._to_device(q_weights), k=k, p_cap=p_cap, exact_topk=exact_topk))


class SpladeRetriever(BaseRetriever):
    name = "splade"

    def __init__(self, index: SpladeIndex, encoder=None,
                 query_top_terms: Optional[int] = None, p_cap: Optional[int] = None,
                 engine: str = "exact", presorted: bool = False,
                 candidates: int = 2048):
        # engine / presorted: SpladeIndex.search_impacts semantics;
        # candidates = the q8r rescore pool
        self.index = index
        self.encoder = encoder
        self.query_top_terms = query_top_terms or MAX_QUERY_TERMS
        self.p_cap = p_cap
        self.engine = engine
        self.presorted = presorted
        self.candidates = candidates

    @classmethod
    def build(cls, encoder, corpus: Sequence[Tuple[str, str]], doc_top_terms: int = 256,
              batch_size: Optional[int] = None, **kw) -> "SpladeRetriever":
        """Encode the corpus and assemble the impact index; a `device`
        keyword goes to the index, the rest to the retriever."""
        device = kw.pop("device", None)
        batch_size = batch_size or ENCODING_BATCH
        docnos = [d for d, _ in corpus]
        texts = [t for _, t in corpus]
        all_ids, all_w = [], []
        for i in range(0, len(texts), batch_size):
            seqs = [encoder.tokenizer(t) for t in texts[i:i + batch_size]]
            ids, mask = pad_sequences(seqs, encoder.max_len, encoder.cfg.pad_token_id)
            tid, tw = encoder.top_impacts(ids, mask, k=doc_top_terms)
            all_ids.append(np.asarray(tid))
            all_w.append(np.asarray(tw))
        index = SpladeIndex.from_impacts(np.concatenate(all_ids), np.concatenate(all_w),
                                         docnos, encoder.cfg.vocab_size, device=device)
        return cls(index, encoder=encoder, **kw)

    def _encode_queries(self, texts: Sequence[str]):
        if self.encoder is None:
            raise RuntimeError(
                "SpladeRetriever has no query encoder; pass encoder= or use "
                "index.search_impacts() with precomputed query impacts")
        seqs = [self.encoder.tokenizer(t) for t in texts]
        ids, mask = pad_sequences(seqs, self.encoder.max_len, self.encoder.cfg.pad_token_id)
        tid, tw = self.encoder.top_impacts(ids, mask, k=self.query_top_terms)
        tid, tw = np.asarray(tid), np.asarray(tw)
        tid = np.where(tw > 0, tid, -1)
        return tid.astype(np.int32), tw

    def _search(self, texts, top_k: int):
        q_terms, q_weights = self._encode_queries(texts)
        return self.index.search_impacts(q_terms, q_weights, k=top_k, p_cap=self.p_cap,
                                         engine=self.engine, presorted=self.presorted,
                                         candidates=self.candidates)

    def retrieve(self, query: str, qid: str, top_k: int = 100) -> RetrieverResult:
        (scores, rows), ms = self._timed(lambda: self._search([query], top_k))
        return RetrieverResult(
            qid, rows_to_results(scores[0], rows[0], self.index.docnos.__getitem__),
            latency_ms=ms)

    def retrieve_batch(self, queries: Dict[str, str], top_k: int = 100,
                       batch_size: Optional[int] = None) -> Dict[str, RetrieverResult]:
        return self._batched_retrieve(queries, batch_size or RETRIEVAL_BATCH,
                                      lambda texts: self._search(texts, top_k),
                                      self.index.docnos.__getitem__)
