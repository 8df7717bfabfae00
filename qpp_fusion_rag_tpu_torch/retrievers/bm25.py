"""BM25 retriever over the native sparse index and the device scorers.

Counterpart of qpp_fusion_rag_tpu/retrievers/bm25.py (BEIR's k1 0.9,
b 0.4; query sanitization is the native tokenizer's alnum split; scoring
runs batched on the index's device, the card by default). The retrieval
batch size, which the JAX package reads from its config, defaults to 1024.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

from qpp_fusion_rag_tpu_torch.index.sparse import SparseIndex
from qpp_fusion_rag_tpu_torch.retrievers.base import (
    BaseRetriever,
    RetrieverResult,
    rows_to_results,
)

RETRIEVAL_BATCH = 1024


class BM25Retriever(BaseRetriever):
    name = "bm25"

    def __init__(self, index: SparseIndex, p_cap: Optional[int] = None,
                 engine: str = "exact", presorted: bool = False,
                 candidates: int = 2048):
        # engine: "exact" | "q8" (throughput) | "q8r" (rank-safe rescore) |
        # "certified" (SparseIndex.search semantics); presorted reads the
        # dual doc-ordered layout (q8 / q8r only); candidates = the q8r pool
        self.index = index
        self.p_cap = p_cap
        self.engine = engine
        self.presorted = presorted
        self.candidates = candidates

    @classmethod
    def from_corpus(cls, corpus: Iterable[Tuple[str, str]], **kw) -> "BM25Retriever":
        """Build the index from (docno, text) pairs; a `device` keyword goes
        to the index, the rest to the retriever."""
        device = kw.pop("device", None)
        return cls(SparseIndex.build_bm25(corpus, device=device), **kw)

    @classmethod
    def from_index_dir(cls, path, **kw) -> "BM25Retriever":
        """Load a saved index (either package's); a `device` keyword goes to
        the index, the rest to the retriever."""
        device = kw.pop("device", None)
        return cls(SparseIndex.load(path, device=device), **kw)

    @classmethod
    def from_terrier(cls, path, k1: float = 1.2, b: float = 0.75, **kw) -> "BM25Retriever":
        """Serve an on-disk Terrier index with Terrier's scoring: needs the
        Terrier importer (index/terrier.py), which is not ported yet."""
        raise NotImplementedError(
            "BM25Retriever.from_terrier needs index/terrier.py, which the port does not have "
            "yet (ROADMAP Queue 1 item 8)")

    def _search(self, texts, top_k: int):
        return self.index.search(texts, k=top_k, p_cap=self.p_cap, engine=self.engine,
                                 presorted=self.presorted, candidates=self.candidates)

    def retrieve(self, query: str, qid: str, top_k: int = 100) -> RetrieverResult:
        (scores, rows), ms = self._timed(lambda: self._search([query], top_k))
        return RetrieverResult(qid, rows_to_results(scores[0], rows[0], self.index.docno),
                               latency_ms=ms)

    def retrieve_batch(self, queries: Dict[str, str], top_k: int = 100,
                       batch_size: Optional[int] = None) -> Dict[str, RetrieverResult]:
        return self._batched_retrieve(queries, batch_size or RETRIEVAL_BATCH,
                                      lambda texts: self._search(texts, top_k),
                                      self.index.docno)
