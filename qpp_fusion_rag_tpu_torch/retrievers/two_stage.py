"""Two-stage retrieval: first-stage candidates -> neural rerank.

Counterpart of qpp_fusion_rag_tpu/retrievers/two_stage.py: BM25 top-k,
then one of two reranker backends:

  * CrossEncoderReranker: joint (query, doc) scores from any scorer with
    score_pairs(pairs) -> [n] scores, in batches of 256;
  * DenseReranker: query and candidate embeddings from any encoder
    (texts -> [n, D] array or tensor), rescored by dot products with torch
    on the encoder's device.

Doc texts come from any mapping docno -> text, or any object with
get_text(docno) (data/loaders.py:doc_text). The first-stage depth, which
the JAX package reads from its config, defaults to 100.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from qpp_fusion_rag_tpu_torch.data.loaders import doc_text
from qpp_fusion_rag_tpu_torch.retrievers.base import BaseRetriever, RetrieverResult

RERANK_BATCH, FIRST_STAGE_K = 256, 100


class DenseReranker:
    """Rescore candidates with embedding dot products."""

    def __init__(self, encoder):
        self.encoder = encoder

    def score(self, query: str, doc_texts: Sequence[str]) -> np.ndarray:
        q = torch.as_tensor(self.encoder([query]))[0]
        d = torch.as_tensor(self.encoder(list(doc_texts)))
        # products in f32 at least (bf16 embeddings accumulate in f32)
        dt = torch.promote_types(torch.promote_types(d.dtype, q.dtype), torch.float32)
        return (d.to(dt) @ q.to(device=d.device, dtype=dt)).cpu().numpy()


class CrossEncoderReranker:
    """Rescore candidates with joint (query, doc) classification scores."""

    def __init__(self, scorer, batch_size: Optional[int] = None):
        self.scorer = scorer
        self.batch_size = batch_size or RERANK_BATCH

    def score(self, query: str, doc_texts: Sequence[str]) -> np.ndarray:
        out = []
        for i in range(0, len(doc_texts), self.batch_size):
            pairs = [(query, d) for d in doc_texts[i:i + self.batch_size]]
            out.append(np.asarray(self.scorer.score_pairs(pairs)))
        return np.concatenate(out) if out else np.zeros(0, np.float32)


class TwoStageRetriever(BaseRetriever):
    name = "two_stage"

    def __init__(
        self,
        first_stage: BaseRetriever,
        reranker,
        corpus: Mapping[str, str],
        first_stage_k: Optional[int] = None,
        name: Optional[str] = None,
    ):
        self.first_stage = first_stage
        self.reranker = reranker
        self.corpus = corpus
        self.first_stage_k = first_stage_k or FIRST_STAGE_K
        if name:
            self.name = name

    def _doc_text(self, docno: str) -> str:
        return doc_text(self.corpus, docno)

    def _rerank(self, query: str, docnos):
        """-> [(docno, score, rank)] of the first stage's docnos by the
        reranker's scores, descending."""
        scores = self.reranker.score(query, [self._doc_text(d) for d in docnos])
        order = np.argsort(-scores)
        return [(docnos[int(i)], float(scores[int(i)]), rank + 1)
                for rank, i in enumerate(order)]

    def retrieve(self, query: str, qid: str, top_k: int = 100) -> RetrieverResult:
        def run():
            first = self.first_stage.retrieve(query, qid, top_k=self.first_stage_k)
            docnos = [d for d, _s, _r in first.results]
            return self._rerank(query, docnos)[:top_k] if docnos else []

        results, ms = self._timed(run)
        return RetrieverResult(qid, results, latency_ms=ms)

    def retrieve_batch(self, queries: Dict[str, str], top_k: int = 100,
                       **kw) -> Dict[str, RetrieverResult]:
        # the first stage batches on the device; the rerank loops queries
        # (each call scores first_stage_k docs at once)
        firsts = self.first_stage.retrieve_batch(queries, top_k=self.first_stage_k)
        out: Dict[str, RetrieverResult] = {}
        for qid, text in queries.items():
            first = firsts[qid]
            docnos = [d for d, _s, _r in first.results]
            if not docnos:
                out[qid] = RetrieverResult(qid, [], latency_ms=first.latency_ms)
                continue
            results, ms = self._timed(lambda t=text, d=docnos: self._rerank(t, d)[:top_k])
            out[qid] = RetrieverResult(qid, results, latency_ms=first.latency_ms + ms)
        return out
