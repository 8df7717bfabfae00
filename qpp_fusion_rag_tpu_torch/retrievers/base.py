"""Retriever contract: RetrieverResult, BaseRetriever and score
normalization.

Counterpart of qpp_fusion_rag_tpu/retrievers/base.py (the reference's
retrieve(query, qid, top_k) -> RetrieverResult surface, results as
[(docno, score, rank)], per-query latency, TREC lines and the static
min-max of the .norm.res contract, and the TREC run writer). Plain Python:
no tensor code.
"""

from __future__ import annotations

import time
from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from typing import Dict, List, Tuple


@dataclass
class RetrieverResult:
    query_id: str
    results: List[Tuple[str, float, int]]   # (docno, score, rank 1-based)
    latency_ms: float = 0.0
    metadata: Dict = field(default_factory=dict)

    def to_trec_lines(self, tag: str) -> List[str]:
        return [f"{self.query_id} Q0 {docno} {rank} {score:.6f} {tag}"
                for docno, score, rank in self.results]


def normalize_scores(results: List[Tuple[str, float, int]]) -> List[Tuple[str, float, int]]:
    """Per-query min-max; range 1.0 when all scores are equal."""
    if not results:
        return results
    scores = [s for _, s, _ in results]
    mn, mx = min(scores), max(scores)
    rng = (mx - mn) if mx > mn else 1.0
    return [(d, (s - mn) / rng, r) for d, s, r in results]


def rows_to_results(scores_row, rows_row, docno_of) -> List[Tuple[str, float, int]]:
    """One top-k output row -> [(docno, score, rank)], skipping -1 pads."""
    return [(docno_of(int(r)), float(s), rank + 1)
            for rank, (s, r) in enumerate(zip(scores_row, rows_row)) if r >= 0]


class BaseRetriever(ABC):
    """Uniform retrieval contract over any index backend."""

    name: str = "base"

    @abstractmethod
    def retrieve(self, query: str, qid: str, top_k: int = 100) -> RetrieverResult:
        ...

    def retrieve_batch(self, queries: Dict[str, str],
                       top_k: int = 100) -> Dict[str, RetrieverResult]:
        """Default batch = loop; backends override with batched search."""
        return {qid: self.retrieve(text, qid, top_k=top_k) for qid, text in queries.items()}

    @staticmethod
    def _timed(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1000.0

    def _batched_retrieve(self, queries: Dict[str, str], batch_size: int, search_chunk,
                          docno_of) -> Dict[str, RetrieverResult]:
        """Shared batched-search loop: search_chunk(texts) -> (scores [B, k],
        rows [B, k]) holds ALL per-chunk work (encoding and search, ending
        on the host), so each query's latency_ms is the chunk time over its
        size, accounted as retrieve() accounts one query."""
        qids = list(queries)
        out: Dict[str, RetrieverResult] = {}
        for i in range(0, len(qids), batch_size):
            chunk = qids[i:i + batch_size]
            (scores, rows), ms = self._timed(
                lambda c=chunk: search_chunk([queries[q] for q in c]))
            per_query = ms / max(len(chunk), 1)
            for bi, qid in enumerate(chunk):
                out[qid] = RetrieverResult(qid, rows_to_results(scores[bi], rows[bi], docno_of),
                                           latency_ms=per_query)
        return out


def write_results_trec(results: Dict[str, RetrieverResult], path, tag: str,
                       normalize: bool = False) -> None:
    """Write a result dict as a TREC run file (rank-ordered)."""
    from qpp_fusion_rag_tpu_torch.data.loaders import write_run_file

    run = {}
    for qid, res in results.items():
        entries = normalize_scores(res.results) if normalize else res.results
        run[qid] = [(d, s) for d, s, _r in entries]
    write_run_file(run, path, tag=tag)
