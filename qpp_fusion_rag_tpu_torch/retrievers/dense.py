"""Dense retriever: brute-force top-k over an embedding matrix on one
device.

Counterpart of qpp_fusion_rag_tpu/retrievers/dense.py. The index directory
layout is the same (embeddings.npy [N, D] + docnos.txt), so one saved index
serves both packages. The settings JAX reads from its YAML config are
constructor defaults here: corpus_dtype bfloat16, chunk_docs 131072,
batch_size 1024. Multi-GPU search (JAX's `mesh`) is not ported yet
(ROADMAP Queue 1 item 12): `mesh` must be None.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from qpp_fusion_rag_tpu_torch.ops.dense import dense_topk
from qpp_fusion_rag_tpu_torch.ops.kernels.dense_topk import quantize_rows
from qpp_fusion_rag_tpu_torch.pipeline.ensemble import dense_view_rescored, dense_view_topk
from qpp_fusion_rag_tpu_torch.retrievers.base import (
    BaseRetriever,
    RetrieverResult,
    rows_to_results,
)

ENGINES = ("stream", "int8", "int8r")


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise ValueError("multi-device search is not ported yet (ROADMAP Queue 1 "
                         "item 12); pass mesh=None")


class DenseIndex:
    """Embedding matrix + docno mapping, resident on `device` for search.

    Rows are SHUFFLED at construction by default (numpy's
    default_rng(seed).permutation, the JAX package's exact permutation):
    the group-max reductions keep one candidate per 128-row block, so a
    corpus ordered by topic would lose recall. The docno list permutes with
    the rows. `device` defaults to "cuda": on a machine without a card the
    first search raises, as every other entry point of the port does; pass
    device="cpu" for the plain versions."""

    def __init__(self, embeddings: np.ndarray, docnos: List[str],
                 normalize: bool = False, shuffle: bool = True, seed: int = 0,
                 corpus_dtype: torch.dtype = torch.bfloat16, chunk_docs: int = 131_072,
                 device=None):
        emb = np.asarray(embeddings)
        docnos = list(docnos)
        if shuffle and len(docnos) > 1:
            perm = np.random.default_rng(seed).permutation(len(docnos))
            emb = emb[perm]
            docnos = [docnos[i] for i in perm]
        if normalize:
            norms = np.linalg.norm(emb, axis=1, keepdims=True)
            emb = emb / np.maximum(norms, 1e-12)
        self.embeddings = emb
        self.docnos = docnos
        self.corpus_dtype = corpus_dtype
        self.chunk_docs = chunk_docs
        self.device = torch.device("cuda" if device is None else device)
        self._matrix = None
        self._int8 = None

    @property
    def num_docs(self) -> int:
        return len(self.docnos)

    @property
    def dim(self) -> int:
        return self.embeddings.shape[1]

    def save(self, path) -> None:
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        np.save(path / "embeddings.npy", self.embeddings)
        (path / "docnos.txt").write_text("\n".join(self.docnos) + "\n")

    @classmethod
    def load(cls, path, **kw) -> "DenseIndex":
        """A saved index (already shuffled: it is not shuffled again)."""
        path = Path(path)
        return cls(np.load(path / "embeddings.npy"),
                   (path / "docnos.txt").read_text().splitlines(), shuffle=False, **kw)

    def device_matrix(self) -> torch.Tensor:
        """The embeddings [N, D] in corpus_dtype on the device (made once)."""
        if self._matrix is None:
            self._matrix = torch.as_tensor(self.embeddings).to(
                device=self.device, dtype=self.corpus_dtype).contiguous()
        return self._matrix

    def device_int8(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The int8 layout (made once): per-doc symmetric int8 rows [N, D]
        and scales [N], for K1 and the int8 rerank gather."""
        if self._int8 is None:
            rows, scale = quantize_rows(torch.as_tensor(self.embeddings, dtype=torch.float32)
                                        .to(self.device))
            self._int8 = (rows, scale[:, 0].contiguous())
        return self._int8

    def search(self, query_embeddings: np.ndarray, k: int = 100, mesh=None,
               engine: str = "stream", rescore_pool: int = 512) -> Tuple[np.ndarray, np.ndarray]:
        """-> (scores [B, k], row ids [B, k], -1 pad), numpy.

        engine: "stream" (the chunked matmul at corpus_dtype, exact), "int8"
        (K1: per-doc int8 scores with the fused group max) or "int8r" (the
        rank-safe one: K1 pools the top max(rescore_pool, k) rows, which are
        rescored on the int8 rows with their scales)."""
        _no_mesh(mesh)
        if engine not in ENGINES:
            raise ValueError(f"unknown engine {engine!r}; one of {ENGINES}")
        q = torch.as_tensor(np.asarray(query_embeddings, dtype=np.float32)).to(self.device)
        if engine == "stream":
            vals, ids = dense_topk(q, self.device_matrix(), k=k,
                                   chunk=min(self.chunk_docs, self.num_docs))
        else:
            rows, scale = self.device_int8()
            if engine == "int8r":
                vals, ids = dense_view_rescored(q, rows, scale, rows, k, max(rescore_pool, k))
            else:
                vals, ids = dense_view_topk(q, rows, scale, k)
        return vals.cpu().numpy(), ids.cpu().numpy()


class DenseRetriever(BaseRetriever):
    name = "dense"

    def __init__(self, index: DenseIndex,
                 encoder: Optional[Callable[[Sequence[str]], np.ndarray]] = None,
                 mesh=None, engine: str = "stream", rescore_pool: int = 512,
                 batch_size: int = 1024):
        _no_mesh(mesh)
        self.index = index
        self.encoder = encoder
        self.engine = engine
        self.rescore_pool = rescore_pool
        self.batch_size = batch_size

    @classmethod
    def from_index_dir(cls, index_dir, encoder=None, **kw) -> "DenseRetriever":
        return cls(DenseIndex.load(index_dir), encoder=encoder, **kw)

    def search_embeddings(self, query_embeddings: np.ndarray,
                          k: int = 100) -> Tuple[np.ndarray, np.ndarray]:
        return self.index.search(query_embeddings, k=k, engine=self.engine,
                                 rescore_pool=self.rescore_pool)

    def _encode(self, texts: Sequence[str]) -> np.ndarray:
        if self.encoder is None:
            raise RuntimeError("DenseRetriever has no query encoder; pass encoder= or use "
                               "search_embeddings() with precomputed embeddings")
        return np.asarray(self.encoder(list(texts)))

    def retrieve(self, query: str, qid: str, top_k: int = 100) -> RetrieverResult:
        (scores, rows), ms = self._timed(
            lambda: self.search_embeddings(self._encode([query]), k=top_k))
        return RetrieverResult(qid, rows_to_results(scores[0], rows[0], self.index.docnos.__getitem__),
                               latency_ms=ms)

    def retrieve_batch(self, queries: Dict[str, str], top_k: int = 100,
                       batch_size: Optional[int] = None) -> Dict[str, RetrieverResult]:
        return self._batched_retrieve(
            queries, batch_size or self.batch_size,
            lambda texts: self.search_embeddings(self._encode(texts), k=top_k),
            self.index.docnos.__getitem__)
