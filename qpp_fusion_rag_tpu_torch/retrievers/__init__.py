"""Retriever layer of the port and its registry.

Counterpart of qpp_fusion_rag_tpu/retrievers/__init__.py: registry entries
construct lazily from an index directory, so a caller can select
retrievers by name. "bm25" serves a saved SparseIndex. The dense
("bge", "tct_colbert"), "splade" and two-stage ("bm25_tct", "bm25_monot5")
entries work when the caller passes its own `encoder=` or `reranker=`; the
branches that would load a Hugging Face checkpoint raise
NotImplementedError, because the port has no encoders yet. A `device`
keyword goes to the index (the card by default).
"""

from __future__ import annotations

from pathlib import Path

from qpp_fusion_rag_tpu_torch.retrievers.base import (
    BaseRetriever,
    RetrieverResult,
    normalize_scores,
    write_results_trec,
)

# the checkpoints the JAX package's config names for each model
BGE_MODEL = "BAAI/bge-base-en-v1.5"
TCT_MODEL = "castorini/tct_colbert-v2-hnp-msmarco"


def _no_checkpoint(what: str):
    raise NotImplementedError(
        f"{what} would load a Hugging Face checkpoint; the port has no encoders yet "
        "(ROADMAP Queue 1 item 6): pass encoder= or reranker=")


def _bm25(index_dir, **kw):
    from qpp_fusion_rag_tpu_torch.retrievers.bm25 import BM25Retriever

    return BM25Retriever.from_index_dir(index_dir, **kw)


def _dense(index_dir, model_name=None, pooling="cls", **kw):
    from qpp_fusion_rag_tpu_torch.retrievers.dense import DenseIndex, DenseRetriever

    encoder = kw.pop("encoder", None)
    if encoder is None and model_name is not None:
        _no_checkpoint(f"the dense retriever ({model_name}, {pooling} pooling)")
    device = kw.pop("device", None)
    return DenseRetriever(DenseIndex.load(index_dir, device=device), encoder=encoder, **kw)


def _bge(index_dir, **kw):
    kw.setdefault("model_name", BGE_MODEL)
    return _dense(index_dir, pooling="cls", **kw)


def _tct(index_dir, **kw):
    kw.setdefault("model_name", TCT_MODEL)
    return _dense(index_dir, pooling="mean", **kw)


def _splade(index_dir, encoder=None, **kw):
    from qpp_fusion_rag_tpu_torch.retrievers.splade import SpladeIndex, SpladeRetriever

    if encoder is None:
        _no_checkpoint("the SPLADE retriever")
    device = kw.pop("device", None)
    return SpladeRetriever(SpladeIndex.load(index_dir, device=device), encoder=encoder, **kw)


def _two_stage(index_dir, corpus=None, reranker=None, kind="cross", **kw):
    """BM25 first stage from `index_dir`/../bm25 + a neural reranker."""
    from qpp_fusion_rag_tpu_torch.retrievers.two_stage import TwoStageRetriever

    first = _bm25(Path(index_dir).parent / "bm25", device=kw.pop("device", None))
    if corpus is None:
        raise ValueError("two-stage retrievers need corpus= (a mapping or a get_text reader)")
    if reranker is None:
        _no_checkpoint(f"the {kind} reranker")
    return TwoStageRetriever(first, reranker, corpus, **kw)


RETRIEVER_REGISTRY = {
    "bm25": _bm25,
    "bge": _bge,
    "tct_colbert": _tct,
    "splade": _splade,
    "bm25_tct": lambda index_dir, **kw: _two_stage(index_dir, kind="dense", name="bm25_tct",
                                                   **kw),
    "bm25_monot5": lambda index_dir, **kw: _two_stage(index_dir, kind="cross",
                                                      name="bm25_monot5", **kw),
}


def get_retriever(name: str, index_dir=None, **kw) -> BaseRetriever:
    if name not in RETRIEVER_REGISTRY:
        raise KeyError(f"Unknown retriever {name!r}; known: {sorted(RETRIEVER_REGISTRY)}")
    return RETRIEVER_REGISTRY[name](index_dir=index_dir, **kw)


__all__ = [
    "BaseRetriever", "RetrieverResult", "normalize_scores",
    "write_results_trec", "RETRIEVER_REGISTRY", "get_retriever",
]
