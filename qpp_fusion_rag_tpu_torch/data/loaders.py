"""Host-side data plumbing the retrievers need: a document's text from a
corpus mapping, the canonical qid order and the TREC run writer.

Counterpart of the part of qpp_fusion_rag_tpu/data/loaders.py that the
retriever layer uses (doc_text, qid_sort_key, write_run_file); the rest of
that module (BEIR readers, LazyCorpus, QPP files) is not ported yet. The
run file format is byte-compatible with the JAX package's.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, List, Tuple, Union

PathLike = Union[str, os.PathLike]


def doc_text(corpus, docno: str) -> str:
    """Text for `docno` from any corpus backend: an object with get_text
    (a lazy on-disk reader) or a mapping of docno -> text or -> {'title',
    'text'} record (title and text joined)."""
    if hasattr(corpus, "get_text"):
        return corpus.get_text(docno)
    rec = corpus.get(docno, "")
    if isinstance(rec, dict):
        title = rec.get("title", "")
        text = rec.get("text", "")
        return f"{title} {text}".strip() if title else text
    return rec


def qid_sort_key(q: str):
    """Canonical qid ordering: numeric and 'test<N>' qids numerically first,
    then everything else lexicographically (type-stable for mixed sets)."""
    if q.startswith("test") and q[4:].isdigit():
        return (0, int(q[4:]), q)
    if q.isdigit():
        return (0, int(q), q)
    return (1, 0, q)


def write_run_file(run: Dict[str, List[Tuple[str, float]]], output_path: PathLike,
                   tag: str = "fusion") -> None:
    """Write {qid: [(docid, score)]} as TREC lines, qids in qid_sort_key
    order, each query's docs by score descending, ranks 1..n."""
    path = Path(output_path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as fout:
        for qid in sorted(run.keys(), key=qid_sort_key):
            ranked = sorted(run[qid], key=lambda x: x[1], reverse=True)
            for rank, (docid, score) in enumerate(ranked, start=1):
                fout.write(f"{qid} Q0 {docid} {rank} {score:.6f} {tag}\n")
