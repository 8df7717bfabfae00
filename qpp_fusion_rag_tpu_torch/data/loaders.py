"""Host-side data plumbing: BEIR corpora, queries and qrels, TREC runs,
QPP files and gold answers.

Counterpart of qpp_fusion_rag_tpu/data/loaders.py, plain Python like it.
The file formats are byte-compatible with the JAX package's and the
reference pipeline's:

  * corpus.jsonl          — BEIR: {"_id", "title", "text"} per line
  * queries.jsonl         — BEIR: {"_id", "text"} per line
  * qrels/<split>.tsv     — header + "qid\\tdocid\\trel" (or TREC 4-column)
  * *.res                 — TREC: "qid Q0 docid rank score tag"
  * *.mmnorm.qpp          — "qid\\t<13 tab-separated floats>"
  * *_gold_answers.json   — QA: {query_text: [answers]};
                            FV: {claim_id: {claim, label, evidence_doc_ids, ...}}
"""

from __future__ import annotations

import json
import os
import re
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple, Union

from qpp_fusion_rag_tpu_torch.config import config

PathLike = Union[str, os.PathLike]


# =============================================================================
# Corpus
# =============================================================================

class LazyCorpus:
    """Byte-offset indexed on-demand corpus reader: one streaming pass builds
    docno -> byte offset, then each lookup is one seek; batched lookups seek
    in offset order, so disk access stays sequential."""

    _ID_RE = re.compile(rb'"_id"\s*:\s*"((?:[^"\\]|\\.)*)"')

    def __init__(self, corpus_path: PathLike):
        self.path = Path(corpus_path)
        self._offsets: Dict[str, int] = {}
        self._fh = None  # persistent read handle (one seek per lookup)
        self._build_index()

    def _build_index(self) -> None:
        with open(self.path, "rb") as f:
            offset = 0
            for line in f:
                # the _id leads every BEIR line: take it with the regex from
                # the line's prefix, and parse the whole line only when the
                # id holds an escape or is not found there
                m = self._ID_RE.search(line[:256])
                if m and b"\\" not in m.group(1):
                    self._offsets[m.group(1).decode("utf-8")] = offset
                else:
                    try:
                        doc = json.loads(line)
                        self._offsets[str(doc["_id"])] = offset
                    except (json.JSONDecodeError, KeyError):
                        pass
                offset += len(line)

    def _handle(self):
        if self._fh is None or self._fh.closed:
            self._fh = open(self.path, "rb")
        return self._fh

    def __len__(self) -> int:
        return len(self._offsets)

    def __contains__(self, docno: str) -> bool:
        return docno in self._offsets

    def doc_ids(self) -> List[str]:
        return list(self._offsets)

    def get(self, docno: str) -> Optional[Dict]:
        off = self._offsets.get(str(docno))
        if off is None:
            return None
        f = self._handle()
        f.seek(off)
        return json.loads(f.readline())

    def get_text(self, docno: str, include_title: bool = True) -> str:
        doc = self.get(docno)
        if doc is None:
            return ""
        title = doc.get("title", "") if include_title else ""
        text = doc.get("text", "")
        return f"{title} {text}".strip() if title else text

    def get_many(self, docnos: List[str], include_title: bool = True) -> Dict[str, str]:
        """Batched lookup with offset-sorted sequential seeks."""
        wanted = [(self._offsets[d], d) for d in docnos if d in self._offsets]
        wanted.sort()
        out: Dict[str, str] = {}
        f = self._handle()
        for off, docno in wanted:
            f.seek(off)
            doc = json.loads(f.readline())
            title = doc.get("title", "") if include_title else ""
            text = doc.get("text", "")
            out[docno] = f"{title} {text}".strip() if title else text
        return out


def load_corpus(corpus_path: PathLike, max_docs: Optional[int] = None) -> Dict[str, Dict]:
    """Eager corpus load: {docno: {"title", "text"}}."""
    corpus: Dict[str, Dict] = {}
    with open(corpus_path, encoding="utf-8") as f:
        for line in f:
            doc = json.loads(line)
            corpus[str(doc["_id"])] = {"title": doc.get("title", ""), "text": doc.get("text", "")}
            if max_docs is not None and len(corpus) >= max_docs:
                break
    return corpus


def iter_corpus(corpus_path: PathLike) -> Iterator[Tuple[str, str, str]]:
    """Stream (docno, title, text) triples."""
    with open(corpus_path, encoding="utf-8") as f:
        for line in f:
            doc = json.loads(line)
            yield str(doc["_id"]), doc.get("title", ""), doc.get("text", "")


# =============================================================================
# Queries / qrels
# =============================================================================

def load_queries(dataset_dir: PathLike, split: str = "test") -> Dict[str, str]:
    """BEIR queries, filtered to the qids of qrels/<split>.tsv when that file
    exists; a split file without qids is refused."""
    dataset_dir = Path(dataset_dir)
    queries_file = dataset_dir / "queries.jsonl"
    qrels_file = dataset_dir / "qrels" / f"{split}.tsv"

    split_qids = set()
    if qrels_file.exists():
        with open(qrels_file) as f:
            next(f, None)  # header
            for line in f:
                parts = line.strip().split("\t")
                if parts and parts[0]:
                    split_qids.add(parts[0])
        if not split_qids:
            raise ValueError(
                f"{qrels_file} exists but contains no qids — refusing to "
                "silently fall back to the unfiltered query set"
            )

    queries: Dict[str, str] = {}
    with open(queries_file, encoding="utf-8") as f:
        for line in f:
            q = json.loads(line)
            qid = str(q.get("_id", ""))
            if not split_qids or qid in split_qids:
                queries[qid] = q.get("text", "")
    return queries


def load_qrels(qrels_path: PathLike) -> Dict[str, Dict[str, int]]:
    """Qrels: BEIR 3-column TSV (qid docid rel, header skipped) or classic
    4-column TREC (qid iter docid rel), split on any whitespace; the first
    line is kept when it parses (header-less files)."""
    qrels: Dict[str, Dict[str, int]] = defaultdict(dict)

    def parse(parts) -> None:
        if len(parts) >= 4:          # classic TREC: column 2 is ignored
            qrels[parts[0]][parts[2]] = int(parts[3])
        elif len(parts) == 3:
            qrels[parts[0]][parts[1]] = int(parts[2])
        else:
            raise ValueError(str(parts))

    with open(qrels_path) as f:
        first = next(f, None)
        if first is not None:
            try:
                parse(first.split())
            except (ValueError, IndexError):
                pass
        for line in f:
            if line.strip():
                parse(line.split())
    return dict(qrels)


# =============================================================================
# TREC run files
# =============================================================================

def load_run_file(run_path: PathLike) -> Dict[str, List[Tuple[str, float, int]]]:
    """TREC run -> {qid: [(docid, score, rank)]} sorted by rank."""
    runs: Dict[str, List[Tuple[str, float, int]]] = defaultdict(list)
    with open(run_path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 5:  # trailing tag column is optional
                qid, _, docid, rank, score = parts[:5]
                runs[qid].append((docid, float(score), int(rank)))
    for qid in runs:
        runs[qid].sort(key=lambda x: x[2])
    return dict(runs)


def load_run_pairs(run_path: PathLike) -> Dict[str, List[Tuple[str, float]]]:
    """TREC run -> {qid: [(docid, score)]} rank-ordered (the evaluator's
    input shape)."""
    return {
        q: [(d, s) for d, s, _r in v] for q, v in load_run_file(run_path).items()
    }


def load_run_as_dict(run_path: PathLike) -> Dict[str, Dict[str, float]]:
    """TREC run -> {qid: {docid: score}}."""
    runs: Dict[str, Dict[str, float]] = defaultdict(dict)
    with open(run_path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 5:
                qid, _, docid, _rank, score = parts[:5]
                runs[qid][docid] = float(score)
    return dict(runs)


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


# =============================================================================
# QPP files
# =============================================================================

def load_qpp_file(qpp_path: PathLike) -> Dict[str, List[float]]:
    """One .qpp file -> {qid: [n_qpp floats]}."""
    out: Dict[str, List[float]] = {}
    with open(qpp_path) as f:
        for line in f:
            parts = line.strip().split("\t")
            if len(parts) >= 2:
                out[parts[0]] = [float(x) for x in parts[1:]]
    return out


def load_qpp_scores(qpp_dir: PathLike, suffix: str = ".mmnorm.qpp") -> Dict[str, Dict[str, List[float]]]:
    """Directory of <Retriever>.res.mmnorm.qpp -> {qid: {retriever: [scores]}}
    (the retriever's name without the suffix and a trailing .res)."""
    qpp_dir = Path(qpp_dir)
    files = sorted(qpp_dir.glob(f"*{suffix}"))
    if not files:
        raise FileNotFoundError(f"No *{suffix} files in {qpp_dir}")
    qpp_data: Dict[str, Dict[str, List[float]]] = defaultdict(dict)
    for qpp_file in files:
        retriever = qpp_file.name[: -len(suffix)]
        if retriever.endswith(".res"):
            retriever = retriever[: -len(".res")]
        for qid, scores in load_qpp_file(qpp_file).items():
            qpp_data[qid][retriever] = scores
    return dict(qpp_data)


def write_qpp_file(results: Dict[str, List[float]], output_path: PathLike) -> None:
    """Write {qid: [scores]}, qids in qid_sort_key order, 6 decimals."""
    path = Path(output_path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        for qid in sorted(results.keys(), key=qid_sort_key):
            score_str = "\t".join(f"{s:.6f}" for s in results[qid])
            f.write(f"{qid}\t{score_str}\n")


# =============================================================================
# Gold answers
# =============================================================================

def load_gold_answers(dataset: str, data_root: Optional[PathLike] = None) -> Dict:
    """Task-aware gold answers from <data_root>/<dataset>/<corpus_subdir>/
    <gold_answers_file> (the config's dataset entry). QA datasets give
    {query_text: [answers]}; fact-verification datasets give {claim_id:
    {claim, label, evidence_doc_ids, evidence_sentences}}."""
    data_root = Path(data_root) if data_root else Path(config.paths.data_root)
    ds_cfg = config.dataset(dataset)
    gold_file = data_root / dataset / ds_cfg.corpus_subdir / ds_cfg.gold_answers_file
    if not gold_file.exists():
        raise FileNotFoundError(f"Gold answers not found: {gold_file}")
    with open(gold_file) as f:
        return json.load(f)


def get_gold_answer_for_query(query_id: str, query_text: str, gold_answers: Dict, dataset: str) -> Optional[Dict]:
    """One query's gold data across the two task formats: QA by the query's
    text, fact verification by its id."""
    task_type = config.dataset(dataset).task_type
    if task_type == "qa":
        answers = gold_answers.get(query_text)
        return {"answers": answers} if answers is not None else None
    return gold_answers.get(query_id)
