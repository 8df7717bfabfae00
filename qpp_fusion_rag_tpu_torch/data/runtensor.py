"""RunTensor: the run-list representation of the offline stages.

Counterpart of qpp_fusion_rag_tpu/data/runtensor.py. QPP, fusion and
evaluation take padded dense arrays instead of TREC files or per-query
dicts:

    doc_ids : int32   [R, Q, K]   (PAD_ID = -1 padding)
    scores  : float32 [R, Q, K]   (-inf padding), sorted desc within each row

R = retrievers, Q = queries, K = run depth. Doc ids index one shared
:class:`DocVocab`, so ids compare across retrievers. The arrays stay numpy
on the host, as in JAX; they go to a device only where an entry point's
`device` sends them. TREC ``.res`` files are the interchange format.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field, replace
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from qpp_fusion_rag_tpu_torch.data.loaders import load_run_file, qid_sort_key, write_run_file
from qpp_fusion_rag_tpu_torch.data.vocab import PAD_ID, DocVocab

NEG_INF = np.float32(-np.inf)
PathLike = Union[str, os.PathLike]


@dataclass
class RunTensor:
    doc_ids: np.ndarray          # int32 [R, Q, K]
    scores: np.ndarray           # float32 [R, Q, K]
    qids: List[str]              # length Q
    retrievers: List[str]        # length R
    vocab: DocVocab = field(repr=False)

    # ------------------------------------------------------------------
    # Shape helpers
    # ------------------------------------------------------------------
    @property
    def R(self) -> int:
        return self.doc_ids.shape[0]

    @property
    def Q(self) -> int:
        return self.doc_ids.shape[1]

    @property
    def K(self) -> int:
        return self.doc_ids.shape[2]

    @property
    def valid_mask(self) -> np.ndarray:
        return self.doc_ids >= 0

    @property
    def valid_counts(self) -> np.ndarray:
        """int32 [R, Q] number of real (non-pad) entries per row."""
        return self.valid_mask.sum(axis=-1).astype(np.int32)

    def __post_init__(self):
        self.doc_ids = np.asarray(self.doc_ids, dtype=np.int32)
        self.scores = np.asarray(self.scores, dtype=np.float32)
        assert self.doc_ids.shape == self.scores.shape, "doc_ids/scores shape mismatch"
        assert self.doc_ids.ndim == 3, "RunTensor is [R, Q, K]"
        assert self.doc_ids.shape[0] == len(self.retrievers)
        assert self.doc_ids.shape[1] == len(self.qids)

    # ------------------------------------------------------------------
    # Constructors
    # ------------------------------------------------------------------
    @classmethod
    def from_run_dicts(
        cls,
        runs: Dict[str, Dict[str, List[Tuple[str, float, int]]]],
        vocab: Optional[DocVocab] = None,
        qids: Optional[Sequence[str]] = None,
        k: Optional[int] = None,
    ) -> "RunTensor":
        """Build from {retriever: {qid: [(docid, score, rank)]}}.

        Entries are ordered by their TREC rank, then by descending score
        (both sorts stable); vocab ids are handed out in the order the
        docnos are met. qids default to the union across retrievers in
        qid_sort_key order.
        """
        vocab = vocab or DocVocab()
        retrievers = sorted(runs.keys())
        if qids is None:
            qid_set = set()
            for run in runs.values():
                qid_set.update(run.keys())
            qids = sorted(qid_set, key=qid_sort_key)
        qids = list(qids)

        if k is None:
            k = 1
            for run in runs.values():
                for entries in run.values():
                    k = max(k, len(entries))

        R, Q = len(retrievers), len(qids)
        doc_ids = np.full((R, Q, k), PAD_ID, dtype=np.int32)
        scores = np.full((R, Q, k), NEG_INF, dtype=np.float32)
        for r, name in enumerate(retrievers):
            run = runs[name]
            for qi, qid in enumerate(qids):
                entries = run.get(qid)
                if not entries:
                    continue
                # rank order first, then enforce the documented score-desc
                # contract (QPP statistics assume monotone rows; external
                # .res files may order ranks differently on ties)
                entries = sorted(entries, key=lambda x: x[2])
                entries = sorted(entries, key=lambda x: -x[1])[:k]
                n = len(entries)
                doc_ids[r, qi, :n] = [vocab.add(d) for d, _, _ in entries]
                scores[r, qi, :n] = [s for _, s, _ in entries]
        return cls(doc_ids, scores, qids, retrievers, vocab)

    @classmethod
    def from_trec_dir(
        cls,
        runs_dir: PathLike,
        use_normalized: bool = True,
        vocab: Optional[DocVocab] = None,
        k: Optional[int] = None,
    ) -> "RunTensor":
        """Load every ``*.norm.res`` (or ``*.res``) in a directory, one
        retriever per file, named by the file without the suffix."""
        runs_dir = Path(runs_dir)
        suffix = ".norm.res" if use_normalized else ".res"
        files = sorted(
            f for f in runs_dir.iterdir()
            if f.name.endswith(suffix)
            and (use_normalized or not f.name.endswith(".norm.res"))
        )
        if not files:
            raise FileNotFoundError(f"No *{suffix} files in {runs_dir}")
        runs = {f.name[: -len(suffix)]: load_run_file(f) for f in files}
        return cls.from_run_dicts(runs, vocab=vocab, k=k)

    @classmethod
    def from_arrays(
        cls,
        doc_ids: np.ndarray,
        scores: np.ndarray,
        qids: Sequence[str],
        retrievers: Sequence[str],
        vocab: DocVocab,
    ) -> "RunTensor":
        return cls(np.asarray(doc_ids), np.asarray(scores), list(qids), list(retrievers), vocab)

    # ------------------------------------------------------------------
    # Transformations
    # ------------------------------------------------------------------
    def minmax_normalized(self) -> "RunTensor":
        """Per-(retriever, query) min-max normalization, the ``.norm.res``
        contract: (s - min)/(max - min), with range 1.0 when all scores are
        equal. Padding stays -inf."""
        import warnings

        mask = self.valid_mask
        s = np.where(mask, self.scores, np.nan)
        with warnings.catch_warnings():
            # fully-padded rows (qid missing from one retriever) are normal;
            # suppress numpy's All-NaN slice warning for them
            warnings.simplefilter("ignore", RuntimeWarning)
            mn = np.nanmin(s, axis=-1, keepdims=True)
            mx = np.nanmax(s, axis=-1, keepdims=True)
        rng = np.where(mx > mn, mx - mn, 1.0)
        norm = (self.scores - np.where(np.isnan(mn), 0.0, mn)) / rng
        norm = np.where(mask, norm, NEG_INF).astype(np.float32)
        return replace(self, scores=norm)

    def select_retrievers(self, names: Sequence[str]) -> "RunTensor":
        idx = [self.retrievers.index(n) for n in names]
        return replace(
            self,
            doc_ids=self.doc_ids[idx],
            scores=self.scores[idx],
            retrievers=list(names),
        )

    def select_queries(self, qids: Sequence[str]) -> "RunTensor":
        pos = {q: i for i, q in enumerate(self.qids)}
        idx = [pos[q] for q in qids]
        return replace(
            self,
            doc_ids=self.doc_ids[:, idx],
            scores=self.scores[:, idx],
            qids=list(qids),
        )

    def truncate(self, k: int) -> "RunTensor":
        return replace(self, doc_ids=self.doc_ids[..., :k], scores=self.scores[..., :k])

    # ------------------------------------------------------------------
    # Export
    # ------------------------------------------------------------------
    def to_run_dict(self, retriever: Union[int, str]) -> Dict[str, List[Tuple[str, float]]]:
        r = retriever if isinstance(retriever, int) else self.retrievers.index(retriever)
        out: Dict[str, List[Tuple[str, float]]] = {}
        for qi, qid in enumerate(self.qids):
            mask = self.doc_ids[r, qi] >= 0
            docnos = self.vocab.decode(self.doc_ids[r, qi][mask])
            out[qid] = list(zip(docnos, self.scores[r, qi][mask].tolist()))
        return out

    def write_trec(self, retriever: Union[int, str], output_path: PathLike, tag: Optional[str] = None) -> None:
        name = retriever if isinstance(retriever, str) else self.retrievers[retriever]
        write_run_file(self.to_run_dict(retriever), output_path, tag=tag or name)


def load_runs_dir(runs_dir: PathLike, use_normalized: bool = True, **kw) -> RunTensor:
    """Convenience alias for :meth:`RunTensor.from_trec_dir`."""
    return RunTensor.from_trec_dir(runs_dir, use_normalized=use_normalized, **kw)
