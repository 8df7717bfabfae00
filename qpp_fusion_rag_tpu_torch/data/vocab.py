"""DocVocab: bidirectional docno-string <-> dense int32 id mapping.

Counterpart of qpp_fusion_rag_tpu/data/vocab.py, copied (plain Python):
ids are handed out in insertion order, so two packages that add the same
docnos in the same order hold the same ids. Device code works on the int32
ids; strings exist only at the TREC / corpus boundary. The vocab is
append-only and shared by every run tensor of a dataset, so ids compare
across retrievers.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Union

import numpy as np

PAD_ID = -1  # padding slot in run tensors


class DocVocab:
    __slots__ = ("_to_id", "_to_str")

    def __init__(self, docnos: Optional[Iterable[str]] = None):
        self._to_id: Dict[str, int] = {}
        self._to_str: List[str] = []
        if docnos is not None:
            for d in docnos:
                self.add(d)

    def __len__(self) -> int:
        return len(self._to_str)

    def __contains__(self, docno: str) -> bool:
        return docno in self._to_id

    def add(self, docno: str) -> int:
        docno = str(docno)
        idx = self._to_id.get(docno)
        if idx is None:
            idx = len(self._to_str)
            self._to_id[docno] = idx
            self._to_str.append(docno)
        return idx

    def encode(self, docnos: Iterable[str], add: bool = True) -> np.ndarray:
        if add:
            return np.fromiter((self.add(d) for d in docnos), dtype=np.int32)
        return np.fromiter((self._to_id.get(str(d), PAD_ID) for d in docnos), dtype=np.int32)

    def decode(self, ids: Union[np.ndarray, Iterable[int]]) -> List[str]:
        to_str = self._to_str
        return ["" if i < 0 else to_str[int(i)] for i in np.asarray(ids).ravel()]

    def id_of(self, docno: str) -> int:
        return self._to_id.get(str(docno), PAD_ID)

    def docno_of(self, idx: int) -> str:
        return "" if idx < 0 else self._to_str[idx]

    def docnos(self) -> List[str]:
        return list(self._to_str)

    def save(self, path) -> None:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self._to_str, f)

    @classmethod
    def load(cls, path) -> "DocVocab":
        with open(path) as f:
            return cls(json.load(f))
