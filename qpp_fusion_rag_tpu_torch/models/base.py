"""Fusion-weight models: the shared base and feature building.

Counterpart of qpp_fusion_rag_tpu/models/base.py. Features are a
flattened n_qpp x n_retrievers QPP matrix per query; targets are
per-retriever quality soft labels that sum to 1 per query. Models pickle
in the envelope {'model', 'retrievers', 'n_qpp', 'model_type'}, as in the
JAX package and the reference. A pickle names the classes of the package
that wrote it, so the two packages' pickles load only in their own package.
"""

from __future__ import annotations

import pickle
from abc import ABC, abstractmethod
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from qpp_fusion_rag_tpu_torch.config import config


class BaseFusionModel(ABC):
    """Predicts per-query retriever weights from QPP features."""

    def __init__(self, retrievers: List[str], n_qpp: Optional[int] = None):
        self.retrievers = list(retrievers)
        self.n_retrievers = len(retrievers)
        self.n_qpp = n_qpp if n_qpp is not None else config.qpp.n_methods
        self.n_features = self.n_qpp * self.n_retrievers
        self.feature_names = [f"{r}_{i}" for r in self.retrievers for i in range(self.n_qpp)]
        self.is_trained = False

    @abstractmethod
    def train(
        self,
        X_train: np.ndarray,
        Y_train: np.ndarray,
        X_val: Optional[np.ndarray] = None,
        Y_val: Optional[np.ndarray] = None,
    ) -> Dict:
        ...

    @abstractmethod
    def predict(self, X: np.ndarray) -> np.ndarray:
        """[n, n_features] -> [n, n_retrievers] weights, clipped >= 0, sum-to-1."""
        ...

    def predict_single(self, qpp_scores: Dict[str, List[float]]) -> Dict[str, float]:
        features = np.zeros(self.n_features, dtype=np.float32)
        for j, retriever in enumerate(self.retrievers):
            if retriever in qpp_scores:
                s = list(qpp_scores[retriever])[: self.n_qpp]
                features[j * self.n_qpp : j * self.n_qpp + len(s)] = s
        weights = self.predict(features.reshape(1, -1))[0]
        return dict(zip(self.retrievers, weights.tolist()))

    def save(self, path) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "wb") as f:
            pickle.dump(
                {
                    "model": self,
                    "retrievers": self.retrievers,
                    "n_qpp": self.n_qpp,
                    "model_type": self.__class__.__name__,
                },
                f,
            )

    @classmethod
    def load(cls, path) -> "BaseFusionModel":
        with open(path, "rb") as f:
            return pickle.load(f)["model"]

    @staticmethod
    def _normalize_weights(weights: np.ndarray) -> np.ndarray:
        """Clip >= 0, then rows to sum 1; all-zero rows stay zero."""
        weights = np.clip(weights, 0, None)
        sums = weights.sum(axis=1, keepdims=True)
        sums[sums == 0] = 1
        return weights / sums


def load_model(path) -> BaseFusionModel:
    return BaseFusionModel.load(path)


def build_features(
    qpp_data: Dict[str, Dict[str, List[float]]],
    retrievers: Sequence[str],
    n_qpp: Optional[int] = None,
    qids: Optional[Sequence[str]] = None,
) -> Tuple[np.ndarray, List[str]]:
    """QPP dict -> (X [n_queries, n_qpp*R], qids). Missing (qid, retriever)
    cells, and the tail of short rows, stay 0."""
    n_qpp = n_qpp if n_qpp is not None else config.qpp.n_methods
    qids = list(qids) if qids is not None else sorted(qpp_data.keys())
    X = np.zeros((len(qids), n_qpp * len(retrievers)), dtype=np.float32)
    for i, qid in enumerate(qids):
        row = qpp_data.get(qid, {})
        for j, retriever in enumerate(retrievers):
            if retriever in row:
                s = list(row[retriever])[:n_qpp]
                X[i, j * n_qpp : j * n_qpp + len(s)] = s
    return X, qids


def compute_targets(
    per_query_quality: np.ndarray,  # [R, Q] e.g. nDCG@10 per retriever per query
) -> np.ndarray:
    """Row-normalize per-query quality into soft target distributions [Q, R]."""
    Y = np.asarray(per_query_quality, dtype=np.float32).T  # [Q, R]
    s = Y.sum(axis=1, keepdims=True)
    s[s == 0] = 1
    return Y / s
