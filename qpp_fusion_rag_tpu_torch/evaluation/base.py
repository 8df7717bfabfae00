"""Task typing + gold/prediction dataclasses for end-task evaluation.

Counterpart of qpp_fusion_rag_tpu/evaluation/base.py, copied (host
Python).

Mirrors the reference's typed evaluation layer (reference
src/evaluation/base.py:25-168): TaskType enum, dataset -> task mapping,
gold-label and prediction containers shared by the QA and
fact-verification evaluators.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, List, Optional

from qpp_fusion_rag_tpu_torch.config import config


class TaskType(Enum):
    QA = "qa"
    FACT_VERIFICATION = "fact_verification"
    GENERATION = "generation"


def get_task_type(dataset: str) -> TaskType:
    """Dataset name -> task type via config (reference base.py:40-55)."""
    ds = config.datasets.get(dataset)
    if ds is None:
        return TaskType.QA
    return TaskType(str(ds.get("task_type", "qa")))


@dataclass
class QAGoldLabel:
    query_id: str
    answers: List[str]
    metadata: Dict = field(default_factory=dict)


@dataclass
class QAPrediction:
    query_id: str
    answer: str
    contexts: List[str] = field(default_factory=list)
    latency_ms: float = 0.0


@dataclass
class FactVerificationGoldLabel:
    query_id: str
    label: str                      # SUPPORT | CONTRADICT | NOT_ENOUGH_INFO
    evidence_doc_ids: List[str] = field(default_factory=list)

    # Normalization map for free-form model outputs
    # (reference src/evaluation/fact_verification.py LABEL_MAP semantics).
    LABEL_MAP = {
        "SUPPORT": "SUPPORT", "SUPPORTS": "SUPPORT", "SUPPORTED": "SUPPORT",
        "TRUE": "SUPPORT", "YES": "SUPPORT", "ENTAILMENT": "SUPPORT",
        "CONTRADICT": "CONTRADICT", "CONTRADICTS": "CONTRADICT",
        "CONTRADICTED": "CONTRADICT", "REFUTE": "CONTRADICT",
        "REFUTES": "CONTRADICT", "FALSE": "CONTRADICT", "NO": "CONTRADICT",
        "NOT_ENOUGH_INFO": "NOT_ENOUGH_INFO", "NOT ENOUGH INFO": "NOT_ENOUGH_INFO",
        "NEI": "NOT_ENOUGH_INFO", "UNKNOWN": "NOT_ENOUGH_INFO",
        "UNVERIFIABLE": "NOT_ENOUGH_INFO", "NEUTRAL": "NOT_ENOUGH_INFO",
    }

    @classmethod
    def normalize_label(cls, raw: str) -> Optional[str]:
        key = raw.strip().upper().replace("-", "_")
        if key in cls.LABEL_MAP:
            return cls.LABEL_MAP[key]
        key_sp = key.replace("_", " ")
        return cls.LABEL_MAP.get(key_sp)


@dataclass
class FactVerificationPrediction:
    query_id: str
    label: str
    rationale: str = ""
    evidence_doc_ids: List[str] = field(default_factory=list)
    latency_ms: float = 0.0
