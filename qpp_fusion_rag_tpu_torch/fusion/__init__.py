"""Rank fusion of the port: the reference's methods and the oracle /
ProbFuse / argmax-QPP baselines; the same names as
qpp_fusion_rag_tpu.fusion."""

from qpp_fusion_rag_tpu_torch.fusion.engine import (
    combmnz,
    combsum,
    learned_fusion,
    rrf,
    run_fusion,
    weighted_combmnz,
    weighted_combsum,
    weighted_rrf,
)
from qpp_fusion_rag_tpu_torch.fusion.oracle import oracle_report, oracle_run
from qpp_fusion_rag_tpu_torch.fusion.probfuse import ProbFuse

__all__ = [
    "combsum", "combmnz", "rrf",
    "weighted_combsum", "weighted_combmnz", "weighted_rrf",
    "learned_fusion", "run_fusion",
    "oracle_report", "oracle_run", "ProbFuse",
]
