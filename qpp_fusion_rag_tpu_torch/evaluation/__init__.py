"""Evaluation of the port: IR metrics, QA / fact-verification end-task
metrics, fairness and benchmark tables; the same names as
qpp_fusion_rag_tpu.evaluation."""

from qpp_fusion_rag_tpu_torch.evaluation.base import (
    FactVerificationGoldLabel,
    FactVerificationPrediction,
    QAGoldLabel,
    QAPrediction,
    TaskType,
    get_task_type,
)
from qpp_fusion_rag_tpu_torch.evaluation.fact_verification import FactVerificationEvaluator
from qpp_fusion_rag_tpu_torch.evaluation.ir_evaluator import (
    IREvaluator,
    compute_ndcg,
    per_query_metric,
)
from qpp_fusion_rag_tpu_torch.evaluation.qa_evaluator import (
    QAEvaluator,
    compute_qa_metrics_batch,
)

__all__ = [
    "TaskType", "get_task_type", "QAGoldLabel", "QAPrediction",
    "FactVerificationGoldLabel", "FactVerificationPrediction",
    "IREvaluator", "per_query_metric", "compute_ndcg",
    "QAEvaluator", "compute_qa_metrics_batch", "FactVerificationEvaluator",
]
