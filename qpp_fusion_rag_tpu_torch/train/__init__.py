"""Training pipelines of the port (learned fusion); the same names as
qpp_fusion_rag_tpu.train."""

from qpp_fusion_rag_tpu_torch.train.fusion_trainer import (
    build_training_data,
    evaluate_weights,
    train_fusion_models,
)

__all__ = ["build_training_data", "evaluate_weights", "train_fusion_models"]
