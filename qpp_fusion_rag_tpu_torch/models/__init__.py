"""Fusion-weight models of the port, mirroring qpp_fusion_rag_tpu.models:
the registry's model-type names (per_retriever / multioutput / mlp) and
their classes."""

from qpp_fusion_rag_tpu_torch.models.base import (
    BaseFusionModel,
    build_features,
    compute_targets,
    load_model,
)
from qpp_fusion_rag_tpu_torch.models.gbdt import Booster, MultiOutputGBDT, PerRetrieverGBDT
from qpp_fusion_rag_tpu_torch.models.mlp import FusionMLP

MODEL_REGISTRY = {
    "per_retriever": PerRetrieverGBDT,
    "multioutput": MultiOutputGBDT,
    "mlp": FusionMLP,
}


def get_model_class(name: str):
    if name not in MODEL_REGISTRY:
        raise KeyError(f"Unknown model type {name!r}; known: {sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[name]


__all__ = [
    "BaseFusionModel", "build_features", "compute_targets", "load_model",
    "Booster", "PerRetrieverGBDT", "MultiOutputGBDT", "FusionMLP",
    "MODEL_REGISTRY", "get_model_class",
]
