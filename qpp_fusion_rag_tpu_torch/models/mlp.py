"""The learned-fusion MLP's forward pass (inference only).

Counterpart of qpp_fusion_rag_tpu/models/mlp.py:mlp_apply over the same
parameter list [{"w": [in, out], "b": [out]}, ...] (carry JAX parameters
over with pipeline.interop.mlp_params_from_numpy): Linear -> ReLU between
layers, logits out. Dropout and training (init_mlp_params, the optax
loop) are not ported yet (ROADMAP Queue 1).
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch


def mlp_apply(params: Sequence[Dict[str, torch.Tensor]], x: torch.Tensor) -> torch.Tensor:
    """x [B, in] -> logits [B, out]."""
    h = x
    for i, layer in enumerate(params):
        h = h @ layer["w"] + layer["b"]
        if i < len(params) - 1:
            h = torch.relu(h)
    return h
