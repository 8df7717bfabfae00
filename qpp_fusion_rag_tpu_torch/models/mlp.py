"""The learned-fusion MLP: functional core and the FusionMLP model.

Counterpart of qpp_fusion_rag_tpu/models/mlp.py over the same parameter
list [{"w": [in, out], "b": [out]}, ...] (carry JAX parameters over with
pipeline.interop.mlp_params_from_numpy):

  * a feature subset by QPP index (default RSD only: qpp_indices [5], one
    feature per retriever),
  * Linear -> ReLU -> Dropout between layers, n_retrievers logits out,
  * soft cross-entropy against row-normalized quality targets,
  * Adam (torch.optim.Adam with optax's defaults), the learning rate halved
    on a plateau, early stopping, the best monitored parameters kept,
  * softmax at predict.

Random draws (initial parameters, minibatch permutations, dropout masks)
come from an explicit torch.Generator; they cannot reproduce jax.random's
draws, so parity with JAX comes from carried parameters and dropout 0.
Plain tensor ops; no kernel.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from qpp_fusion_rag_tpu_torch.config import config
from qpp_fusion_rag_tpu_torch.models.base import BaseFusionModel

# =============================================================================
# Functional core (used by the pipeline's training step too)
# =============================================================================


def init_mlp_params(key: torch.Generator, sizes: Sequence[int],
                    dtype=torch.float32) -> List[Dict[str, torch.Tensor]]:
    """He-init Linear stack, sizes = [in, h1, ..., out], drawn from `key`
    on the generator's device."""
    params = []
    for i in range(len(sizes) - 1):
        w = torch.randn((sizes[i], sizes[i + 1]), generator=key, dtype=dtype,
                        device=key.device) * math.sqrt(2.0 / sizes[i])
        params.append({"w": w, "b": torch.zeros(sizes[i + 1], dtype=dtype, device=key.device)})
    return params


def mlp_apply(params: Sequence[Dict[str, torch.Tensor]], x: torch.Tensor, *,
              dropout: float = 0.0, key: Optional[torch.Generator] = None) -> torch.Tensor:
    """x [B, in] -> logits [B, out]. Dropout is active only when `key` is
    given: each hidden unit is kept with probability 1 - dropout (a draw
    from `key`) and survivors are scaled by 1 / (1 - dropout)."""
    h = x
    n = len(params)
    for i, layer in enumerate(params):
        h = h @ layer["w"] + layer["b"]
        if i < n - 1:
            h = torch.relu(h)
            if dropout > 0.0 and key is not None:
                keep = torch.rand(h.shape, generator=key, device=h.device) < 1.0 - dropout
                h = torch.where(keep, h / (1.0 - dropout), 0.0)
    return h


def soft_cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """-mean_i sum_j t_ij * log_softmax(l)_ij."""
    return -(targets * torch.log_softmax(logits, dim=-1)).sum(-1).mean()


def _leaves(params, device) -> List[Dict[str, torch.Tensor]]:
    """f32 leaf copies on `device` that take gradients."""
    return [{k: torch.as_tensor(v).detach().to(device=device, dtype=torch.float32)
             .clone().requires_grad_(True) for k, v in layer.items()} for layer in params]


def _snapshot(params) -> List[Dict[str, torch.Tensor]]:
    return [{k: v.detach().clone() for k, v in layer.items()} for layer in params]


# =============================================================================
# Model class (reference-compatible surface)
# =============================================================================


class FusionMLP(BaseFusionModel):
    """MLP fusion model with QPP-index feature filtering. Trains and
    predicts on `device` (default None: the card)."""

    def __init__(
        self,
        retrievers: List[str],
        n_qpp: Optional[int] = None,
        hidden_sizes: Optional[Sequence[int]] = None,
        qpp_indices: Optional[Sequence[int]] = None,
        dropout: Optional[float] = None,
        learning_rate: Optional[float] = None,
        epochs: Optional[int] = None,
        batch_size: Optional[int] = None,
        patience: Optional[int] = None,
        seed: int = 0,
        device=None,
    ):
        super().__init__(retrievers, n_qpp)
        mcfg = config.training.mlp
        self.qpp_indices = list(
            qpp_indices if qpp_indices is not None else mcfg.qpp_indices
        )
        default_hidden = (
            mcfg.rsd_hidden_sizes if len(self.qpp_indices) == 1 else mcfg.hidden_sizes
        )
        self.hidden_sizes = list(hidden_sizes if hidden_sizes is not None else default_hidden)
        self.dropout = float(dropout if dropout is not None else mcfg.dropout)
        self.learning_rate = float(learning_rate if learning_rate is not None else mcfg.learning_rate)
        self.epochs = int(epochs if epochs is not None else mcfg.epochs)
        self.batch_size = int(batch_size if batch_size is not None else mcfg.batch_size)
        self.patience = int(patience if patience is not None else mcfg.patience)
        self.seed = seed
        self.device = device
        self.n_input = len(self.qpp_indices) * self.n_retrievers
        self.params: Optional[list] = None
        self.history: Dict[str, list] = {}

    def _device(self) -> torch.device:
        return torch.device("cuda" if self.device is None else self.device)

    # -- features ------------------------------------------------------
    def _filter_features(self, X: np.ndarray) -> np.ndarray:
        """Select the configured QPP indices from each retriever's block."""
        cols = [
            j * self.n_qpp + i
            for j in range(self.n_retrievers)
            for i in self.qpp_indices
        ]
        return np.asarray(X, dtype=np.float32)[:, cols]

    # -- training ------------------------------------------------------
    def train(
        self,
        X_train: np.ndarray,
        Y_train: np.ndarray,
        X_val: Optional[np.ndarray] = None,
        Y_val: Optional[np.ndarray] = None,
    ) -> Dict:
        dev = self._device()
        Xt = torch.from_numpy(self._filter_features(X_train)).to(dev)
        Yt = torch.as_tensor(np.asarray(Y_train, np.float32), device=dev)
        has_val = (X_val is not None and Y_val is not None
                   and len(X_val) > 0)
        if has_val:
            Xv = torch.from_numpy(self._filter_features(X_val)).to(dev)
            Yv = torch.as_tensor(np.asarray(Y_val, np.float32), device=dev)

        sizes = [self.n_input, *self.hidden_sizes, self.n_retrievers]
        key = torch.Generator(device=dev).manual_seed(self.seed)
        params = _leaves(init_mlp_params(key, sizes), dev)

        # the learning rate is an f32 halved in f32, as JAX keeps it
        lr = np.float32(self.learning_rate)
        opt = torch.optim.Adam([p for layer in params for p in layer.values()],
                               lr=float(lr), betas=(0.9, 0.999), eps=1e-8)

        n = Xt.shape[0]
        bs = min(self.batch_size, n)
        steps = max(n // bs, 1)
        best_loss, best_params, bad_epochs, lr_bad = np.inf, _snapshot(params), 0, 0
        history = {"train_loss": [], "val_loss": [], "lr": []}

        for epoch in range(self.epochs):
            perm = torch.randperm(n, generator=key, device=dev)
            ep_loss = 0.0
            for s in range(steps):
                idx = perm[s * bs:(s + 1) * bs]
                opt.zero_grad(set_to_none=True)
                loss = soft_cross_entropy(
                    mlp_apply(params, Xt[idx], dropout=self.dropout, key=key), Yt[idx])
                loss.backward()
                opt.step()
                ep_loss += float(loss.detach())
            ep_loss /= steps
            if has_val:
                with torch.no_grad():
                    monitor = float(soft_cross_entropy(mlp_apply(params, Xv), Yv))
            else:
                monitor = ep_loss
            history["train_loss"].append(ep_loss)
            history["val_loss"].append(monitor if has_val else None)
            history["lr"].append(float(lr))

            if monitor < best_loss - 1e-6:
                best_loss, best_params, bad_epochs, lr_bad = monitor, _snapshot(params), 0, 0
            else:
                bad_epochs += 1
                lr_bad += 1
                # ReduceLROnPlateau(factor=0.5) analogue
                if lr_bad >= max(self.patience // 3, 2):
                    lr = np.float32(lr * np.float32(0.5))
                    for group in opt.param_groups:
                        group["lr"] = float(lr)
                    lr_bad = 0
                if bad_epochs >= self.patience:
                    break

        self.params = [{k: v.cpu().numpy() for k, v in layer.items()} for layer in best_params]
        self.is_trained = True
        self.history = history
        return {
            "best_loss": float(best_loss),
            "epochs_run": len(history["train_loss"]),
            "history": history,
        }

    # -- inference -----------------------------------------------------
    def predict(self, X: np.ndarray) -> np.ndarray:
        if not self.is_trained:
            raise RuntimeError("FusionMLP is not trained")
        dev = self._device()
        params = [{k: torch.tensor(np.asarray(v), device=dev) for k, v in layer.items()}
                  for layer in self.params]
        with torch.no_grad():
            logits = mlp_apply(params, torch.from_numpy(self._filter_features(X)).to(dev))
            return torch.softmax(logits, dim=-1).cpu().numpy().astype(np.float32)
