"""Reference-pickle interop: load the reference's trained fusion models.

Counterpart of qpp_fusion_rag_tpu/models/interop.py. The reference pickles
``src.models.lightgbm_models.{MultiOutputLGBM,PerRetrieverLGBM}`` holding
``lightgbm.basic.Booster`` objects, and ``src.models.mlp_model.FusionMLP``
holding a torch ``Sequential``. Neither ``src`` nor ``lightgbm`` is
installed, so this module unpickles with shim classes (no reference code is
imported or run) and converts the learned parameters:

- a LightGBM booster pickles its model text (``Booster.__getstate__``);
  its ``Tree=`` sections (split_feature / threshold / left_child /
  right_child / leaf_value; a negative child id ~c is leaf c; a numerical
  split sends ``x <= threshold`` left, as ops/trees.py:_traverse does)
  become node arrays for ``ops.trees.predict_ensemble`` on a torch device.
  Leaf values already include shrinkage: base_score 0, learning_rate 1.
- the torch MLP's ``Linear`` / ``ReLU`` stack becomes (W, b) pairs run as
  a numpy forward + softmax, with the reference's ``qpp_indices`` feature
  filter.

Prediction clips the weights at 0 and normalizes rows to sum 1, as the
reference's models do.
"""

from __future__ import annotations

import io
import pickle
from typing import Dict, List

import numpy as np
import torch

from qpp_fusion_rag_tpu_torch.ops.trees import predict_ensemble, stack_trees


# ---------------------------------------------------------------------------
# Shim unpickling
# ---------------------------------------------------------------------------

class _ShimObject:
    """Bare attribute holder standing in for a reference class."""

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:  # pragma: no cover - reference models use dict state
            self.__dict__["_state"] = state


class _ShimBooster:
    """Stands in for lightgbm.basic.Booster; captures the model text."""

    def __setstate__(self, state):
        self.__dict__.update(state)
        # lightgbm stores the model string under 'handle' (older) or
        # '_handle'/'model_str' (newer); find the tree dump among values
        self.model_str = None
        for v in state.values():
            if isinstance(v, (str, bytes)) and "Tree=0" in str(v):
                self.model_str = v.decode() if isinstance(v, bytes) else v
                break


class _RefUnpickler(pickle.Unpickler):
    """find_class that never imports reference code: src.* and lightgbm
    classes become shims; torch/numpy/collections resolve normally."""

    _SHIMS = {
        ("lightgbm.basic", "Booster"): _ShimBooster,
    }

    def find_class(self, module, name):
        if (module, name) in self._SHIMS:
            return self._SHIMS[(module, name)]
        if module.startswith("src.") or module == "src":
            return type(name, (_ShimObject,), {"__module__": module})
        return super().find_class(module, name)


def _load_envelope(path) -> Dict:
    with open(path, "rb") as f:
        return _RefUnpickler(io.BytesIO(f.read())).load()


# ---------------------------------------------------------------------------
# LightGBM model-text parsing
# ---------------------------------------------------------------------------

def parse_lgbm_model_str(model_str: str) -> List[Dict[str, np.ndarray]]:
    """LightGBM text dump -> list of node-array tree dicts for
    ops.trees.stack_trees. Internal node i keeps index i; leaf j maps to
    flat index num_internal + j; child id c<0 encodes leaf ~c=-(c)-1."""
    trees = []
    cur: Dict[str, str] = {}
    in_tree = False
    for line in model_str.splitlines():
        line = line.strip()
        if line.startswith("Tree="):
            if in_tree:
                trees.append(_finish_tree(cur))
            cur, in_tree = {}, True
            continue
        if in_tree:
            if not line:  # blank line ends a tree section
                trees.append(_finish_tree(cur))
                cur, in_tree = {}, False
            elif "=" in line:
                k, v = line.split("=", 1)
                cur[k] = v
    if in_tree and cur:
        trees.append(_finish_tree(cur))
    if not trees:
        raise ValueError("no Tree= sections found in LightGBM model text")
    return trees


def _finish_tree(sec: Dict[str, str]) -> Dict[str, np.ndarray]:
    num_leaves = int(sec["num_leaves"])
    leaf_value = np.array([float(x) for x in sec["leaf_value"].split()])
    if num_leaves == 1:
        # constant tree: a single self-looping leaf
        return {
            "feature": np.array([-1], np.int32),
            "threshold": np.zeros(1, np.float32),
            "left": np.zeros(1, np.int32),
            "right": np.zeros(1, np.int32),
            "value": leaf_value.astype(np.float32),
            "depth": 1,
        }
    n_int = num_leaves - 1
    split_feature = np.array([int(x) for x in sec["split_feature"].split()])
    threshold = np.array([float(x) for x in sec["threshold"].split()])
    left = np.array([int(x) for x in sec["left_child"].split()])
    right = np.array([int(x) for x in sec["right_child"].split()])
    dt = np.array([int(x) for x in
                   sec.get("decision_type", " ".join(["2"] * n_int)).split()])
    if (dt & 1).any():
        raise ValueError("categorical splits are not supported")

    n = n_int + num_leaves
    feature = np.full(n, -1, np.int32)
    thr = np.zeros(n, np.float32)
    lc = np.arange(n, dtype=np.int32)   # leaves self-loop
    rc = np.arange(n, dtype=np.int32)
    val = np.zeros(n, np.float32)
    feature[:n_int] = split_feature
    thr[:n_int] = threshold
    val[n_int:] = leaf_value

    def flat(c):
        return c if c >= 0 else n_int + (-c - 1)

    for i in range(n_int):
        lc[i] = flat(left[i])
        rc[i] = flat(right[i])

    # exact max depth (fori-loop traversal bound) by DFS from the root
    stack = [(0, 1)]
    max_depth = 1
    while stack:
        node, d = stack.pop()
        max_depth = max(max_depth, d)
        if feature[node] >= 0:
            stack.append((int(lc[node]), d + 1))
            stack.append((int(rc[node]), d + 1))
    return {"feature": feature, "threshold": thr, "left": lc, "right": rc,
            "value": val, "depth": max_depth}


def booster_to_ensemble(model_str: str, device="cuda"):
    """LightGBM text dump -> TreeEnsemble on `device` (leaf values already
    include shrinkage -> lr=1, base=0)."""
    return stack_trees(parse_lgbm_model_str(model_str),
                       base_score=0.0, learning_rate=1.0, device=device)


def _traverse_host(tree: Dict[str, np.ndarray], X: np.ndarray) -> np.ndarray:
    """Independent host-side traversal (test oracle for the device path)."""
    out = np.zeros(len(X))
    for r, x in enumerate(X):
        node = 0
        while tree["feature"][node] >= 0:
            node = (tree["left"][node]
                    if x[tree["feature"][node]] <= tree["threshold"][node]
                    else tree["right"][node])
        out[r] = tree["value"][node]
    return out


# ---------------------------------------------------------------------------
# Loaded-model adapters
# ---------------------------------------------------------------------------

def _normalize_weights(w: np.ndarray) -> np.ndarray:
    """Clip >= 0, then rows to sum 1; all-zero rows stay zero."""
    w = np.clip(w, 0, None)
    s = w.sum(axis=1, keepdims=True)
    s[s == 0] = 1
    return w / s


class ReferenceGBDTFusion:
    """Adapter over reference Per-Retriever / MultiOutput LightGBM models:
    one parsed booster per retriever, inference through ops.trees on the
    ensembles' device."""

    def __init__(self, retrievers: List[str], ensembles, n_qpp: int):
        self.retrievers = retrievers
        self.ensembles = ensembles          # list aligned with retrievers
        self.n_qpp = n_qpp

    def predict(self, X: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.asarray(X, np.float32))
        cols = [predict_ensemble(e, x).cpu().numpy() for e in self.ensembles]
        return _normalize_weights(np.stack(cols, axis=1))


class ReferenceMLPFusion:
    """Adapter over the reference FusionMLP: extracted (W, b) stack run
    as numpy Linear->ReLU with softmax + clip-normalize at the end;
    reproduces the torch forward."""

    def __init__(self, retrievers: List[str], layers, qpp_indices,
                 n_qpp: int):
        self.retrievers = retrievers
        self.layers = layers                # [(W [out,in], b [out]), ...]
        self.qpp_indices = list(qpp_indices)
        self.n_qpp = n_qpp

    def _filter(self, X: np.ndarray) -> np.ndarray:
        """The reference's qpp_indices feature filter."""
        R, used = len(self.retrievers), len(self.qpp_indices)
        out = np.zeros((X.shape[0], R * used), X.dtype)
        for j in range(R):
            for k, qi in enumerate(self.qpp_indices):
                out[:, j * used + k] = X[:, j * self.n_qpp + qi]
        return out

    def predict(self, X: np.ndarray) -> np.ndarray:
        X = np.asarray(X, np.float32)
        if len(self.qpp_indices) < self.n_qpp:
            X = self._filter(X)
        h = X
        for i, (W, b) in enumerate(self.layers):
            h = h @ W.T + b
            if i < len(self.layers) - 1:
                h = np.maximum(h, 0.0)
        e = np.exp(h - h.max(axis=1, keepdims=True))
        return _normalize_weights(e / e.sum(axis=1, keepdims=True))


def load_reference_fusion_model(path, device=None):
    """Unpickle a reference fusion_*.pkl -> a predict(X) -> weights adapter;
    tree ensembles go to `device` (default None: the card). Envelope:
    {'model': <src.models object>, 'retrievers': [...], 'n_qpp': 13,
    'model_type': 'MultiOutputLGBM'|'PerRetrieverLGBM'|'FusionMLP'}."""
    dev = torch.device("cuda" if device is None else device)
    env = _load_envelope(path)
    model = env["model"]
    retrievers = list(env["retrievers"])
    n_qpp = int(env.get("n_qpp") or 13)
    mtype = env.get("model_type") or type(model).__name__

    if mtype in ("MultiOutputLGBM", "PerRetrieverLGBM"):
        models = model.__dict__["models"]
        if isinstance(models, dict):            # per-retriever: name -> B
            boosters = [models[r] for r in retrievers]
        else:                                    # multioutput: ordered list
            boosters = list(models)
        if len(boosters) != len(retrievers):
            raise ValueError(
                f"{mtype}: {len(boosters)} boosters != "
                f"{len(retrievers)} retrievers")
        ens = []
        for b in boosters:
            if getattr(b, "model_str", None) is None:
                raise ValueError("booster pickle carries no model text")
            ens.append(booster_to_ensemble(b.model_str, dev))
        return ReferenceGBDTFusion(retrievers, ens, n_qpp)

    if mtype == "FusionMLP":
        seq = model.__dict__["model"]            # torch Sequential
        layers = []
        for m in seq:
            if isinstance(m, torch.nn.Linear):
                layers.append((m.weight.detach().cpu().numpy(),
                               m.bias.detach().cpu().numpy()))
        if not layers:
            raise ValueError("FusionMLP pickle has no Linear layers")
        qpp_indices = model.__dict__.get("qpp_indices", list(range(n_qpp)))
        return ReferenceMLPFusion(retrievers, layers, qpp_indices, n_qpp)

    raise ValueError(f"unknown reference model_type {mtype!r}")
