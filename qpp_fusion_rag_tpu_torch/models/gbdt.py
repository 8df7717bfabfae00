"""Gradient-boosted decision trees for learned fusion weights.

Counterpart of qpp_fusion_rag_tpu/models/gbdt.py. The trainer is host
numpy code in both packages and is copied here unchanged (histogram
binning, leaf-wise best-first growth with the gain
GL^2/(nL+lambda) + GR^2/(nR+lambda) - G^2/(n+lambda), MSE objective,
feature and bagging fractions, early stopping), so the same seed and data
grow the same trees. Inference runs as the node-array traversal of
ops.trees on the booster's torch device (default None: the card), or as
the host loop with predict(X, device=False).

Hyperparameters come from config.training.gbdt (LightGBM's names:
num_leaves, learning_rate, feature_fraction, bagging_fraction/freq,
num_boost_round, early_stopping_rounds, max_bin, min_data_in_leaf,
lambda_l2).
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from qpp_fusion_rag_tpu_torch.config import config
from qpp_fusion_rag_tpu_torch.models.base import BaseFusionModel
from qpp_fusion_rag_tpu_torch.ops import trees as T


# =============================================================================
# Histogram binning
# =============================================================================

def make_bins(X: np.ndarray, max_bin: int) -> np.ndarray:
    """Per-feature quantile bin upper edges [F, max_bin-1] (monotone)."""
    F = X.shape[1]
    edges = np.zeros((F, max_bin - 1), dtype=np.float32)
    qs = np.linspace(0, 1, max_bin + 1)[1:-1]
    for f in range(F):
        edges[f] = np.quantile(X[:, f], qs).astype(np.float32)
    return edges


def bin_data(X: np.ndarray, edges: np.ndarray) -> np.ndarray:
    """-> uint16 bin index per (row, feature)."""
    B = np.zeros(X.shape, dtype=np.uint16)
    for f in range(X.shape[1]):
        B[:, f] = np.searchsorted(edges[f], X[:, f], side="left")
    return B


# =============================================================================
# Single-tree leaf-wise growth
# =============================================================================

class _Leaf:
    __slots__ = ("rows", "grad_sum", "depth", "node_id")

    def __init__(self, rows, grad_sum, depth, node_id):
        self.rows, self.grad_sum, self.depth, self.node_id = rows, grad_sum, depth, node_id


def _best_split(
    binned: np.ndarray,       # [n, F] uint16 (already row-subset)
    grad: np.ndarray,         # [n]
    feat_cols: np.ndarray,    # active feature ids
    n_bins: int,
    min_leaf: int,
    lam: float,
) -> Tuple[float, int, int]:
    """-> (gain, feature, bin_threshold) for the best split, gain<=0 if none."""
    n = binned.shape[0]
    G = grad.sum()
    parent = G * G / (n + lam)
    best = (0.0, -1, -1)
    for f in feat_cols:
        b = binned[:, f]
        cnt = np.bincount(b, minlength=n_bins).astype(np.float64)
        gs = np.bincount(b, weights=grad, minlength=n_bins)
        c_cnt = np.cumsum(cnt)[:-1]    # left counts per threshold bin
        c_gs = np.cumsum(gs)[:-1]
        nR = n - c_cnt
        ok = (c_cnt >= min_leaf) & (nR >= min_leaf)
        if not ok.any():
            continue
        with np.errstate(divide="ignore", invalid="ignore"):
            gain = c_gs**2 / (c_cnt + lam) + (G - c_gs) ** 2 / (nR + lam) - parent
        gain = np.where(ok, gain, -np.inf)
        bi = int(np.argmax(gain))
        if gain[bi] > best[0]:
            best = (float(gain[bi]), int(f), bi)
    return best


def grow_tree(
    binned: np.ndarray,        # [N, F] uint16
    grad: np.ndarray,          # [N] residuals
    rows: np.ndarray,          # row subset for this tree (bagging)
    edges: np.ndarray,         # [F, max_bin-1] bin edges (for real thresholds)
    num_leaves: int,
    min_leaf: int,
    lam: float,
    feat_cols: np.ndarray,
    n_bins: int,
) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """Grow one regression tree leaf-wise. Returns (tree arrays, gain per feature)."""
    feature, threshold, left, right, value, depth_arr = [], [], [], [], [], []

    def new_node():
        i = len(feature)
        feature.append(-1)
        threshold.append(0.0)
        left.append(i)
        right.append(i)
        value.append(0.0)
        depth_arr.append(0)
        return i

    importance = np.zeros(edges.shape[0], dtype=np.float64)
    root = new_node()
    heap: list = []
    counter = 0

    def push(leaf: _Leaf):
        nonlocal counter
        if len(leaf.rows) < 2 * min_leaf:
            return
        gain, f, b = _best_split(binned[leaf.rows], grad[leaf.rows], feat_cols, n_bins, min_leaf, lam)
        if gain > 1e-12:
            heapq.heappush(heap, (-gain, counter, leaf, f, b))
            counter += 1

    root_leaf = _Leaf(rows, grad[rows].sum(), 1, root)
    push(root_leaf)
    leaves = [root_leaf]
    max_depth = 1

    while heap and len(leaves) < num_leaves:
        neg_gain, _, leaf, f, b = heapq.heappop(heap)
        mask = binned[leaf.rows, f] <= b
        lrows, rrows = leaf.rows[mask], leaf.rows[~mask]
        if len(lrows) < min_leaf or len(rrows) < min_leaf:
            continue
        importance[f] += -neg_gain
        li, ri = new_node(), new_node()
        nid = leaf.node_id
        feature[nid] = int(f)
        threshold[nid] = float(edges[f, min(b, edges.shape[1] - 1)])
        left[nid], right[nid] = li, ri
        lleaf = _Leaf(lrows, grad[lrows].sum(), leaf.depth + 1, li)
        rleaf = _Leaf(rrows, grad[rrows].sum(), leaf.depth + 1, ri)
        max_depth = max(max_depth, leaf.depth + 1)
        leaves.remove(leaf)
        leaves += [lleaf, rleaf]
        push(lleaf)
        push(rleaf)

    for leaf in leaves:
        value[leaf.node_id] = float(leaf.grad_sum / (len(leaf.rows) + lam))

    tree = {
        "feature": np.asarray(feature, dtype=np.int32),
        "threshold": np.asarray(threshold, dtype=np.float32),
        "left": np.asarray(left, dtype=np.int32),
        "right": np.asarray(right, dtype=np.int32),
        "value": np.asarray(value, dtype=np.float32),
        "depth": max_depth,
    }
    return tree, importance


def _predict_tree_host(tree: Dict[str, np.ndarray], X: np.ndarray) -> np.ndarray:
    node = np.zeros(X.shape[0], dtype=np.int64)
    for _ in range(tree["depth"] + 1):
        f = tree["feature"][node]
        is_leaf = f < 0
        xv = X[np.arange(X.shape[0]), np.maximum(f, 0)]
        nxt = np.where(xv <= tree["threshold"][node], tree["left"][node], tree["right"][node])
        node = np.where(is_leaf, node, nxt)
    return tree["value"][node]


# =============================================================================
# Booster (one output)
# =============================================================================

class Booster:
    """Single-output gradient-boosted regressor (MSE objective)."""

    def __init__(self, params: Optional[Dict] = None, seed: int = 0, device=None):
        p = dict(config.training.gbdt.to_dict())
        p.update(params or {})
        self.p = p
        self._user_min_leaf = "min_data_in_leaf" in (params or {})
        self.seed = seed
        self.device = device
        self.trees: List[Dict[str, np.ndarray]] = []
        self.base_score = 0.0
        self.importance: Optional[np.ndarray] = None
        self._ensemble: Optional[T.TreeEnsemble] = None

    def fit(
        self,
        X: np.ndarray,
        y: np.ndarray,
        X_val: Optional[np.ndarray] = None,
        y_val: Optional[np.ndarray] = None,
    ) -> Dict:
        p = self.p
        # refitting replaces the model: stale trees would otherwise be
        # summed with the new ones while training residuals assume a
        # fresh base_score start
        self.trees = []
        self._ensemble = None
        rng = np.random.default_rng(self.seed)
        X = np.asarray(X, dtype=np.float32)
        y = np.asarray(y, dtype=np.float64)
        n, F = X.shape
        n_bins = int(p["max_bin"])
        edges = make_bins(X, n_bins)
        binned = bin_data(X, edges)

        self.base_score = float(y.mean()) if n else 0.0
        pred = np.full(n, self.base_score)
        has_val = X_val is not None and len(X_val) > 0 and y_val is not None
        if has_val:
            val_pred = np.full(len(X_val), self.base_score)
        lr = float(p["learning_rate"])
        best_val, best_ntrees, bad = np.inf, 0, 0
        # LightGBM-style floor, auto-relaxed on tiny datasets UNLESS the
        # caller set it explicitly (a split needs 2*min_leaf rows; with e.g.
        # 36 training queries the default of 20 would make every tree a
        # stump and learned fusion degenerate)
        min_leaf = int(p["min_data_in_leaf"])
        if not self._user_min_leaf:
            min_leaf = min(min_leaf, max(1, n // 8))
        lam = float(p["lambda_l2"])
        per_tree_importance: List[np.ndarray] = []
        history = {"train_mse": [], "val_mse": []}

        bag_rows: Optional[np.ndarray] = None
        for it in range(int(p["num_boost_round"])):
            grad = y - pred
            k_feat = max(1, int(round(float(p["feature_fraction"]) * F)))
            feat_cols = np.sort(rng.choice(F, size=k_feat, replace=False))
            if float(p["bagging_fraction"]) < 1.0 and int(p["bagging_freq"]) > 0:
                # LightGBM semantics: re-draw the bag every bagging_freq
                # iterations, reuse it in between
                if bag_rows is None or it % int(p["bagging_freq"]) == 0:
                    m = max(2 * min_leaf, int(round(float(p["bagging_fraction"]) * n)))
                    bag_rows = np.sort(rng.choice(n, size=min(m, n), replace=False))
                rows = bag_rows
            else:
                rows = np.arange(n)
            tree, imp = grow_tree(
                binned, grad, rows, edges,
                int(p["num_leaves"]), min_leaf, lam, feat_cols, n_bins,
            )
            self.trees.append(tree)
            per_tree_importance.append(imp)
            pred += lr * _predict_tree_host(tree, X)
            history["train_mse"].append(float(np.mean((y - pred) ** 2)))
            if has_val:
                val_pred += lr * _predict_tree_host(tree, np.asarray(X_val, np.float32))
                vm = float(np.mean((np.asarray(y_val, np.float64) - val_pred) ** 2))
                history["val_mse"].append(vm)
                if vm < best_val - 1e-9:
                    best_val, best_ntrees, bad = vm, len(self.trees), 0
                else:
                    bad += 1
                    if bad >= int(p["early_stopping_rounds"]):
                        break
        # keep the best-validation prefix even when the round budget (not
        # the patience counter) ended training mid-streak — otherwise the
        # returned model and best_val_mse would disagree
        if has_val and 0 < best_ntrees < len(self.trees):
            self.trees = self.trees[:best_ntrees]
        # importance only from trees kept after early stopping
        kept = per_tree_importance[: len(self.trees)]
        self.importance = (
            np.sum(kept, axis=0) if kept else np.zeros(F, dtype=np.float64)
        )
        self._ensemble = None
        return {
            "n_trees": len(self.trees),
            "best_val_mse": best_val if has_val else None,
            "history": history,
        }

    # -- inference -----------------------------------------------------
    def ensemble(self) -> T.TreeEnsemble:
        if self._ensemble is None:
            if not self.trees:
                raise RuntimeError("Booster has no trees")
            self._ensemble = T.stack_trees(
                self.trees, self.base_score, float(self.p["learning_rate"]),
                device=torch.device("cuda" if self.device is None else self.device),
            )
        return self._ensemble

    def predict(self, X: np.ndarray, device: bool = True) -> np.ndarray:
        """device=True: the ops.trees traversal on the booster's torch
        device (f32); device=False: the host loop (float64)."""
        X = np.asarray(X, dtype=np.float32)
        if device and self.trees:
            return T.predict_ensemble(self.ensemble(), torch.from_numpy(X)).cpu().numpy()
        pred = np.full(X.shape[0], self.base_score)
        lr = float(self.p["learning_rate"])
        for tree in self.trees:
            pred += lr * _predict_tree_host(tree, X)
        return pred

    def __getstate__(self):
        state = dict(self.__dict__)
        state["_ensemble"] = None  # no device tensors in a pickle
        return state


# =============================================================================
# Fusion-model wrappers (reference class surface)
# =============================================================================

class PerRetrieverGBDT(BaseFusionModel):
    """One independent booster per retriever output
    (reference PerRetrieverLGBM, src/models/lightgbm_models.py:23-123)."""

    def __init__(self, retrievers: List[str], n_qpp: Optional[int] = None,
                 params: Optional[Dict] = None, seed: int = 0, device=None):
        super().__init__(retrievers, n_qpp)
        self.boosters = [Booster(params, seed=seed + i, device=device)
                         for i in range(self.n_retrievers)]

    def train(self, X_train, Y_train, X_val=None, Y_val=None) -> Dict:
        info = {}
        for i, booster in enumerate(self.boosters):
            info[self.retrievers[i]] = booster.fit(
                X_train, Y_train[:, i],
                X_val, Y_val[:, i] if Y_val is not None else None,
            )
        self.is_trained = True
        return info

    def predict(self, X: np.ndarray) -> np.ndarray:
        cols = [b.predict(X) for b in self.boosters]
        return self._normalize_weights(np.stack(cols, axis=1).astype(np.float32))

    @property
    def feature_importance(self) -> np.ndarray:
        return np.stack([b.importance for b in self.boosters]).mean(axis=0)


class MultiOutputGBDT(PerRetrieverGBDT):
    """Shared-hyperparameter joint training loop with averaged feature
    importance (reference MultiOutputLGBM, src/models/lightgbm_models.py:
    126-241). Training is per-output under the hood (as in the reference),
    with one early-stopping decision per output; the class differs from
    PerRetrieverGBDT in sharing one param set + seed and reporting the
    averaged importance as the model's importance."""

    def __init__(self, retrievers: List[str], n_qpp: Optional[int] = None,
                 params: Optional[Dict] = None, seed: int = 0, device=None):
        BaseFusionModel.__init__(self, retrievers, n_qpp)
        self.boosters = [Booster(params, seed=seed, device=device)
                         for _ in range(self.n_retrievers)]
