"""Tree-ensemble inference as node-array traversal on the device.

Counterpart of qpp_fusion_rag_tpu/ops/trees.py. Trees become flat node
arrays and prediction is `max_depth` rounds of gathers: every (row, tree)
pair walks one step a round, and leaves point to themselves, so the
fixed-depth loop is exact. Plain tensor ops; no kernel.

Node-array layout per ensemble (T trees padded to N nodes each):
    feature   int32 [T, N]    split feature (-1 at leaves)
    threshold f32   [T, N]    go left iff x[f] <= threshold
    children  int32 [T, N, 2] (left, right); leaves point to themselves
    value     f32   [T, N]    leaf value (0 on internal nodes)
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class TreeEnsemble(NamedTuple):
    feature: torch.Tensor    # int32 [T, N]
    threshold: torch.Tensor  # f32   [T, N]
    children: torch.Tensor   # int32 [T, N, 2]
    value: torch.Tensor      # f32   [T, N]
    max_depth: int           # traversal rounds
    base_score: float        # F0 (mean of targets)
    learning_rate: float     # shrinkage applied per tree at predict


def _traverse(x: torch.Tensor, feature: torch.Tensor, threshold: torch.Tensor,
              children: torch.Tensor, value: torch.Tensor, max_depth: int) -> torch.Tensor:
    """x [B, F] -> per-tree leaf values [B, T]."""
    B = x.shape[0]
    T, N = feature.shape
    tree_off = (torch.arange(T, device=x.device) * N)[None, :]      # [1, T]
    f_flat = feature.reshape(-1).long()
    t_flat = threshold.reshape(-1)
    l_flat = children[..., 0].reshape(-1).long()
    r_flat = children[..., 1].reshape(-1).long()
    node = torch.zeros((B, T), dtype=torch.int64, device=x.device)
    for _ in range(max_depth):
        idx = node + tree_off
        f = f_flat[idx]
        go_left = torch.gather(x, 1, f.clamp_min(0)) <= t_flat[idx]
        nxt = torch.where(go_left, l_flat[idx], r_flat[idx])
        node = torch.where(f < 0, node, nxt)                          # leaves stay put
    return value.reshape(-1)[node + tree_off]


def predict_ensemble(ens: TreeEnsemble, x: torch.Tensor) -> torch.Tensor:
    """x [B, F] (a tensor or an array; it goes to the ensemble's device)
    -> [B] boosted predictions: base + lr * sum_t leaf_t(x)."""
    x = torch.as_tensor(x, device=ens.feature.device).to(torch.float32)
    leaves = _traverse(x, ens.feature, ens.threshold, ens.children, ens.value,
                       ens.max_depth)
    return ens.base_score + ens.learning_rate * leaves.sum(-1)


def stack_trees(trees, base_score: float, learning_rate: float,
                device="cuda") -> TreeEnsemble:
    """Pack host tree dicts (numpy feature / threshold / left / right /
    value of one length per tree, and depth; models.gbdt.grow_tree) into
    padded node arrays on `device`. Padding nodes are self-looping leaves
    of value 0."""
    T = len(trees)
    N = max((len(t["feature"]) for t in trees), default=1)
    feature = np.full((T, N), -1, dtype=np.int32)
    threshold = np.zeros((T, N), dtype=np.float32)
    children = np.zeros((T, N, 2), dtype=np.int32)
    value = np.zeros((T, N), dtype=np.float32)
    max_depth = 1
    for ti, t in enumerate(trees):
        n = len(t["feature"])
        feature[ti, :n] = t["feature"]
        threshold[ti, :n] = t["threshold"]
        children[ti, :n, 0] = t["left"]
        children[ti, :n, 1] = t["right"]
        value[ti, :n] = t["value"]
        max_depth = max(max_depth, int(t["depth"]))
        for j in range(n, N):
            children[ti, j] = (j, j)
    return TreeEnsemble(
        feature=torch.from_numpy(feature).to(device),
        threshold=torch.from_numpy(threshold).to(device),
        children=torch.from_numpy(children).to(device),
        value=torch.from_numpy(value).to(device),
        max_depth=max_depth,
        base_score=float(base_score),
        learning_rate=float(learning_rate),
    )
