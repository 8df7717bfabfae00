"""Device operators of the port (PyTorch), mirroring qpp_fusion_rag_tpu.ops.

  dense    -- chunked matmul top-k, multi-view variant
  sparse   -- impact-list scoring (windowed reads + segmented top-k)
  segment  -- the segmented-aggregation primitive
  fusion   -- CombSUM / CombMNZ / RRF (+ weighted) fusion
  qpp      -- the 13 QPP statistics as one reduction
  graphs   -- CUDA graphs that replay the QPP and fusion kernels on a card
  metrics  -- IR metrics (nDCG / RR / R / P / AP) as batched reductions
  trees    -- GBDT ensembles as node-array traversal
  kernels/ -- the hand-written CUDA kernels and their plain versions

The re-exports are JAX's.
"""

from qpp_fusion_rag_tpu_torch.ops.dense import dense_topk, merge_topk, multi_view_topk
from qpp_fusion_rag_tpu_torch.ops.fusion import fuse, fuse_kernel
from qpp_fusion_rag_tpu_torch.ops.metrics import (
    aggregate_measures,
    align_relevance,
    compute_measures,
)
from qpp_fusion_rag_tpu_torch.ops.qpp import normalize_qpp, qpp_kernel, text_features_batch
from qpp_fusion_rag_tpu_torch.ops.segment import segmented_topk
from qpp_fusion_rag_tpu_torch.ops.sparse import sparse_rescore_topk, sparse_score_topk
from qpp_fusion_rag_tpu_torch.ops.trees import TreeEnsemble, predict_ensemble, stack_trees

__all__ = [
    "dense_topk", "multi_view_topk", "merge_topk",
    "fuse", "fuse_kernel",
    "align_relevance", "compute_measures", "aggregate_measures",
    "qpp_kernel", "normalize_qpp", "text_features_batch",
    "segmented_topk", "sparse_score_topk", "sparse_rescore_topk",
    "TreeEnsemble", "predict_ensemble", "stack_trees",
]
