"""Index layer of the port: the native builder binding and the sparse
index (counterpart of qpp_fusion_rag_tpu/index/). Importing it builds and
loads nothing: the native library is compiled on the first
NativeIndexBuilder."""

from qpp_fusion_rag_tpu_torch.index.native import NativeIndexBuilder
from qpp_fusion_rag_tpu_torch.index.sparse import SparseIndex

__all__ = ["NativeIndexBuilder", "SparseIndex"]
