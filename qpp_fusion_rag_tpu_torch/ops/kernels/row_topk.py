"""The exact row top-k of the dense merge (csrc/row_topk.cu).

row_topk(x, k) is topk_first(x, k) (ops/segment.py: the k largest of each
f32 row, descending, ties to the lowest column first) in one launch: a CTA
a row thresholds the row and sorts only the few hundred values above the
threshold. Rows of at most 53,248 columns are staged in shared memory,
wider ones read again from L2 on each pass. It replaces no TPU kernel; the
JAX package merges with lax.top_k, which XLA lowers by itself.

CPU tensors take topk_first, the kernel's plain version. On the card the
kernel takes every width and k up to MAX_K; a larger k is refused.
"""

from __future__ import annotations

import torch

from qpp_fusion_rag_tpu_torch.ops.kernels import LAUNCHES, _build
from qpp_fusion_rag_tpu_torch.ops.segment import topk_first

MAX_K = 2048          # csrc/row_topk.cu kMaxK: the largest k the kernel takes


def _check(x: torch.Tensor, k: int) -> None:
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous [M, G] float32 tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    if k < 0:
        raise ValueError(f"k={k} must be >= 0")
    if x.device.type == "cuda" and min(k, x.shape[1]) > MAX_K:
        raise ValueError(f"k={k} is above the row top-k kernel's {MAX_K}")


def row_topk(x: torch.Tensor, k: int):
    """-> (values [M, min(k, G)] f32, columns [M, min(k, G)] int64): the k
    largest of each row of x [M, G], descending, ties to the lowest column
    first, as topk_first(x, k). CPU tensors take topk_first; CUDA tensors
    launch the kernel."""
    _check(x, k)
    M, G = x.shape
    kk = min(k, G)
    if x.device.type == "cpu":
        return topk_first(x, kk)
    vals = torch.empty((M, kk), dtype=torch.float32, device=x.device)
    cols = torch.empty((M, kk), dtype=torch.int64, device=x.device)
    if M == 0 or kk == 0:
        return vals, cols
    vec = int(G % 4 == 0 and x.data_ptr() % 16 == 0)
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        rc = lib.qfr_row_topk(x.data_ptr(), M, G, kk, vec, vals.data_ptr(), cols.data_ptr(),
                              _build.stream_of(x))
    _build.check(lib, rc, "row_topk")
    LAUNCHES["row_topk"] += 1
    return vals, cols
