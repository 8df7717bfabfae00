"""The "sort" engine's run totals and their top-k (csrc/run_sums_topk.cu).

run_sums_topk(sids, svals, k) is segmented_topk_presorted(sids, svals, k)
(ops/segment.py: each run's f32 total over id-sorted pairs, the differences
of one blocked cumsum of the row, then the exact top-k) in one launch,
returned as (scores, ids). It replaces no TPU kernel: the JAX package's
"sort" engine is plain XLA. On an H100 the torch route took ~118 small
kernels a view (the blocked cumsum, two cummax, a full-row stable sort to
keep k), 12.4 ms of a 24.9 ms ensemble step; its bound is 8 B a pair read
and 12 B a winner, 0.0805 ms at 1024 x 32,768 and k 100. The kernel takes
one CTA a row: the values staged in shared memory (rows of up to 49,152
pairs; wider ones are read from L2 in each pass), the blocked cumsum in
XLA-CPU's association as a tree of block totals, a block-wide scan for each
run's predecessor, the totals written in place, then the dense merge's
selection (csrc/row_select.cuh) over them. Its bits are the torch route's.

CPU tensors take segmented_topk_presorted; CUDA tensors launch the kernel
at any width and k up to MAX_K, and a larger k is refused.
"""

from __future__ import annotations

import torch

from qpp_fusion_rag_tpu_torch.ops.kernels import LAUNCHES, _build
from qpp_fusion_rag_tpu_torch.ops.kernels.row_topk import MAX_K  # row_select.cuh's kMaxK
from qpp_fusion_rag_tpu_torch.ops.segment import segmented_topk_presorted


def _check(sids: torch.Tensor, svals: torch.Tensor, k: int) -> None:
    if sids.dtype != torch.int32 or sids.dim() != 2 or not sids.is_contiguous():
        raise ValueError(f"sids must be a contiguous [B, M] int32 tensor, got "
                         f"{sids.dtype} {tuple(sids.shape)}")
    if svals.dtype != torch.float32 or svals.shape != sids.shape or not svals.is_contiguous():
        raise ValueError(f"svals must be a contiguous float32 tensor of sids' shape "
                         f"{tuple(sids.shape)}, got {svals.dtype} {tuple(svals.shape)}")
    if sids.device != svals.device or sids.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported devices {sids.device}, {svals.device}")
    if k < 0:
        raise ValueError(f"k={k} must be >= 0")
    if sids.device.type == "cuda" and min(k, sids.shape[1]) > MAX_K:
        raise ValueError(f"k={k} is above the run sums kernel's {MAX_K}")


def run_sums_topk(sids: torch.Tensor, svals: torch.Tensor, k: int):
    """-> (scores [B, kk] f32 descending, ids [B, kk] int32; -inf / -1
    pad), kk = min(k, M): the k best run totals of the pairs (sids [B, M]
    int32 ascending, SENTINEL last; svals [B, M] f32), ties to the lowest
    id, as segmented_topk_presorted's (sums, ids). CPU tensors take it;
    CUDA tensors launch the kernel."""
    _check(sids, svals, k)
    B, M = sids.shape
    kk = min(k, M)
    if sids.device.type == "cpu":
        ids, scores, _ = segmented_topk_presorted(sids, svals, kk)
        return scores, ids
    scores = torch.empty((B, kk), dtype=torch.float32, device=sids.device)
    ids = torch.empty((B, kk), dtype=torch.int32, device=sids.device)
    if B == 0 or kk == 0:
        return scores, ids
    lib = _build.load_library()
    per_row = lib.qfr_run_sums_scratch(M)
    scratch = (torch.empty(B * per_row, dtype=torch.float32, device=sids.device)
               if per_row else None)
    vec = int(M % 4 == 0 and sids.data_ptr() % 16 == 0 and svals.data_ptr() % 16 == 0)
    with torch.cuda.device(sids.device):
        rc = lib.qfr_run_sums_topk(sids.data_ptr(), svals.data_ptr(), B, M, kk, vec,
                                   None if scratch is None else scratch.data_ptr(),
                                   scores.data_ptr(), ids.data_ptr(), _build.stream_of(sids))
    _build.check(lib, rc, "run_sums_topk")
    LAUNCHES["run_sums_topk"] += 1
    return scores, ids
