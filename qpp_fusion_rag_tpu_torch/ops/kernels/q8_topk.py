"""The top-k of the q8 run sums (csrc/q8_topk.cu).

q8_topk(sums, sids, wmax_col, k, tq) is q8_topk_plain(sums, sids, wmax_col,
k), the selection of ops/sparse.py:sparse_score_topk_q8 (topk_first over
where(sums >= 0, sums * wmax, -inf), the ids gathered from sids, -inf / -1
where the score is not finite), in one launch. The kernel selects on the
integers: for integers a < b < 2^22 and a positive normal wmax (the scorer
clamps it to at least 1e-30), b·wmax - a·wmax >= wmax while each product's
rounding error is below 2^-2·wmax, so the integer order is the score order
and equal sums give equal scores. A q8 run sum of tq query terms is at most
tq·255: up to NARROW_TQ terms (tq·255 < 2^15) the kernel stages the row as
16-bit keys, up to MAX_TQ (tq·255 < 2^22) it reads 32-bit keys from global
memory, and on the card a larger tq is refused. It replaces no TPU kernel:
the JAX package leaves its lax.top_k to XLA. On an H100 the torch route was
~21 kernels a view (a stable full-row radix sort to keep k); the kernel
reads each sum once: 4 B a sum and 12 B a winner, 0.0805 ms at 1024 x
65,536 and k 100.

CPU tensors take q8_topk_plain at any k and tq; CUDA tensors launch the
kernel at any width (rows over 98,304 sums are read again from L2 on each
pass instead of staged), k up to MAX_K and tq up to MAX_TQ, and a larger k
or tq is refused.
"""

from __future__ import annotations

import torch

from qpp_fusion_rag_tpu_torch.ops.kernels import LAUNCHES, _build
from qpp_fusion_rag_tpu_torch.ops.kernels.row_topk import MAX_K  # row_select.cuh's kMaxK
from qpp_fusion_rag_tpu_torch.ops.segment import topk_first

NARROW_TQ = ((1 << 15) - 1) // 255   # 128: the most query terms whose sums stay below 2^15
MAX_TQ = ((1 << 22) - 1) // 255      # 16,448: the most whose sums stay below 2^22


def q8_topk_plain(sums: torch.Tensor, sids: torch.Tensor, wmax_col: torch.Tensor, k: int):
    """-> (scores [B, k] f32 descending, ids [B, k]; -inf / -1 pad): the k
    best run sums (sums [B, M] int32, -1 off runs) as sums · wmax_col, ties
    to the lowest column first (topk_first), their ids from sids."""
    scores = torch.where(sums >= 0, sums.to(torch.float32) * wmax_col, float("-inf"))
    top_vals, top_idx = topk_first(scores, k)
    top_ids = torch.gather(sids, -1, top_idx)
    ok = torch.isfinite(top_vals)
    return (torch.where(ok, top_vals, float("-inf")), torch.where(ok, top_ids, -1))


def _check(sums, sids, wmax_col, k: int, tq: int) -> None:
    if sums.dtype != torch.int32 or sums.dim() != 2 or not sums.is_contiguous():
        raise ValueError(f"sums must be a contiguous [B, M] int32 tensor, got "
                         f"{sums.dtype} {tuple(sums.shape)}")
    if sids.dtype != torch.int32 or sids.shape != sums.shape or not sids.is_contiguous():
        raise ValueError(f"sids must be a contiguous int32 tensor of sums' shape "
                         f"{tuple(sums.shape)}, got {sids.dtype} {tuple(sids.shape)}")
    if (wmax_col.dtype != torch.float32 or wmax_col.shape != (sums.shape[0], 1)
            or not wmax_col.is_contiguous()):
        raise ValueError(f"wmax_col must be a contiguous [{sums.shape[0]}, 1] float32 tensor, "
                         f"got {wmax_col.dtype} {tuple(wmax_col.shape)}")
    devices = {sums.device, sids.device, wmax_col.device}
    if len(devices) != 1 or sums.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported devices {sums.device}, {sids.device}, {wmax_col.device}")
    if k < 0:
        raise ValueError(f"k={k} must be >= 0")
    if tq < 0:
        raise ValueError(f"tq={tq} must be >= 0")
    if sums.device.type == "cuda" and tq > MAX_TQ:
        raise ValueError(f"tq={tq} query terms: the run sums need not stay below 2^22, "
                         f"where the q8 top-k kernel orders them as their scores "
                         f"(tq <= {MAX_TQ})")
    if sums.device.type == "cuda" and min(k, sums.shape[1]) > MAX_K:
        raise ValueError(f"k={k} is above the q8 top-k kernel's {MAX_K}")


def q8_topk(sums: torch.Tensor, sids: torch.Tensor, wmax_col: torch.Tensor, k: int, tq: int):
    """-> (scores [B, kk] f32 descending, ids [B, kk] int32; -inf / -1 pad),
    kk = min(k, M): q8_topk_plain's answer for run sums of tq query terms
    (sums [B, M] int32, -1 off runs; sids [B, M] int32; wmax_col [B, 1] f32
    >= 1e-30). CPU tensors take q8_topk_plain; CUDA tensors launch the
    kernel, on 32-bit keys where tq > NARROW_TQ."""
    _check(sums, sids, wmax_col, k, tq)
    B, M = sums.shape
    kk = min(k, M)
    if sums.device.type == "cpu":
        return q8_topk_plain(sums, sids, wmax_col, kk)
    scores = torch.empty((B, kk), dtype=torch.float32, device=sums.device)
    ids = torch.empty((B, kk), dtype=torch.int32, device=sums.device)
    if B == 0 or kk == 0:
        return scores, ids
    vec = int(M % 4 == 0 and sums.data_ptr() % 16 == 0)
    lib = _build.load_library()
    with torch.cuda.device(sums.device):
        rc = lib.qfr_q8_topk(sums.data_ptr(), sids.data_ptr(), wmax_col.data_ptr(), B, M, kk,
                             vec, int(tq > NARROW_TQ), scores.data_ptr(), ids.data_ptr(),
                             _build.stream_of(sums))
    _build.check(lib, rc, "q8_topk")
    LAUNCHES["q8_topk"] += 1
    return scores, ids
