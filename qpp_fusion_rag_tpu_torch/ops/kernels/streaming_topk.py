"""K10: the streaming dense group max and the top-k built on it.

Counterpart of qpp_fusion_rag_tpu/ops/pallas/streaming_topk.py
(_streaming_group_max, streaming_dense_topk). The result is K8's at
stride 1 over a corpus padded to a multiple of SUPER docs, and so is the
kernel: the C entry qfr_streaming_group_max (csrc/group_max_scores.cu)
launches K8's TMA + wgmma kernel at stride 1. What makes the TPU kernel
streaming, the corpus leaving device memory once while the queries stay
close, comes from that kernel's persistent grid: the query tiles of one
doc tile run side by side, and the queries stay in L2. Any D whose bf16
rows are a multiple of 16 bytes. The merge is exact (``topk_first``) where
the JAX function takes approx_max_k (which returns lax.top_k's result on
the CPU).
"""

from __future__ import annotations

import torch

from qpp_fusion_rag_tpu_torch.ops.kernels import LAUNCHES, _build
from qpp_fusion_rag_tpu_torch.ops.kernels.dense_topk import (
    GROUP,
    _check_cuda_rows,
    _check_pair,
    _n_real,
    _pad_k,
    group_max_scores_plain,
)
from qpp_fusion_rag_tpu_torch.ops.segment import topk_first

SUPER = 16_384        # the JAX kernel's docs per grid step: N pads to a multiple


def streaming_group_max_plain(q, corpus, n_real: int):
    """K10 with torch ops: K8's plain version at stride 1, tn = SUPER."""
    return group_max_scores_plain(q, corpus, n_real, stride=1, tn=SUPER)


def streaming_group_max(q: torch.Tensor, corpus: torch.Tensor, n_real: int = 0):
    """bf16 q [M, D] x corpus [N, D] -> (vals [M, N_pad/128] f32, ids int32
    global doc ids), N_pad = N rounded up to a multiple of SUPER: per
    128-doc group the max score and its first doc; docs n >= n_real (0:
    every doc is real) and the pad score -inf. CPU tensors take the plain
    version; CUDA tensors launch K10."""
    M, N, D = _check_pair(q, corpus, torch.bfloat16)
    n_real = _n_real(n_real, N)
    if q.device.type == "cpu":
        return streaming_group_max_plain(q, corpus, n_real)
    _check_cuda_rows(2 * D, q, corpus)
    n_groups = -(-N // SUPER) * SUPER // GROUP
    vals = torch.empty((M, n_groups), dtype=torch.float32, device=q.device)
    ids = torch.empty((M, n_groups), dtype=torch.int32, device=q.device)
    if vals.numel() == 0:
        return vals, ids
    lib = _build.load_library()
    with torch.cuda.device(q.device):
        rc = lib.qfr_streaming_group_max(q.data_ptr(), corpus.data_ptr(), M, N, D, n_real,
                                         n_groups, vals.data_ptr(), ids.data_ptr(),
                                         _build.stream_of(q))
    _build.check(lib, rc, "streaming_group_max")
    LAUNCHES["streaming_group_max"] += 1
    return vals, ids


def streaming_dense_topk(queries: torch.Tensor, corpus: torch.Tensor, k: int = 100,
                         row_block: int = 2560):
    """Fused dense top-k through K10 -> (scores [B, k], ids [B, k] int32).
    Queries round to the corpus dtype (bf16); each launch takes row_block
    query rows."""
    if corpus.dtype != torch.bfloat16:
        raise ValueError(f"streaming_dense_topk takes a bf16 corpus, got {corpus.dtype}")
    if row_block < 1:
        raise ValueError(f"row_block={row_block} must be positive")
    q = queries.to(torch.bfloat16).contiguous()
    parts = [streaming_group_max(q[r:r + row_block].contiguous(), corpus)
             for r in range(0, q.shape[0], row_block)]
    vals = torch.cat([v for v, _ in parts])
    ids = torch.cat([i for _, i in parts])
    tv, tx = topk_first(vals, min(k, vals.shape[-1]))
    return _pad_k(tv, torch.gather(ids, -1, tx), k)
