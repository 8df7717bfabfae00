"""K1: int8 dense scoring fused with the packed 128-doc group max
(csrc/dense_topk_int8.cu), and the dense top-k built on it.

Counterpart of qpp_fusion_rag_tpu/ops/pallas/dense_topk.py
(group_max_packed_int8, pallas_dense_topk_int8, quantize_rows,
unpack_lane). The corpus is row-major [N, D] int8 — the one layout that
serves both this kernel and the rerank gather — where the TPU kernel reads
a [D, N] copy. The merge is exact (``topk_first``) where the TPU path used
approx_max_k.
"""

from __future__ import annotations

import torch

from qpp_fusion_rag_tpu_torch.ops.kernels import LAUNCHES, _build
from qpp_fusion_rag_tpu_torch.ops.segment import topk_first

GROUP = 128          # docs per emitted candidate
NEG_FINITE = -3.0e38  # pad-doc score: finite, so lane bits never make a NaN
PLAIN_CHUNK = 131_072  # docs per plain-version matmul (bounds its memory)


def quantize_rows(x: torch.Tensor, axis: int = -1):
    """Symmetric per-row int8 quantization -> (int8 values, f32 scales with
    the reduced axis kept). scale = max|x| / 127, taken as max|x| times the
    f32 reciprocal of 127 — what XLA compiles the reference's division by
    the constant into — so the scales match the jitted reference bit for
    bit. Zero rows get scale 1."""
    amax = x.abs().amax(dim=axis, keepdim=True)
    scale = torch.where(amax > 0, amax * (1.0 / 127.0), 1.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def unpack_lane(v: torch.Tensor):
    """Packed f32 -> (clean f32 score, lane int32)."""
    bits = v.view(torch.int32)
    return (bits & ~0x7F).view(torch.float32), bits & 0x7F


def _check(q_int, corpus_rows, d_scale, n_real):
    if q_int.dtype != torch.int8 or q_int.dim() != 2 or not q_int.is_contiguous():
        raise ValueError(f"q_int must be a contiguous [M, D] int8 tensor, got "
                         f"{q_int.dtype} {tuple(q_int.shape)}")
    if (corpus_rows.dtype != torch.int8 or corpus_rows.dim() != 2
            or not corpus_rows.is_contiguous()):
        raise ValueError(f"corpus_rows must be a contiguous [N, D] int8 tensor, "
                         f"got {corpus_rows.dtype} {tuple(corpus_rows.shape)}")
    N, D = corpus_rows.shape
    if q_int.shape[1] != D:
        raise ValueError(f"q_int has D={q_int.shape[1]}, corpus_rows D={D}")
    if (d_scale.dtype != torch.float32 or tuple(d_scale.shape) != (N,)
            or not d_scale.is_contiguous()):
        raise ValueError(f"d_scale must be a contiguous [{N}] float32 tensor, "
                         f"got {d_scale.dtype} {tuple(d_scale.shape)}")
    if not (q_int.device == corpus_rows.device == d_scale.device):
        raise ValueError("q_int, corpus_rows and d_scale must share a device")
    if not 0 <= n_real <= N:
        raise ValueError(f"n_real={n_real} must be in [0, {N}]")
    # the plain version's f32 product is exact only while |dot| < 2^24
    if D * 127 * 127 >= 1 << 24:
        raise ValueError(f"D={D}: int8 dots need D*127^2 < 2^24 (D <= 1040)")


def group_max_packed_int8_plain(q_int, corpus_rows, d_scale, n_real: int):
    """The same packed group maxima with torch ops: an f32 matmul of the
    int8 values (exact: |dot| <= D*127^2 < 2^24), the same epilogue,
    chunked over docs."""
    M = q_int.shape[0]
    N = corpus_rows.shape[0]
    G = -(-N // GROUP)
    out = torch.empty((M, G), dtype=torch.float32, device=q_int.device)
    qf = q_int.to(torch.float32)
    for n0 in range(0, N, PLAIN_CHUNK):
        n1 = min(N, n0 + PLAIN_CHUNK)
        s = (qf @ corpus_rows[n0:n1].to(torch.float32).T) * d_scale[n0:n1]
        col = torch.arange(n0, n1, device=q_int.device, dtype=torch.int32)
        s = torch.where(col < n_real, s, NEG_FINITE)
        bits = (s.view(torch.int32) & ~0x7F) | (col & 0x7F)
        packed = bits.view(torch.float32)
        ragged = (-(n1 - n0)) % GROUP   # only in the last chunk
        if ragged:
            packed = torch.nn.functional.pad(packed, (0, ragged), value=float("-inf"))
        out[:, n0 // GROUP:-(-n1 // GROUP)] = packed.reshape(M, -1, GROUP).amax(-1)
    return out


def group_max_packed_int8(q_int: torch.Tensor, corpus_rows: torch.Tensor,
                          d_scale: torch.Tensor, n_real: int = None) -> torch.Tensor:
    """-> packed group maxima [M, ceil(N/128)] f32: per 128-doc group, the
    max of float(int8 dot) * d_scale[n] with the doc's lane (n & 127) in the
    low 7 mantissa bits; docs n >= n_real (default N) score -3e38.
    CPU tensors take the plain version; CUDA tensors launch K1."""
    N = corpus_rows.shape[0] if corpus_rows.dim() == 2 else 0
    n_real = N if n_real is None else int(n_real)
    _check(q_int, corpus_rows, d_scale, n_real)
    if q_int.device.type == "cpu":
        return group_max_packed_int8_plain(q_int, corpus_rows, d_scale, n_real)
    if q_int.device.type != "cuda":
        raise ValueError(f"unsupported device {q_int.device}")
    M, D = q_int.shape
    if D % 16 or q_int.data_ptr() % 16 or corpus_rows.data_ptr() % 16:
        raise ValueError(f"the kernel loads 16-byte rows: D={D} must be a "
                         "multiple of 16 and both operands 16-byte aligned")
    out = torch.empty((M, -(-N // GROUP)), dtype=torch.float32, device=q_int.device)
    if out.numel() == 0:
        return out
    lib = _build.load_library()
    with torch.cuda.device(q_int.device):
        rc = lib.qfr_group_max_packed_int8(
            q_int.data_ptr(), corpus_rows.data_ptr(), d_scale.data_ptr(),
            M, N, D, n_real, out.data_ptr(), _build.stream_of(q_int))
    _build.check(lib, rc, "group_max_packed_int8")
    LAUNCHES["group_max_packed_int8"] += 1
    return out


def dense_topk_int8(queries: torch.Tensor, corpus_rows: torch.Tensor,
                    d_scale: torch.Tensor, k: int = 100):
    """Quantized fused dense top-k -> (scores [B, k], ids [B, k] int32).

    Queries quantize per row; the kernel's packed group maxima go through
    an exact top-k with lax.top_k's tie order; the per-query scale
    multiplies only the k winners (a positive row factor never reorders a
    row). Counterpart of pallas_dense_topk_int8(exact_merge=True)."""
    q_int, q_scale = quantize_rows(queries.to(torch.float32))
    vals = group_max_packed_int8(q_int, corpus_rows, d_scale)
    kk = min(k, vals.shape[-1])
    tv, tx = topk_first(vals, kk)
    clean, lane = unpack_lane(tv)
    top_ids = tx.to(torch.int32) * GROUP + lane
    top_vals = torch.where(clean > NEG_FINITE / 2, clean * q_scale, float("-inf"))
    if kk < k:
        top_vals = torch.nn.functional.pad(top_vals, (0, k - kk), value=float("-inf"))
        top_ids = torch.nn.functional.pad(top_ids, (0, k - kk), value=-1)
    return top_vals, torch.where(torch.isfinite(top_vals), top_ids, -1)
