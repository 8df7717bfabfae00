"""K6: fused doc-vector row gather + query-term match (csrc/rescore_match.cu).

Counterpart of qpp_fusion_rag_tpu/ops/pallas/row_gather.py
rescore_match_pallas, same contract: unscaled rescore sums per candidate,
ids clamped into the table here, doc_scale and the -1 mask left to the
caller. The TPU's rules (Td fixed at 128, C % 8, B*C % 128, chunked calls)
do not apply.
"""

from __future__ import annotations

import torch

from qpp_fusion_rag_tpu_torch.ops.kernels import LAUNCHES, _build


def _check(doc_packed, cand_ids, q_terms, q_weights, imp_bits: int) -> None:
    for name, t, dtype in (("doc_packed", doc_packed, torch.int32),
                           ("cand_ids", cand_ids, torch.int32),
                           ("q_terms", q_terms, torch.int32),
                           ("q_weights", q_weights, torch.float32)):
        if t.dtype != dtype or t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 2-D {dtype} tensor, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if doc_packed.shape[0] < 1 or doc_packed.shape[1] < 1:
        raise ValueError(f"doc_packed must be non-empty, got {tuple(doc_packed.shape)}")
    if q_terms.shape != q_weights.shape or q_terms.shape[0] != cand_ids.shape[0]:
        raise ValueError(f"q_terms {tuple(q_terms.shape)} and q_weights "
                         f"{tuple(q_weights.shape)} must be [B, Tq] with B = "
                         f"{cand_ids.shape[0]}")
    if not (doc_packed.device == cand_ids.device == q_terms.device == q_weights.device):
        raise ValueError("doc_packed, cand_ids, q_terms and q_weights must share a device")
    if not 1 <= imp_bits <= 30:
        raise ValueError(f"imp_bits={imp_bits} must be in [1, 30]")


def rescore_match_plain(doc_packed, cand_ids, q_terms, q_weights, imp_bits: int):
    """The sums of the reference's _exact_rescore_scores with torch ops, in
    its order: per element the matched query weight accumulated over the
    query terms in order, times the impact, then one sum over the row."""
    B, C = cand_ids.shape
    safe = cand_ids.clamp(0, doc_packed.shape[0] - 1).long()
    rows = doc_packed[safe.reshape(-1)].reshape(B, C, -1)
    t = (rows >> imp_bits) & ((1 << (32 - imp_bits)) - 1)     # logical shift
    imp = (rows & ((1 << imp_bits) - 1)).to(torch.float32)
    qw = torch.where(q_terms >= 0, q_weights, 0.0)
    matched = torch.zeros_like(imp)
    for j in range(q_terms.shape[1]):
        matched = matched + torch.where(t == q_terms[:, j, None, None],
                                        qw[:, j, None, None], 0.0)
    return (matched * imp).sum(dim=-1)


def rescore_match(doc_packed: torch.Tensor, cand_ids: torch.Tensor,
                  q_terms: torch.Tensor, q_weights: torch.Tensor,
                  imp_bits: int) -> torch.Tensor:
    """-> unscaled rescore sums [B, C] f32: for each candidate row
    doc_packed[cand_ids[b, c]] of (term << imp_bits | impact) entries,
    sum_p impact_p * (sum of q_weights[b, j] over q_terms[b, j] == term_p).
    Pad query terms (< 0) weigh nothing; ids are clamped into [0, N).
    CPU tensors take the plain version; CUDA tensors launch K6."""
    _check(doc_packed, cand_ids, q_terms, q_weights, imp_bits)
    if doc_packed.device.type == "cpu":
        return rescore_match_plain(doc_packed, cand_ids, q_terms, q_weights, imp_bits)
    if doc_packed.device.type != "cuda":
        raise ValueError(f"unsupported device {doc_packed.device}")
    N, Td = doc_packed.shape
    B, C = cand_ids.shape
    out = torch.empty((B, C), dtype=torch.float32, device=cand_ids.device)
    if out.numel() == 0:
        return out
    vec = int(Td % 4 == 0 and doc_packed.data_ptr() % 16 == 0)
    lib = _build.load_library()
    with torch.cuda.device(doc_packed.device):
        rc = lib.qfr_rescore_match(doc_packed.data_ptr(), N, Td, cand_ids.data_ptr(), B * C, C,
                                   q_terms.data_ptr(), q_weights.data_ptr(), q_terms.shape[1],
                                   imp_bits, vec, out.data_ptr(), _build.stream_of(cand_ids))
    _build.check(lib, rc, "rescore_match")
    LAUNCHES["rescore_match"] += 1
    return out
