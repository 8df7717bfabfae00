"""Quantized-sort (q8) sparse scoring: BM25 / learned-impact views.

Counterpart of qpp_fusion_rag_tpu/ops/sparse.py for the q8 path only.

Host half (numpy): the per-term 8-bit quantization grid and the dual
doc-ordered posting layout, byte-equal to the JAX packers so one built
index serves both packages.

Device half (torch): each query term reads a `p_cap`-wide window of its
packed (doc << 8 | uint8 impact) postings (K3), requantizes every
contribution to 8 bits against the query's largest term weight, packs it
back into the low byte of the doc key, then sorts the keys and sums each
doc's run exactly in int32 (K2); a top-k over the run sums follows.
"""

from __future__ import annotations

import numpy as np
import torch

from qpp_fusion_rag_tpu_torch.ops.kernels.bitonic import bitonic_segsum_rows
from qpp_fusion_rag_tpu_torch.ops.kernels.window_gather import gather_windows
from qpp_fusion_rag_tpu_torch.ops.segment import topk_first

ALIGN = 1024          # array-length granule of the shared packed layout
_MAX_DMA_CAP = 4096   # largest p_cap the packed layout is padded for
INT32_MIN, INT32_MAX = -(2**31), 2**31 - 1
SID_INVALID = 0x7FFFFF   # sids >= this are pads (0x7FFFFF asc, 0x800000 desc)


# =============================================================================
# Host half (numpy)
# =============================================================================

def pad_for_gather(flat: np.ndarray, cap: int) -> np.ndarray:
    """Zero-pad a flat postings array to a multiple of ALIGN with at least
    cap + ALIGN slack (the layout the TPU's aligned window fetch needs;
    kept so indexes stay shared between the two packages)."""
    need = len(flat) + cap + ALIGN
    total = ((need + ALIGN - 1) // ALIGN) * ALIGN
    return np.pad(flat, (0, total - len(flat)))


def term_scales_from_csr(flat_weights: np.ndarray,
                         offsets: np.ndarray) -> np.ndarray:
    """Per-term 8-bit quantization grid: scale = (max impact over the whole
    run) / 255, and 1.0 for empty or all-zero lists."""
    offsets = np.asarray(offsets, dtype=np.int64)
    flat_weights = np.asarray(flat_weights, dtype=np.float32)
    T = len(offsets) - 1
    counts = np.diff(offsets)
    maxima = np.zeros(T, dtype=np.float32)
    nonempty = counts > 0
    if nonempty.any():
        maxima[nonempty] = np.maximum.reduceat(flat_weights, offsets[:-1][nonempty])
    return np.where(maxima > 0, maxima / 255.0, 1.0).astype(np.float32)


def _pack_inputs(flat_docs, flat_weights, offsets, scales):
    """Packer front end: dtype coercion, the doc-id bound (ids < 2^23 - 1;
    0x7FFFFF is the sort sentinel) and the quantization grid (derived, or
    taken verbatim when supplied)."""
    flat_docs = np.asarray(flat_docs)
    flat_weights = np.asarray(flat_weights, dtype=np.float32)
    offsets = np.asarray(offsets, dtype=np.int64)
    if len(flat_docs) and int(flat_docs.max()) >= (1 << 23) - 1:
        raise ValueError("packed postings need doc ids < 2^23 - 1; shard the corpus")
    if scales is None:
        scales = term_scales_from_csr(flat_weights, offsets)
    else:
        scales = np.asarray(scales, dtype=np.float32)
    return flat_docs, flat_weights, offsets, scales


def pack_postings_presorted(
    flat_docs: np.ndarray,     # [P] doc ids (impact-ordered per term)
    flat_weights: np.ndarray,  # [P] f32 impacts
    offsets: np.ndarray,       # [T+1]
    cap: int,                  # the p_cap this layout is built for
    scales: np.ndarray = None,
):
    """Dual doc-ordered window layout: per term, the top-min(df, cap)
    postings by impact, re-sorted by doc id and stored twice (ascending,
    then reversed). Even query-term slots read the ascending copy, odd slots
    the descending one, so a gathered row arrives as alternating sorted
    blocks and the sort skips its first log2(cap) rounds. Searches must use
    p_cap == cap.

    -> (packed int32 [2·Σ min(df, cap)] tail-padded, offsets2 [T+1] int64
        dual-block starts, term_scales f32 [T])."""
    flat_docs, flat_weights, offsets, scales = _pack_inputs(
        flat_docs, flat_weights, offsets, scales)
    T = len(offsets) - 1
    counts = np.diff(offsets)
    eff = np.minimum(counts, cap)
    total = int(eff.sum())
    cum = np.zeros(T + 1, dtype=np.int64)
    np.cumsum(eff, out=cum[1:])
    within = np.arange(total, dtype=np.int64) - np.repeat(cum[:-1], eff)
    src = np.repeat(offsets[:-1], eff) + within
    sel_docs = flat_docs[src].astype(np.int64)
    q = np.clip(np.round(flat_weights[src] /
                         np.maximum(np.repeat(scales, eff), 1e-12)),
                0, 255).astype(np.int64)
    vals = (sel_docs << 8) | q
    term_of = np.repeat(np.arange(T, dtype=np.int64), eff)
    order = np.lexsort((vals, term_of))      # per-term doc-ascending
    vals_sorted = vals[order]

    offsets2 = 2 * cum
    out = np.zeros(2 * total, dtype=np.int64)
    dst_asc = np.repeat(offsets2[:-1], eff) + within
    out[dst_asc] = vals_sorted
    eff_rep = np.repeat(eff, eff)
    dst_desc = np.repeat(offsets2[:-1] + eff, eff) + (eff_rep - 1 - within)
    out[dst_desc] = vals_sorted
    # slack of at least cap: a window clamped at the array end must never
    # put pad keys before a sorted run
    return (pad_for_gather(out.astype(np.int32), max(cap, _MAX_DMA_CAP)),
            offsets2, scales)


def validate_presorted_cap(offsets, p_cap: int) -> None:
    """Refuse a p_cap below the dual layout's build cap: every dual window
    is 2·min(df, build_cap) long, so a window longer than 2·p_cap proves
    p_cap < build_cap, where windows would silently read doc-id-prefix
    subsets instead of the impact top. Accepts numpy or torch offsets (one
    small reduction and host read per call)."""
    if isinstance(offsets, torch.Tensor):
        max_len = int((offsets[1:] - offsets[:-1]).max()) if offsets.numel() > 1 else 0
    else:
        off = np.asarray(offsets)
        max_len = int(np.diff(off).max()) if off.size > 1 else 0
    if max_len > 2 * p_cap:
        raise ValueError(
            f"presorted layout has a dual window of {max_len} entries, but "
            f"p_cap={p_cap} only covers 2*{p_cap}: the layout was built at "
            f"cap={max_len // 2} — search with p_cap == build cap")


# =============================================================================
# Device half (torch)
# =============================================================================

def _presorted_geometry(offsets, terms, tq_valid, Tq: int):
    """Window starts/lens for the dual layout: each term's region is [asc
    copy | desc copy] of length eff each; odd query-term slots read the
    descending copy. -> (starts, lens, parity [1, Tq] int32)."""
    base = offsets[terms]
    eff = (offsets[terms + 1] - base) >> 1
    parity = (torch.arange(Tq, dtype=torch.int32, device=offsets.device) & 1)[None, :]
    starts = base + parity * eff
    lens = torch.where(tq_valid, eff, 0)
    return starts, lens, parity


def _packed_windows(packed, s_clamped, cap: int):
    """[B, Tq] window starts -> [B, Tq, cap] packed windows (K3)."""
    B, Tq = s_clamped.shape
    win = gather_windows(packed, s_clamped.reshape(-1).contiguous(), cap)
    return win.reshape(B, Tq, cap)


def q8_windows(offsets, q_terms, p_cap: int, P: int, presorted: bool = False):
    """Window geometry of the q8 scorers for [B, Tq] query terms over a
    packed array of length P. -> (s_clamped [B, Tq] int32: the starts K3
    gathers at, starts, lens, parity [1, Tq] or None, cap)."""
    tq_valid = q_terms >= 0
    terms = torch.where(tq_valid, q_terms, 0).long()
    parity = None
    if presorted:
        starts, lens, parity = _presorted_geometry(offsets, terms, tq_valid,
                                                   q_terms.shape[1])
    else:
        starts = offsets[terms]
        lens = torch.where(tq_valid, offsets[terms + 1] - starts, 0)
    cap = min(p_cap, P)
    s_clamped = torch.clamp(starts, max=max(P - cap, 0)).to(torch.int32)
    return s_clamped, starts, lens, parity, cap


def _q8_keys(packed, offsets, term_scales, q_terms, q_weights, p_cap: int,
             presorted: bool = False):
    """Gather windows and form the sort keys (doc << 8 | q8).
    -> (keys [B, Tq·cap] int32, wmax_col [B, 1] f32, start_block)."""
    tq_valid = q_terms >= 0
    terms = torch.where(tq_valid, q_terms, 0).long()
    qw = q_weights * term_scales[terms]
    qw = torch.where(tq_valid, qw.clamp_min(0.0), 0.0)
    wmax_col = qw.amax(dim=1, keepdim=True).clamp_min(1e-30)
    ratio = qw / wmax_col

    s_clamped, starts, lens, parity, cap = q8_windows(
        offsets, q_terms, p_cap, packed.shape[0], presorted)
    win = _packed_windows(packed, s_clamped, cap)
    pos = s_clamped[..., None] + torch.arange(cap, dtype=torch.int32,
                                              device=packed.device)
    eff = torch.clamp(lens, max=cap)
    wanted = (pos >= starts[..., None]) & (pos < (starts + eff)[..., None])
    imp = (win & 0xFF).to(torch.float32)
    prod = imp * ratio[..., None]      # one f32 rounding, then half-to-even
    q8 = torch.round(prod).to(torch.int32)
    if presorted:
        # descending (odd-slot) windows pad with INT32_MIN so every block
        # stays monotone for the skipped sort rounds
        padkey = torch.where(parity[..., None] == 1,
                             torch.tensor(INT32_MIN, dtype=torch.int32, device=packed.device),
                             torch.tensor(INT32_MAX, dtype=torch.int32, device=packed.device))
    else:
        padkey = torch.tensor(INT32_MAX, dtype=torch.int32, device=packed.device)
    keys = torch.where(wanted, (win & ~0xFF) | q8, padkey)

    keys = keys.reshape(q_terms.shape[0], -1).contiguous()
    M = keys.shape[1]
    start_block = 2
    if presorted and cap == p_cap and cap & (cap - 1) == 0 and 2 * cap <= M:
        start_block = 2 * cap
    return keys, wmax_col, start_block


def _q8_row_sums(packed, offsets, term_scales, q_terms, q_weights, p_cap: int,
                 presorted: bool = False, plus_one: bool = False,
                 return_win_min: bool = False):
    """Windowed q8 core. -> (sums [B, M] int32 run totals at run-last
    positions, -1 elsewhere and on pads; sids [B, M] doc ids (>= 0x7FFFFF:
    pad); wmax_col [B, 1] f32 dequant scale)."""
    if plus_one or return_win_min:
        raise NotImplementedError(
            "plus_one / return_win_min serve the certified q8c scorer, which "
            "is not ported yet (ROADMAP Queue 1, certified mode)")
    keys, wmax_col, start_block = _q8_keys(
        packed, offsets, term_scales, q_terms, q_weights, p_cap, presorted)
    sums, sids = bitonic_segsum_rows(keys, start_block=start_block,
                                     max_run=q_terms.shape[1])
    sums = torch.where(sids >= SID_INVALID, -1, sums)
    return sums, sids, wmax_col


def sparse_score_topk_q8(
    packed: torch.Tensor,        # [P] int32 (doc << 8 | uint8 impact)
    offsets: torch.Tensor,       # [T+1] int32
    term_scales: torch.Tensor,   # [T] f32 per-term dequant scales
    q_terms: torch.Tensor,       # [B, Tq] int32 (-1 pad)
    q_weights: torch.Tensor,     # [B, Tq] f32 (>= 0)
    k: int = 100,
    p_cap: int = 1024,
    presorted: bool = False,
):
    """Quantized-sort sparse scoring -> (scores [B, kk] f32 desc, doc ids
    [B, kk] int32, -1 / -inf padded), kk = min(k, Tq·p_cap).

    Each contribution (impact x dequant x query weight) is requantized to 8
    bits against the query's largest per-term weight and summed exactly per
    doc; the selection is exact with lax.top_k's tie order. presorted=True
    reads the dual layout (pack_postings_presorted, p_cap == build cap)."""
    sums, sids, wmax_col = _q8_row_sums(
        packed, offsets, term_scales, q_terms, q_weights, p_cap,
        presorted=presorted)
    kk = min(k, sums.shape[1])
    scores = torch.where(sums >= 0, sums.to(torch.float32) * wmax_col,
                         float("-inf"))
    top_vals, top_idx = topk_first(scores, kk)
    top_ids = torch.gather(sids, -1, top_idx)
    ok = torch.isfinite(top_vals)
    return (torch.where(ok, top_vals, float("-inf")),
            torch.where(ok, top_ids, -1))
