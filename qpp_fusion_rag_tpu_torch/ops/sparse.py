"""Quantized-sort (q8) sparse scoring: BM25 / learned-impact views, plain
("q8") and rank-safe ("q8r").

Counterpart of qpp_fusion_rag_tpu/ops/sparse.py for those two paths.

Host half (numpy): the per-term 8-bit quantization grid, the plain and the
dual doc-ordered posting layouts and the packed doc-major term vectors,
byte-equal to the JAX packers so one built index serves both packages.

Device half (torch): each query term reads a `p_cap`-wide window of its
packed (doc << 8 | uint8 impact) postings (K3), requantizes every
contribution to 8 bits against the query's largest term weight, packs it
back into the low byte of the doc key, then sorts the keys and sums each
doc's run exactly in int32 (K2, for rows of up to 65,536 keys; longer rows
take torch.sort and segmented sums, the JAX package's route for them); a
top-k over the run sums follows. The
rank-safe mode instead pools the top candidates by a second bitonic pass
over (sum << 16 | position) keys (K4, or K5 when the pool is most of the
row) and rescores every pooled doc against its full doc vector (K6).

Pool tie order: the bitonic pool breaks tied q8 sums by position, highest
first (the TPU's route), where lax.top_k takes the lowest index first; the
port follows the TPU's route everywhere, its plain versions included.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from qpp_fusion_rag_tpu_torch.ops.kernels.bitonic import (
    MAX_ROW,
    bitonic_segsum_rows,
    bitonic_sort_rows,
    bitonic_topp_rows,
)
from qpp_fusion_rag_tpu_torch.ops.kernels.row_gather import rescore_match
from qpp_fusion_rag_tpu_torch.ops.kernels.window_gather import gather_windows
from qpp_fusion_rag_tpu_torch.ops.segment import segmented_sums_presorted_i32, topk_first

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


def pack_postings(
    flat_docs: np.ndarray,     # [P] doc ids (< 2^23 - 1)
    flat_weights: np.ndarray,  # [P] f32 impacts (impact-ordered per term)
    offsets: np.ndarray,       # [T+1]
    scales: np.ndarray = None,  # [T] f32: quantize against these instead
):
    """Plain layout: each posting packed into one int32 (doc << 8 | uint8
    impact), the impact quantized per term against term_scales_from_csr.
    -> (packed int32 [P] tail-padded (pad_for_gather), term_scales f32 [T])."""
    flat_docs, flat_weights, offsets, scales = _pack_inputs(
        flat_docs, flat_weights, offsets, scales)
    per_post = np.repeat(scales, np.diff(offsets))
    q = np.clip(np.round(flat_weights / np.maximum(per_post, 1e-12)), 0, 255)
    packed = (flat_docs.astype(np.int64) << 8) | q.astype(np.int64)
    return pad_for_gather(packed.astype(np.int32), _MAX_DMA_CAP), scales


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


def _max_dual_window(offsets) -> int:
    """The longest dual window of a presorted layout's offsets (numpy or
    torch; one reduction and one host read for a tensor)."""
    if isinstance(offsets, torch.Tensor):
        return int((offsets[1:] - offsets[:-1]).max()) if offsets.numel() > 1 else 0
    off = np.asarray(offsets)
    return int(np.diff(off).max()) if off.size > 1 else 0


_PRESORTED_OK: dict = {}   # id(offsets) -> (weakref to offsets, {checked p_cap})


def validate_presorted_cap(offsets, p_cap: int) -> None:
    """Refuse a p_cap below the dual layout's build cap: every dual window
    is 2·min(df, build_cap) long, so a window longer than 2·p_cap proves
    p_cap < build_cap, where windows would silently read doc-id-prefix
    subsets instead of the impact top. Accepts numpy or torch offsets.

    A passed check is cached on the live offsets object (a weakref, checked
    by identity, never by data_ptr(): the caching allocator reuses
    addresses), so steady-state serving pays no device read."""
    hit = _PRESORTED_OK.get(id(offsets))
    live = hit is not None and hit[0]() is offsets
    if live and int(p_cap) in hit[1]:
        return
    max_len = _max_dual_window(offsets)
    if max_len > 2 * p_cap:
        raise ValueError(
            f"presorted layout has a dual window of {max_len} entries, but "
            f"p_cap={p_cap} only covers 2*{p_cap}: the layout was built at "
            f"cap={max_len // 2} — search with p_cap == build cap")
    if live:
        hit[1].add(int(p_cap))
        return
    try:
        ref = weakref.ref(offsets)
    except TypeError:
        return                               # not weakref-able: check every call
    if len(_PRESORTED_OK) > 256:
        for key in [k for k, v in _PRESORTED_OK.items() if v[0]() is None]:
            del _PRESORTED_OK[key]
    _PRESORTED_OK[id(offsets)] = (ref, {int(p_cap)})


def doc_vector_imp_bits(n_terms: int, max_bits: int = 14) -> int:
    """Widest impact field that still fits (term id | sentinel) in int31:
    term ids (with the all-ones sentinel) take ceil(log2(T+1)) bits, the
    rest go to impact precision, at least 8 and at most max_bits."""
    need = max(int(np.ceil(np.log2(max(n_terms + 1, 2)))), 1)
    return max(8, min(max_bits, 31 - need))


def pack_doc_vectors(
    offsets: np.ndarray,       # [T+1] CSR term offsets
    flat_docs: np.ndarray,     # [P] doc ids
    flat_weights: np.ndarray,  # [P] f32 impacts
    n_docs: int,
    doc_cap: int = 0,          # 0 = fit the longest doc (exact)
    imp_bits: int = 8,         # impact precision (doc_vector_imp_bits)
    return_tail: bool = False,
):
    """Invert term-major CSR postings to packed doc-major vectors for the
    exact rescore: row d holds doc d's (term << imp_bits | q-impact)
    entries, padded with the all-ones term sentinel (matches no query).
    Impacts quantize per doc against the doc's max weight (scale =
    max_w / (2^imp_bits - 1)). doc_cap > 0 keeps each doc's doc_cap
    heaviest terms (the rescore then lower-bounds the true score).
    -> (doc_packed int32 [N, Td], doc_scale f32 [N], Td), plus tail_max f32
    [N] (each doc's largest dropped weight, 0.0 if none) with return_tail."""
    offsets = np.asarray(offsets, dtype=np.int64)
    flat_docs = np.asarray(flat_docs)
    flat_weights = np.asarray(flat_weights, dtype=np.float32)
    T = len(offsets) - 1
    sentinel_term = (1 << (31 - imp_bits)) - 1
    if T > sentinel_term:
        raise ValueError(
            f"doc-vector packing with imp_bits={imp_bits} needs term ids "
            f"< 2^{31 - imp_bits} - 1; lower imp_bits (doc_vector_imp_bits)")
    qmax = (1 << imp_bits) - 1
    term_of = np.repeat(np.arange(T, dtype=np.int64), np.diff(offsets))
    order = np.argsort(flat_docs, kind="stable")
    d_sorted = flat_docs[order]
    t_sorted = term_of[order]
    w_sorted = flat_weights[order]
    bounds = np.searchsorted(d_sorted, np.arange(n_docs + 1))
    counts = np.diff(bounds)
    td_full = int(counts.max()) if n_docs else 1
    td = max(td_full if doc_cap <= 0 else min(doc_cap, td_full), 1)

    doc_scale = np.ones(n_docs, dtype=np.float32)
    nz = counts > 0
    if nz.any():
        maxw = np.maximum.reduceat(w_sorted, bounds[:-1][nz])
        doc_scale[nz] = np.where(maxw > 0, maxw / qmax, 1.0)

    tail_max = np.zeros(n_docs, dtype=np.float32)
    if td < td_full:
        # rank entries per doc by -w; the largest dropped weight is rank td
        rank = np.zeros(len(d_sorted), dtype=np.int64)
        sub = np.lexsort((-w_sorted, d_sorted))
        rank[sub] = np.arange(len(d_sorted)) - np.repeat(bounds[:-1], counts)
        edge = rank == td
        tail_max[d_sorted[edge]] = w_sorted[edge]
        keep = rank < td
        d_sorted, t_sorted, w_sorted = d_sorted[keep], t_sorted[keep], w_sorted[keep]
        bounds = np.searchsorted(d_sorted, np.arange(n_docs + 1))
        counts = np.diff(bounds)

    q = np.clip(np.round(w_sorted / np.maximum(
        np.repeat(doc_scale, counts), 1e-12)), 0, qmax).astype(np.int64)
    doc_packed = np.full((n_docs, td), np.int64(sentinel_term) << imp_bits, dtype=np.int64)
    col = np.arange(len(d_sorted)) - np.repeat(bounds[:-1], counts)
    doc_packed[d_sorted, col] = (t_sorted << imp_bits) | q
    if return_tail:
        return doc_packed.astype(np.int32), doc_scale, td, tail_max
    return doc_packed.astype(np.int32), doc_scale, td


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


def _sort_row_sums(keys):
    """Sort + run sums for rows longer than K2 takes: the JAX package's
    route for every row it does not give its bitonic kernel (lax.sort, then
    segmented sums). The descending windows' INT32_MIN pad folds into
    INT32_MAX first, as there. -> (sums, sids) as bitonic_segsum_rows."""
    skeys = torch.sort(torch.where(keys == INT32_MIN, INT32_MAX, keys), dim=-1).values
    sids = (skeys >> 8) & 0xFFFFFF
    return segmented_sums_presorted_i32(sids, skeys & 0xFF), sids


def _q8_row_sums(packed, offsets, term_scales, q_terms, q_weights, p_cap: int,
                 presorted: bool = False, plus_one: bool = False,
                 return_win_min: bool = False):
    """Windowed q8 core. -> (sums [B, M] int32 run totals at run-last
    positions, -1 elsewhere and on pads; sids [B, M] doc ids (>= 0x7FFFFF:
    pad); wmax_col [B, 1] f32 dequant scale).

    The route is decided by the row length M = Tq * cap alone, as the JAX
    package decides it: rows of up to MAX_ROW (65,536) keys go to K2
    (bitonic_segsum_rows: the kernel for a CUDA tensor, its plain version
    for a CPU one), longer rows to _sort_row_sums, on either device. It is
    not a fallback: a CUDA row of <= 65,536 keys launches K2 or raises."""
    if plus_one or return_win_min:
        raise NotImplementedError(
            "plus_one / return_win_min serve the certified q8c scorer, which "
            "is not ported yet (ROADMAP Queue 1, certified mode)")
    keys, wmax_col, start_block = _q8_keys(
        packed, offsets, term_scales, q_terms, q_weights, p_cap, presorted)
    if keys.shape[1] <= MAX_ROW:
        sums, sids = bitonic_segsum_rows(keys, start_block=start_block,
                                         max_run=q_terms.shape[1])
    else:
        sums, sids = _sort_row_sums(keys)
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


# =============================================================================
# Rank-safe mode (q8r): bitonic pool + exact rescore
# =============================================================================

def _can_bitonic_pool(M: int, tq: int) -> bool:
    """_bitonic_pool's requirements: keys pack as (sum << 16 | position), so
    positions need M <= 2^16 and row sums < 2^15 (tq terms x 256 per
    contribution). The port's q8 rows always come from K2 (or its plain
    version), so no "bitonic used" flag is needed."""
    return M <= (1 << 16) and tq * 256 < (1 << 15)


def _pool_keys(sums: torch.Tensor) -> torch.Tensor:
    """[B, M] run sums (-1 off runs) -> (sum << 16 | position) keys, -1
    where there is no run."""
    pos = torch.arange(sums.shape[1], dtype=torch.int32, device=sums.device)
    return torch.where(sums >= 0, (sums << 16) | pos, -1)


def _bitonic_pool(sums, sids, pool: int, wmax_col):
    """Exact top-`pool` of the q8 run sums by a second bitonic pass over
    (sum << 16 | position) keys: tied sums go highest position first.
    -> (cand_scores [B, pool] f32 desc, cand_ids [B, pool] (-1 pad),
        outside_max [B] f32: the true (pool+1)-th value, -inf if none)."""
    B, M = sums.shape
    key = _pool_keys(sums)
    bs = 1024
    while bs <= pool:
        bs *= 2
    if 2 * bs <= M:
        blk = bitonic_topp_rows(key, bs=bs)                  # [B, bs] ascending
        top = blk[:, bs - pool:].flip(-1)                    # descending pool
        nxt = blk[:, bs - pool - 1]
    else:
        skey = bitonic_sort_rows(key)                        # ascending
        top = skey[:, M - pool:].flip(-1)
        nxt = (skey[:, M - pool - 1] if M > pool
               else torch.full((B,), -1, dtype=torch.int32, device=sums.device))
    real = top >= 0
    cidx = torch.where(real, top & 0xFFFF, 0).long()
    cv = torch.where(real, (top >> 16).to(torch.float32) * wmax_col, float("-inf"))
    ci = torch.where(real, torch.gather(sids, -1, cidx), -1)
    outside_max = torch.where(nxt >= 0, (nxt >> 16).to(torch.float32) * wmax_col[:, 0],
                              float("-inf"))
    return cv, ci, outside_max


def _exact_rescore_scores(cand_ids, doc_packed, doc_scale, q_terms, q_weights,
                          imp_bits: int = 8, sort_ids: bool = False):
    """Every candidate scored against its full doc-major term vector:
    doc_scale[d] · Σ_p imp_p · qw(term_p), the sums from K6 (its plain
    version on the CPU). -> (cand_ids [B, C] (ascending when sort_ids),
    scores [B, C] f32, -inf at invalid ids)."""
    if sort_ids:
        cand_ids = torch.sort(cand_ids, dim=-1).values
    sums = rescore_match(doc_packed, cand_ids.contiguous(), q_terms.contiguous(),
                         q_weights.contiguous(), imp_bits)
    safe = cand_ids.clamp_min(0).long()
    scores = torch.where(cand_ids >= 0, sums * doc_scale[safe], float("-inf"))
    return cand_ids, scores


def sparse_exact_rescore(cand_scores, cand_ids, doc_packed, doc_scale, q_terms, q_weights,
                         k: int = 100, imp_bits: int = 8, sort_ids: bool = False):
    """Exact rescore of a candidate pool (each doc at most once per row)
    against the full doc vectors, then the top k with lax.top_k's tie
    order. cand_scores is not read. -> (scores [B, k] desc, ids [B, k],
    -inf / -1 pad)."""
    cand_ids, scores = _exact_rescore_scores(
        cand_ids, doc_packed, doc_scale, q_terms, q_weights, imp_bits=imp_bits,
        sort_ids=sort_ids)
    kk = min(k, cand_ids.shape[1])
    top_vals, top_idx = topk_first(scores, kk)
    top_ids = torch.gather(cand_ids, -1, top_idx)
    ok = torch.isfinite(top_vals)
    top_vals = torch.where(ok, top_vals, float("-inf"))
    top_ids = torch.where(ok, top_ids, -1)
    if kk < k:
        top_vals = torch.nn.functional.pad(top_vals, (0, k - kk), value=float("-inf"))
        top_ids = torch.nn.functional.pad(top_ids, (0, k - kk), value=-1)
    return top_vals, top_ids


def sparse_score_topk_q8_rescored(
    packed: torch.Tensor,        # [P] int32 (doc << 8 | uint8 impact)
    offsets: torch.Tensor,       # [T+1] int32
    term_scales: torch.Tensor,   # [T] f32
    doc_packed: torch.Tensor,    # [N, Td] int32 doc-major (pack_doc_vectors)
    doc_scale: torch.Tensor,     # [N] f32
    q_terms: torch.Tensor,       # [B, Tq] int32 (-1 pad)
    q_weights: torch.Tensor,     # [B, Tq] f32
    k: int = 100,
    p_cap: int = 1024,
    candidates: int = 512,
    imp_bits: int = 8,           # must match pack_doc_vectors
    presorted: bool = False,
    sort_ids: bool = False,
):
    """Rank-safe sparse scoring -> (scores [B, k] desc, ids [B, k], -1 pad):
    the q8 windows give run sums, the top `candidates` of them form a pool
    (the bitonic pool, K4 or K5, when it is a strict part of the row; else
    an exact top-k), and every pooled doc is rescored against its full doc
    vector (K6) and re-ranked."""
    sums, sids, wmax_col = _q8_row_sums(
        packed, offsets, term_scales, q_terms, q_weights, p_cap, presorted=presorted)
    M = sums.shape[1]
    pool = min(candidates, M)
    if pool < M and _can_bitonic_pool(M, q_terms.shape[1]):
        cs, ci, _ = _bitonic_pool(sums, sids, pool, wmax_col)
    else:
        scores = torch.where(sums >= 0, sums.to(torch.float32) * wmax_col, float("-inf"))
        cs, cidx = topk_first(scores, pool)
        ci = torch.where(torch.isfinite(cs), torch.gather(sids, -1, cidx), -1)
    return sparse_exact_rescore(cs, ci, doc_packed, doc_scale, q_terms, q_weights, k=k,
                                imp_bits=imp_bits, sort_ids=sort_ids)
