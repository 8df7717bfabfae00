"""Sparse scoring over posting windows: the pair-sort engines ("sort"), the
sort-free window rescore, quantized-sort (q8), rank-safe (q8r) and
certified (q8c).

Counterpart of qpp_fusion_rag_tpu/ops/sparse.py.

Host half (numpy): the per-term 8-bit quantization grid, the plain and the
dual doc-ordered posting layouts and the packed and exact doc-major term
vectors, byte-equal to the JAX packers so one built index serves both
packages. The packed doc vectors have one implementation,
pack_doc_vectors_device, on the device the postings lie on;
pack_doc_vectors runs it on CPU tensors for numpy callers.

Device half (torch): each query term reads a `p_cap`-wide window of its
postings (K3). The pair-sort engines sum each doc's f32 contributions over
the id-sorted row (segment.segmented_topk); the window rescore pools the
largest raw contributions and sums every pooled doc's contributions from
the same id-sorted row. The q8 engines requantize every contribution to 8
bits against the query's largest term weight, pack it back into the low
byte of the (doc << 8 | q8) key, then sort the keys and sum each doc's run
exactly in int32 (K2, for rows of up to 65,536 keys; longer rows take
torch.sort and segmented sums, the JAX package's route for them); a top-k
over the run sums follows. The rank-safe mode instead pools the top
candidates by a second bitonic pass over (sum << 16 | position) keys (K4,
or K5 when the pool is most of the row) and rescores every pooled doc
against its full doc vector (K6). The certified mode sums (q8 + 1) per
contribution, a sound per-doc upper bound, pools by it and rescores the
whole pool (K6 with its matched-weight output where the doc vectors are
truncated), then proves per query that the returned k are the true top-k.

Pool tie order: the bitonic pool breaks tied q8 sums by position, highest
first (the TPU's route), where lax.top_k takes the lowest index first; the
port follows the TPU's route, its plain versions included, unless the
caller passes bitonic=False (JAX's route off the TPU: topk_first).

The public functions take the JAX functions' parameters in their order.
dma_gather chooses between two TPU window fetches and has no effect here;
every selection is exact, which meets JAX's approximate-recall contracts.
"""

from __future__ import annotations

import weakref
from typing import NamedTuple

import numpy as np
import torch

from qpp_fusion_rag_tpu_torch import tracing as T
from qpp_fusion_rag_tpu_torch.ops.kernels.bitonic import (
    MAX_ROW,
    bitonic_segsum_rows,
    bitonic_sort_rows,
    bitonic_topp_rows,
)
from qpp_fusion_rag_tpu_torch.ops.kernels.q8_topk import q8_topk
from qpp_fusion_rag_tpu_torch.ops.kernels.row_gather import rescore_match
from qpp_fusion_rag_tpu_torch.ops.kernels.run_sums import run_sums_topk
from qpp_fusion_rag_tpu_torch.ops.kernels.window_gather import gather_windows
from qpp_fusion_rag_tpu_torch.ops.segment import (
    SENTINEL,
    run_totals_presorted,
    segmented_sums_presorted_i32,
    topk_first,
)

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
    torch; one reduction and one host read for a tensor, counted as the
    sync "presorted_cap" for a CUDA tensor)."""
    if isinstance(offsets, torch.Tensor):
        if offsets.numel() <= 1:
            return 0
        widest = (offsets[1:] - offsets[:-1]).max()
        if not widest.is_cuda:
            return int(widest)
        with T.host_sync("presorted_cap"):
            return int(widest)
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
    [N] (each doc's largest dropped weight, 0.0 if none) with return_tail,
    as numpy arrays: pack_doc_vectors_device run on CPU tensors."""
    out = pack_doc_vectors_device(
        torch.from_numpy(np.ascontiguousarray(offsets, dtype=np.int64)),
        torch.from_numpy(np.ascontiguousarray(flat_docs)),
        torch.from_numpy(np.ascontiguousarray(flat_weights, dtype=np.float32)),
        n_docs, doc_cap=doc_cap, imp_bits=imp_bits, return_tail=return_tail)
    return tuple(o.numpy() if isinstance(o, torch.Tensor) else o for o in out)


def pack_doc_vectors_exact(
    offsets: np.ndarray,       # [T+1] CSR term offsets
    flat_docs: np.ndarray,     # [P] doc ids
    flat_weights: np.ndarray,  # [P] f32 impacts
    n_docs: int,
):
    """Invert term-major CSR postings to unquantized doc-major vectors, the
    certified scorer's f32 rescore route: -> (doc_terms int32 [N, Td], -1
    pad (matches no query term), doc_w f32 [N, Td], Td), Td the longest
    doc. Twice the packed layout's bytes."""
    offsets = np.asarray(offsets, dtype=np.int64)
    flat_docs = np.asarray(flat_docs)
    flat_weights = np.asarray(flat_weights, dtype=np.float32)
    T = len(offsets) - 1
    term_of = np.repeat(np.arange(T, dtype=np.int64), np.diff(offsets))
    order = np.argsort(flat_docs, kind="stable")
    d_sorted = flat_docs[order]
    t_sorted = term_of[order]
    w_sorted = flat_weights[order]
    bounds = np.searchsorted(d_sorted, np.arange(n_docs + 1))
    counts = np.diff(bounds)
    td = max(int(counts.max()) if n_docs else 1, 1)
    doc_terms = np.full((n_docs, td), -1, dtype=np.int32)
    doc_w = np.zeros((n_docs, td), dtype=np.float32)
    col = np.arange(len(d_sorted)) - np.repeat(bounds[:-1], counts)
    doc_terms[d_sorted, col] = t_sorted.astype(np.int32)
    doc_w[d_sorted, col] = w_sorted
    return doc_terms, doc_w, td


# =============================================================================
# Device half (torch)
# =============================================================================

DOC_PACK_ENTRIES = 1 << 26   # postings pack_doc_vectors_device takes per range of docs


def _doc_ranges(counts: np.ndarray, max_entries: int) -> list:
    """Cut docs 0..N into consecutive ranges of at most max_entries
    postings (a range holds at least one doc). -> [d0, d1, ..., N]."""
    cum = np.cumsum(counts)
    edges = [0]
    while edges[-1] < len(counts):
        base = int(cum[edges[-1] - 1]) if edges[-1] else 0
        end = int(np.searchsorted(cum, base + max_entries, side="right"))
        edges.append(max(end, edges[-1] + 1))
    return edges


def _desc_float_key(w: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2^32) that ascends as f32 w descends (-0.0 as +0.0)."""
    b = (w + 0.0).view(torch.int32).to(torch.int64)
    return 0xFFFFFFFF - torch.where(b >= 0, b + (1 << 31), -1 - b)


def pack_doc_vectors_device(
    offsets: torch.Tensor,       # [T+1] CSR term offsets
    flat_docs: torch.Tensor,     # [P] doc ids in [0, n_docs)
    flat_weights: torch.Tensor,  # [P] f32 impacts
    n_docs: int,
    doc_cap: int = 0,
    imp_bits: int = 8,
    return_tail: bool = False,
):
    """pack_doc_vectors on the device the postings lie on:
    -> (doc_packed int32 [N, Td], doc_scale f32 [N], Td), plus tail_max f32
    [N] with return_tail, as tensors on that device.

    The rules, those of the JAX package's host packer: a doc's entries in posting order (ascending
    term), its doc_cap heaviest kept with ties of equal weight by posting
    order; scale = max_w / qmax and impact = round-half-even(w /
    max(scale, 1e-12)), both true f32 divisions (a tensor divisor: a
    scalar one may become a reciprocal multiply). Docs go in ranges of at
    most DOC_PACK_ENTRIES postings (plus one doc's), so the temporaries
    stay near 100 bytes a posting of one range (6.6 GB at SPLADE's 493 M
    postings on an H100)."""
    dev = flat_docs.device
    offsets = torch.as_tensor(offsets, device=dev).to(torch.int64)
    docs = torch.as_tensor(flat_docs, device=dev)
    weights = torch.as_tensor(flat_weights, device=dev).to(torch.float32)
    n_terms = offsets.numel() - 1
    sentinel_term = (1 << (31 - imp_bits)) - 1
    if n_terms > sentinel_term:
        raise ValueError(
            f"doc-vector packing with imp_bits={imp_bits} needs term ids "
            f"< 2^{31 - imp_bits} - 1; lower imp_bits (doc_vector_imp_bits)")
    qmax = (1 << imp_bits) - 1
    counts = torch.bincount(docs, minlength=n_docs)[:n_docs]
    td_full = int(counts.max()) if n_docs else 1
    td = max(td_full if doc_cap <= 0 else min(doc_cap, td_full), 1)
    cut = td < td_full
    doc_packed = torch.full((n_docs, td), sentinel_term << imp_bits, dtype=torch.int32,
                            device=dev)
    doc_scale = torch.ones(n_docs, dtype=torch.float32, device=dev)
    tail_max = torch.zeros(n_docs, dtype=torch.float32, device=dev)
    edges = _doc_ranges(counts.cpu().numpy(), DOC_PACK_ENTRIES)
    for d0, d1 in zip(edges[:-1], edges[1:]):
        pos = torch.nonzero((docs >= d0) & (docs < d1)).squeeze(1)
        d = docs[pos].to(torch.int64) - d0
        order = torch.sort(d, stable=True).indices       # by doc, then posting order
        pos, d = pos[order], d[order]
        del order
        w = weights[pos]
        t = torch.searchsorted(offsets, pos, right=True) - 1
        del pos
        cnt = counts[d0:d1]
        start = torch.cumsum(cnt, 0) - cnt
        maxw = torch.zeros(d1 - d0, dtype=torch.float32, device=dev).scatter_reduce_(
            0, d, w, "amax", include_self=False)
        scale = torch.where((cnt > 0) & (maxw > 0), maxw / torch.full_like(maxw, qmax), 1.0)
        doc_scale[d0:d1] = scale
        if cut:
            # rank by weight, descending, ties in posting order; the largest
            # dropped weight is rank td, and the kept stay in posting order
            perm = torch.sort((d << 32) | _desc_float_key(w), stable=True).indices
            rank = torch.empty_like(perm)
            rank[perm] = torch.arange(d.numel(), device=dev) - start[d]
            del perm
            edge = rank == td
            tail_max[d0:d1][d[edge]] = w[edge]
            keep = rank < td
            d, t, w = d[keep], t[keep], w[keep]
            del rank, keep, edge
            cnt = torch.clamp(cnt, max=td)
            start = torch.cumsum(cnt, 0) - cnt
        col = torch.arange(d.numel(), device=dev) - start[d]
        q = torch.clamp(torch.round(w / torch.clamp(scale[d], min=1e-12)), 0, qmax)
        doc_packed[d0:d1].view(-1)[d * td + col] = (
            (t << imp_bits) | q.to(torch.int64)).to(torch.int32)
    if return_tail:
        return doc_packed, doc_scale, td, tail_max
    return doc_packed, doc_scale, td


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


def _window_mask(s_clamped, starts, lens, cap: int):
    """[B, Tq, cap] True at the positions of each window that lie in its
    term's postings (a clamped window reads past its start)."""
    pos = s_clamped[..., None] + torch.arange(cap, dtype=torch.int32,
                                              device=s_clamped.device)
    eff = torch.clamp(lens, max=cap)
    return (pos >= starts[..., None]) & (pos < (starts + eff)[..., None])


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


def _gather_windows(flat_docs, flat_weights, starts, lens, cap: int):
    """[B, Tq] windows of `cap` postings from unpacked CSR arrays, both
    through K3 (the f32 weights through their int32 bits; weights of
    another type are converted to f32 first). Starts clamp at the array
    end and the positions outside a term's postings are masked.
    -> (docs [B, Tq, cap] int32, SENTINEL fill; weights f32, 0 fill;
    wanted mask)."""
    P = flat_docs.shape[0]
    cap = min(cap, P)
    s_clamped = torch.clamp(starts, max=max(P - cap, 0)).to(torch.int32)
    w32 = flat_weights if flat_weights.dtype == torch.float32 else flat_weights.float()
    d_win = _packed_windows(flat_docs, s_clamped, cap)
    w_win = _packed_windows(w32.view(torch.int32), s_clamped, cap).view(torch.float32)
    wanted = _window_mask(s_clamped, starts, lens, cap)
    return (torch.where(wanted, d_win, SENTINEL), torch.where(wanted, w_win, 0.0),
            wanted)


def _unpacked_contributions(flat_docs, flat_weights, offsets, q_terms, q_weights,
                            p_cap: int, term_scales=None):
    """-> (docs [B, M], vals [B, M] f32): every window posting's doc id
    (SENTINEL off the postings) and weight x query weight, the dequant
    scale folded into the query weight where given."""
    _, starts, lens, _, _ = q8_windows(offsets, q_terms, p_cap, flat_docs.shape[0])
    if term_scales is not None:
        q_weights = q_weights * term_scales[q_terms.clamp_min(0).long()]
    docs, w, _ = _gather_windows(flat_docs, flat_weights, starts, lens, p_cap)
    B = q_terms.shape[0]
    return docs.reshape(B, -1), (w * q_weights[..., None]).reshape(B, -1)


def _packed_contributions(packed, offsets, term_scales, q_terms, q_weights, p_cap: int):
    """_unpacked_contributions over packed (doc << 8 | uint8 impact)
    postings: one K3 gather of int32 windows."""
    qw = q_weights * term_scales[q_terms.clamp_min(0).long()]
    s_clamped, starts, lens, _, cap = q8_windows(offsets, q_terms, p_cap, packed.shape[0])
    win = _packed_windows(packed, s_clamped, cap)
    wanted = _window_mask(s_clamped, starts, lens, cap)
    docs = torch.where(wanted, win >> 8, SENTINEL)     # packed values are >= 0
    vals = torch.where(wanted, (win & 0xFF).to(torch.float32) * qw[..., None], 0.0)
    B = q_terms.shape[0]
    return docs.reshape(B, -1), vals.reshape(B, -1)


def _segmented_scores(docs, vals, k: int):
    """The pair-sort engines' sums and top-k: segment.segmented_topk's
    stable id sort in span ``sparse.pair_sort``, then the f32 run totals and
    their exact top-k in span ``sparse.run_sums`` (run_sums_topk: one kernel
    launch on the card, segment.segmented_topk_presorted on the CPU, the
    same bits); fusion's own call of segmented_topk carries neither.
    -> (scores [B, kk] desc, ids [B, kk], -inf / -1 pad), kk = min(k, M)."""
    with T.span("sparse.pair_sort"):
        sids, order = torch.sort(docs, dim=-1, stable=True)
        svals = torch.gather(vals, -1, order)
    with T.span("sparse.run_sums"):
        return run_sums_topk(sids, svals, k)


def sparse_score_topk(
    flat_docs: torch.Tensor,     # [P] int32 CSR doc ids (impact-ordered per term)
    flat_weights: torch.Tensor,  # [P] f32 impacts, or uint8 quantized
    offsets: torch.Tensor,       # [T+1] int32 CSR term offsets
    q_terms: torch.Tensor,       # [B, Tq] int32 term ids (-1 pad)
    q_weights: torch.Tensor,     # [B, Tq] f32 per-term query weights
    k: int = 100,
    p_cap: int = 1024,
    term_scales: torch.Tensor = None,  # [T] f32 dequant scales of uint8 weights
    exact_topk: bool = True,
):
    """Pair-sort sparse scoring -> (scores [B, kk] f32 desc, doc ids [B, kk]
    int32, -1 / -inf padded), kk = min(k, Tq·p_cap): each query term's
    window of postings (K3, docs and weights), the contributions summed per
    doc over the id-sorted row (segment.segmented_topk: f32 cumsum
    differences), the exact top kk. exact_topk has no effect: the selection
    is always exact."""
    with T.span("sparse.pairs"):
        docs, vals = _unpacked_contributions(flat_docs, flat_weights, offsets, q_terms,
                                             q_weights, p_cap, term_scales)
    return _segmented_scores(docs, vals, k)


def sparse_score_topk_packed(
    packed: torch.Tensor,        # [P] int32 (doc << 8 | uint8 impact)
    offsets: torch.Tensor,       # [T+1] int32
    term_scales: torch.Tensor,   # [T] f32 per-term dequant scales
    q_terms: torch.Tensor,       # [B, Tq] int32 (-1 pad)
    q_weights: torch.Tensor,     # [B, Tq] f32
    k: int = 100,
    p_cap: int = 1024,
    exact_topk: bool = True,
    dma_gather: bool = None,
):
    """sparse_score_topk over packed postings (pack_postings): one K3 gather
    of int32 windows. Same output; exact_topk and dma_gather have no
    effect."""
    with T.span("sparse.pairs"):
        docs, vals = _packed_contributions(packed, offsets, term_scales, q_terms, q_weights,
                                           p_cap)
    return _segmented_scores(docs, vals, k)


def _rescore_pool(docs, vals, k: int, candidates: int):
    """The sort-free scorers' tail: pool the candidates·k largest raw
    contributions of each row, then score every pooled doc exactly by all
    of its contributions and take the top k. A doc's sum is its run total
    over the id-sorted row (segment.run_totals_presorted), looked up at the
    run's last position, so no [B, pool, M] match is formed. A doc pooled
    twice keeps its first pool position. -> (scores [B, kk] desc, ids [B,
    kk], -inf / -1 pad), kk = min(k, pool)."""
    B, M = docs.shape
    vals = torch.where(docs == SENTINEL, float("-inf"), vals)
    pool = min(candidates * k, M)
    _, cidx = topk_first(vals, pool)
    cand_ids = torch.gather(docs, -1, cidx)
    sids, order = torch.sort(docs, dim=-1, stable=True)
    svals = torch.gather(torch.where(torch.isfinite(vals), vals, 0.0), -1, order)
    totals, _, _ = run_totals_presorted(sids, svals)
    last = torch.searchsorted(sids, cand_ids.contiguous(), right=True) - 1
    sums = torch.gather(totals, -1, last)
    csorted, corder = torch.sort(cand_ids, dim=-1, stable=True)
    dup = torch.zeros_like(csorted, dtype=torch.bool)
    dup[:, 1:] = csorted[:, 1:] == csorted[:, :-1]
    is_dup = torch.zeros_like(dup).scatter(1, corder, dup)
    sums = torch.where(is_dup | (cand_ids == SENTINEL), float("-inf"), sums)
    top_vals, top_idx = topk_first(sums, min(k, pool))
    top_ids = torch.gather(cand_ids, -1, top_idx)
    ok = torch.isfinite(top_vals)
    return (torch.where(ok, top_vals, float("-inf")), torch.where(ok, top_ids, -1))


def sparse_rescore_topk(
    flat_docs: torch.Tensor,
    flat_weights: torch.Tensor,
    offsets: torch.Tensor,
    q_terms: torch.Tensor,
    q_weights: torch.Tensor,
    k: int = 100,
    p_cap: int = 1024,
    candidates: int = 4,         # candidate pool = candidates * k
    term_scales: torch.Tensor = None,
):
    """Sort-free sparse scoring over unpacked postings -> (scores [B, kk]
    desc, ids [B, kk], -1 padded): a pool of the candidates·k largest raw
    contributions, each pooled doc rescored by all of its window
    contributions (_rescore_pool)."""
    return _rescore_pool(*_unpacked_contributions(
        flat_docs, flat_weights, offsets, q_terms, q_weights, p_cap, term_scales),
        k, candidates)


def sparse_rescore_topk_packed(
    packed: torch.Tensor,        # [P] int32 (doc << 8 | uint8 impact)
    offsets: torch.Tensor,       # [T+1] int32
    term_scales: torch.Tensor,   # [T] f32 per-term dequant scales
    q_terms: torch.Tensor,       # [B, Tq] int32 (-1 pad)
    q_weights: torch.Tensor,     # [B, Tq] f32
    k: int = 100,
    p_cap: int = 1024,
    candidates: int = 4,
    dma_gather: bool = None,
):
    """sparse_rescore_topk over packed postings (one K3 gather of int32
    windows); dma_gather has no effect."""
    return _rescore_pool(*_packed_contributions(
        packed, offsets, term_scales, q_terms, q_weights, p_cap), k, candidates)


def _q8_keys(packed, offsets, term_scales, q_terms, q_weights, p_cap: int,
             presorted: bool = False, return_win_min: bool = False):
    """Gather windows and form the sort keys (doc << 8 | q8).
    -> (keys [B, Tq·cap] int32, wmax_col [B, 1] f32, start_block), plus
    win_min [B, Tq] int32 with return_win_min: the least stored impact over
    each window's postings, 255 for an empty window."""
    tq_valid = q_terms >= 0
    terms = torch.where(tq_valid, q_terms, 0).long()
    qw = q_weights * term_scales[terms]
    qw = torch.where(tq_valid, qw.clamp_min(0.0), 0.0)
    wmax_col = qw.amax(dim=1, keepdim=True).clamp_min(1e-30)
    ratio = qw / wmax_col

    s_clamped, starts, lens, parity, cap = q8_windows(
        offsets, q_terms, p_cap, packed.shape[0], presorted)
    win = _packed_windows(packed, s_clamped, cap)
    wanted = _window_mask(s_clamped, starts, lens, cap)
    imp = (win & 0xFF).to(torch.float32)
    prod = imp * ratio[..., None]      # one f32 rounding, then half-to-even
    q8 = torch.round(prod).to(torch.int32)
    dev = packed.device     # each pad key: one 4-byte int32 host copy (np.int32), no cast
    if presorted:
        # descending (odd-slot) windows pad with INT32_MIN so every block
        # stays monotone for the skipped sort rounds
        padkey = torch.where(parity[..., None] == 1,
                             T.to_device(np.int32(INT32_MIN), dev, None, "q8_pad"),
                             T.to_device(np.int32(INT32_MAX), dev, None, "q8_pad"))
    else:
        padkey = T.to_device(np.int32(INT32_MAX), dev, None, "q8_pad")
    keys = torch.where(wanted, (win & ~0xFF) | q8, padkey)

    keys = keys.reshape(q_terms.shape[0], -1).contiguous()
    M = keys.shape[1]
    start_block = 2
    if presorted and cap == p_cap and cap & (cap - 1) == 0 and 2 * cap <= M:
        start_block = 2 * cap
    if return_win_min:
        win_min = torch.where(wanted, win & 0xFF, 255).amin(dim=-1).to(torch.int32)
        return keys, wmax_col, start_block, win_min
    return keys, wmax_col, start_block


def _sort_row_sums(keys, plus_one: bool = False):
    """Sort + run sums for rows longer than K2 takes: the JAX package's
    route for every row it does not give its bitonic kernel (lax.sort, then
    segmented sums). The descending windows' INT32_MIN pad folds into
    INT32_MAX first, as there; plus_one adds 1 to each real q8 value and 0
    to a pad. -> (sums, sids) as bitonic_segsum_rows."""
    skeys = torch.sort(torch.where(keys == INT32_MIN, INT32_MAX, keys), dim=-1).values
    sids = (skeys >> 8) & 0xFFFFFF
    q8 = skeys & 0xFF
    if plus_one:
        q8 = q8 + (sids < SID_INVALID).to(torch.int32)
    return segmented_sums_presorted_i32(sids, q8), sids


def _q8_row_sums(packed, offsets, term_scales, q_terms, q_weights, p_cap: int,
                 presorted: bool = False, plus_one: bool = False,
                 return_win_min: bool = False):
    """Windowed q8 core. -> (sums [B, M] int32 run totals at run-last
    positions, -1 elsewhere and on pads; sids [B, M] doc ids (>= 0x7FFFFF:
    pad); wmax_col [B, 1] f32 dequant scale), plus win_min [B, Tq] int32
    (_q8_keys) with return_win_min.

    plus_one=True sums (q8 + 1) per contribution, so a run total is q8sum
    + run length: wmax · (q8sum + cnt) bounds the doc's true windowed score
    from above, each contribution's two roundings (the q8 requantization
    and the packed uint8 impact) staying under one wmax unit.

    The route is decided by the row length M = Tq * cap alone, as the JAX
    package decides it: rows of up to MAX_ROW (65,536) keys go to K2
    (bitonic_segsum_rows: the kernel for a CUDA tensor, its plain version
    for a CPU one), longer rows to _sort_row_sums, on either device. It is
    not a fallback: a CUDA row of <= 65,536 keys launches K2 or raises."""
    with T.span("sparse.keys"):
        keys, wmax_col, start_block, *win_min = _q8_keys(
            packed, offsets, term_scales, q_terms, q_weights, p_cap, presorted,
            return_win_min=return_win_min)
    with T.span("sparse.row_sums"):
        if keys.shape[1] <= MAX_ROW:
            sums, sids = bitonic_segsum_rows(keys, start_block=start_block,
                                             plus_one=plus_one, max_run=q_terms.shape[1])
        else:
            sums, sids = _sort_row_sums(keys, plus_one)
        sums = torch.where(sids >= SID_INVALID, -1, sums)
    return (sums, sids, wmax_col, *win_min)


def sparse_score_topk_q8(
    packed: torch.Tensor,        # [P] int32 (doc << 8 | uint8 impact)
    offsets: torch.Tensor,       # [T+1] int32
    term_scales: torch.Tensor,   # [T] f32 per-term dequant scales
    q_terms: torch.Tensor,       # [B, Tq] int32 (-1 pad)
    q_weights: torch.Tensor,     # [B, Tq] f32 (>= 0)
    k: int = 100,
    p_cap: int = 1024,
    exact_topk: bool = False,
    dma_gather: bool = None,
    bitonic: bool = None,
    approx_recall: float = 0.95,
    presorted: bool = False,
):
    """Quantized-sort sparse scoring -> (scores [B, kk] f32 desc, doc ids
    [B, kk] int32, -1 / -inf padded), kk = min(k, Tq·p_cap).

    Each contribution (impact x dequant x query weight) is requantized to 8
    bits against the query's largest per-term weight and summed exactly per
    doc. presorted=True reads the dual layout (pack_postings_presorted,
    p_cap == build cap).

    The parameters are the JAX function's, in its order. The selection:
    with exact_topk=True, kk < M, bitonic not False and _can_bitonic_pool,
    the top kk come from the bitonic pool (K4 / K5, the TPU's route and its
    tie order: tied sums highest position first); otherwise from q8_topk
    (M3: topk_first's answer, exact with lax.top_k's tie order, which meets
    the approximate contract of exact_topk=False at any approx_recall; on
    the card it refuses kk above MAX_K and more than MAX_TQ query terms).
    The run sums take K2 whatever bitonic says: they are the same integers
    as JAX's lax.sort route. dma_gather has no effect: K3 has no alignment
    rules to choose by."""
    if not 0.0 < approx_recall <= 1.0:
        raise ValueError(f"approx_recall={approx_recall} must be in (0, 1]")
    sums, sids, wmax_col = _q8_row_sums(
        packed, offsets, term_scales, q_terms, q_weights, p_cap,
        presorted=presorted)
    M = sums.shape[1]
    kk = min(k, M)
    with T.span("sparse.topk"):
        if (exact_topk and kk < M and bitonic is not False
                and _can_bitonic_pool(M, q_terms.shape[1])):
            top_vals, top_ids, _ = _bitonic_pool(sums, sids, kk, wmax_col)
            ok = torch.isfinite(top_vals)
            return (torch.where(ok, top_vals, float("-inf")),
                    torch.where(ok, top_ids, -1))
        return q8_topk(sums, sids, wmax_col, kk, q_terms.shape[1])


# =============================================================================
# Rank-safe mode (q8r): bitonic pool + exact rescore
# =============================================================================

def _can_bitonic_pool(M: int, tq: int) -> bool:
    """_bitonic_pool's requirements: keys pack as (sum << 16 | position), so
    positions need M <= 2^16 and row sums < 2^15 (tq terms x 256 per
    contribution: 256 covers the certified scorer's plus_one sums). The
    port's q8 rows always come from K2 (or its plain version), so no
    "bitonic used" flag is needed."""
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


def _exact_rescore_scores_f32(cand_ids, doc_terms, doc_w, q_terms, q_weights):
    """The f32 rescore of the certified scorer: every candidate's raw
    weights (pack_doc_vectors_exact) times the matched query weight, with
    torch ops in the reference's order (the matched weight accumulated over
    the query terms in order, then one sum over the row). Query and doc
    pads are both -1, but pad query weights are zeroed, so pad-pad matches
    add nothing. -> scores [B, C] f32, -inf at invalid ids."""
    B, C = cand_ids.shape
    qw = torch.where(q_terms >= 0, q_weights, 0.0)
    safe = cand_ids.clamp_min(0).long().reshape(-1)
    t = doc_terms[safe].reshape(B, C, -1)
    w = doc_w[safe].reshape(B, C, -1)
    matched = torch.zeros_like(w)
    for j in range(q_terms.shape[1]):
        matched = matched + torch.where(t == q_terms[:, j, None, None],
                                        qw[:, j, None, None], 0.0)
    return torch.where(cand_ids >= 0, (matched * w).sum(dim=-1), float("-inf"))


def _exact_rescore_scores(cand_ids, doc_packed, doc_scale, q_terms, q_weights,
                          term_scales=None, imp_bits: int = 8, sort_ids: bool = False,
                          return_unmatched: bool = False):
    """Every candidate scored against its full doc-major term vector:
    doc_scale[d] · Σ_p imp_p · qw(term_p), the sums from K6 (its plain
    version on the CPU), qw = where(q >= 0, q_weights, 0), times
    term_scales[max(q, 0)] where given (one f32 product, as in the JAX
    function).
    -> (cand_ids [B, C] (ascending when sort_ids), scores [B, C] f32, -inf
    at invalid ids), plus unmatched [B, C] f32 with return_unmatched: Σ_j
    qw_j less the query weight the row matched, at least 0 (a row holds a
    term at most once) — K6's matched-weight output, the multiplier of
    pack_doc_vectors' tail_max bound for rows truncated at doc_cap."""
    if sort_ids:
        cand_ids = torch.sort(cand_ids, dim=-1).values
    qw = torch.where(q_terms >= 0, q_weights, 0.0)
    if term_scales is not None:
        qw = qw * term_scales[q_terms.clamp_min(0).long()]
    sums = rescore_match(doc_packed, cand_ids.contiguous(), q_terms.contiguous(),
                         qw.contiguous(), imp_bits, return_matched=return_unmatched)
    if return_unmatched:
        sums, matched = sums
    safe = cand_ids.clamp_min(0).long()
    scores = torch.where(cand_ids >= 0, sums * doc_scale[safe], float("-inf"))
    if return_unmatched:
        return cand_ids, scores, (qw.sum(dim=1, keepdim=True) - matched).clamp_min(0.0)
    return cand_ids, scores


def sparse_exact_rescore(cand_scores, cand_ids, doc_packed, doc_scale, q_terms, q_weights,
                         term_scales=None, k: int = 100, imp_bits: int = 8,
                         sort_ids: bool = False):
    """Exact rescore of a candidate pool (each doc at most once per row)
    against the full doc vectors, then the top k with lax.top_k's tie
    order. cand_scores is not read; term_scales as in
    _exact_rescore_scores. Runs in span ``sparse.rescore``.
    -> (scores [B, k] desc, ids [B, k], -inf / -1 pad)."""
    with T.span("sparse.rescore"):
        cand_ids, scores = _exact_rescore_scores(
            cand_ids, doc_packed, doc_scale, q_terms, q_weights, term_scales=term_scales,
            imp_bits=imp_bits, sort_ids=sort_ids)
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
    dma_gather: bool = None,
    bitonic: bool = None,
    imp_bits: int = 8,           # must match pack_doc_vectors
    pool_recall: float = 0.999,
    presorted: bool = False,
    sort_ids: bool = False,
):
    """Rank-safe sparse scoring -> (scores [B, k] desc, ids [B, k], -1 pad):
    the q8 windows give run sums, the top `candidates` of them form a pool,
    and every pooled doc is rescored against its full doc vector (K6) and
    re-ranked.

    The parameters are the JAX function's, in its order. The pool is the
    bitonic pool (K4 or K5, the TPU's route and tie order) when it is a
    strict part of the row and bitonic is not False; else topk_first, exact
    with lax.top_k's tie order (JAX's route off the TPU, whose approx_max_k
    at pool_recall it meets). dma_gather has no effect: K3 has no alignment
    rules to choose by."""
    if not 0.0 < pool_recall <= 1.0:
        raise ValueError(f"pool_recall={pool_recall} must be in (0, 1]")
    sums, sids, wmax_col = _q8_row_sums(
        packed, offsets, term_scales, q_terms, q_weights, p_cap, presorted=presorted)
    M = sums.shape[1]
    pool = min(candidates, M)
    with T.span("sparse.topk"):
        if pool < M and bitonic is not False and _can_bitonic_pool(M, q_terms.shape[1]):
            cs, ci, _ = _bitonic_pool(sums, sids, pool, wmax_col)
        else:
            scores = torch.where(sums >= 0, sums.to(torch.float32) * wmax_col, float("-inf"))
            cs, cidx = topk_first(scores, pool)
            ci = torch.where(torch.isfinite(cs), torch.gather(sids, -1, cidx), -1)
    return sparse_exact_rescore(cs, ci, doc_packed, doc_scale, q_terms, q_weights, k=k,
                                imp_bits=imp_bits, sort_ids=sort_ids)


# =============================================================================
# Certified mode (q8c): q8r plus a per-query exactness certificate
# =============================================================================

class Certificate(NamedTuple):
    """sparse_score_topk_q8_certified's result and the two figures its
    tie band is made of: tau = tie_rel_eps · (|ret_lb| + |bound|)."""
    scores: torch.Tensor      # [B, k] f32 desc, -inf pad
    ids: torch.Tensor         # [B, k] int32, -1 pad
    certified: torch.Tensor   # [B] bool
    slack: torch.Tensor       # [B] f32
    ret_lb: torch.Tensor      # [B] f32: the least returned score, less its rescore slack
    bound: torch.Tensor       # [B] f32: the upper bound of any doc outside the pool


def certify(packed, offsets, term_scales, doc_packed, doc_scale, q_terms, q_weights,
            k: int = 100, p_cap: int = 1024, candidates: int = 1024, bitonic: bool = None,
            imp_bits: int = 8, doc_terms=None, doc_w=None, tie_rel_eps: float = 1e-5,
            presorted: bool = False, tail_max=None) -> Certificate:
    """sparse_score_topk_q8_certified with the certificate's parts
    (Certificate)."""
    sums, sids, wmax_col, win_min = _q8_row_sums(
        packed, offsets, term_scales, q_terms, q_weights, p_cap, presorted=presorted,
        plus_one=True, return_win_min=True)
    M = sums.shape[1]
    Tq = q_terms.shape[1]

    # the pool by bound sums (q8sum + cnt): the (pool+1)-th bound bounds
    # every doc left outside
    pool = min(candidates, M)
    with T.span("sparse.topk"):
        if pool < M and bitonic is not False and _can_bitonic_pool(M, Tq):
            _, ci, outside_ub = _bitonic_pool(sums, sids, pool, wmax_col)
        else:
            row_bounds = torch.where(sums >= 0, sums.to(torch.float32) * wmax_col,
                                     float("-inf"))
            cv, cidx = topk_first(row_bounds, pool)
            ci = torch.where(torch.isfinite(cv), torch.gather(sids, -1, cidx), -1)
            outside_ub = row_bounds.scatter(1, cidx, float("-inf")).amax(dim=1)

    # per-term window stats for the hidden-mass bound
    tq_valid = q_terms >= 0
    terms = torch.where(tq_valid, q_terms, 0).long()
    region = offsets[terms + 1] - offsets[terms]
    if presorted:
        region = region >> 1             # [asc | desc] copies: the stored df is half
    lens = torch.where(tq_valid, region, 0)
    qw_raw = torch.where(tq_valid, q_weights.clamp_min(0.0), 0.0)
    qw = torch.where(tq_valid, (qw_raw * term_scales[terms]).clamp_min(0.0), 0.0)
    cap = min(p_cap, packed.shape[0])

    # rescore the whole pool: the within-pool check needs each pooled doc's
    # own quantization bound
    tail_ub = None
    if doc_terms is not None:
        pool_scores = _exact_rescore_scores_f32(ci, doc_terms, doc_w, q_terms, q_weights)
    elif tail_max is not None:
        # doc_cap-truncated rows: a query term with no stored entry may be a
        # dropped term of the doc, worth at most tail_max[d]
        ci, pool_scores, unmatched = _exact_rescore_scores(
            ci, doc_packed, doc_scale, q_terms, q_weights, imp_bits=imp_bits,
            return_unmatched=True)
        tail_ub = unmatched * tail_max[ci.clamp_min(0).long()]
    else:
        ci, pool_scores = _exact_rescore_scores(ci, doc_packed, doc_scale, q_terms, q_weights,
                                                imp_bits=imp_bits)
    kk = min(k, pool_scores.shape[1])
    top_vals, top_idx = topk_first(pool_scores, kk)
    okf = torch.isfinite(top_vals)
    scores = torch.where(okf, top_vals, float("-inf"))
    ids = torch.where(okf, torch.gather(ci, -1, top_idx), -1)
    if kk < k:
        scores = torch.nn.functional.pad(scores, (0, k - kk), value=float("-inf"))
        ids = torch.nn.functional.pad(ids, (0, k - kk), value=-1)

    # the certificate. The dual layout keeps only a term's top cap
    # postings, so a stored length of exactly cap may hide a tail
    truncated = tq_valid & ((lens >= cap) if presorted else (lens > cap))
    u_hidden = torch.where(truncated, qw * (win_min.to(torch.float32) + 0.5), 0.0).sum(dim=1)
    # a doc in no window scores >= 0 (qw clamped >= 0), hence the 0 clamp
    vis_bound = torch.where(torch.isfinite(outside_ub), outside_ub.clamp_min(0.0), 0.0)
    bound = u_hidden + vis_bound
    # rescore slack: |true - rescored| <= 0.5 · doc_scale · Σ qw_raw on the
    # quantized rows, none on the f32 route
    sum_qw = qw_raw.sum(dim=1)
    if doc_terms is not None:
        eps_c = torch.zeros_like(pool_scores)
    else:
        eps_c = 0.5 * doc_scale[ci.clamp_min(0).long()] * sum_qw[:, None]
    # a truncated row only under-counts: the tail widens the upper bound alone
    eps_up = eps_c if tail_ub is None else eps_c + tail_ub
    eps_ret = torch.gather(eps_c, -1, top_idx)
    ret_lb = torch.where(ids[:, :kk] >= 0, scores[:, :kk] - eps_ret, float("inf")).amin(dim=1)
    pool_ub = torch.where(ci >= 0, pool_scores + eps_up, float("-inf"))
    disp_ub = pool_ub.scatter(1, top_idx, float("-inf")).amax(dim=1)
    kth = scores[:, kk - 1]
    tau = tie_rel_eps * (ret_lb.abs() + bound.abs())
    slack_out = ret_lb - bound           # every returned doc clears every non-pooled doc
    slack_in = torch.where(torch.isfinite(disp_ub), ret_lb - disp_ub, float("inf"))
    slack = torch.minimum(slack_out, slack_in)
    certified = torch.isfinite(kth) & (slack >= -tau)
    return Certificate(scores, ids, certified, slack, ret_lb, bound)


def sparse_score_topk_q8_certified(
    packed: torch.Tensor,        # [P] int32 (doc << 8 | uint8 impact)
    offsets: torch.Tensor,       # [T+1] int32
    term_scales: torch.Tensor,   # [T] f32
    doc_packed: torch.Tensor,    # [N, Td] int32 doc-major (pack_doc_vectors)
    doc_scale: torch.Tensor,     # [N] f32
    q_terms: torch.Tensor,       # [B, Tq] int32 (-1 pad)
    q_weights: torch.Tensor,     # [B, Tq] f32 (>= 0)
    k: int = 100,
    p_cap: int = 1024,
    candidates: int = 1024,
    dma_gather: bool = None,
    bitonic: bool = None,
    imp_bits: int = 8,
    pool_recall: float = 0.95,
    doc_terms: torch.Tensor = None,  # [N, Td] int32 (pack_doc_vectors_exact)
    doc_w: torch.Tensor = None,      # [N, Td] f32
    tie_rel_eps: float = 1e-5,
    presorted: bool = False,
    tail_max: torch.Tensor = None,   # [N] f32 (pack_doc_vectors return_tail; needed
                                     # when doc_packed was built with a doc_cap)
):
    """Certified rank-exact sparse scoring -> (scores [B, k] desc, ids [B,
    k], certified [B] bool, slack [B] f32).

    The q8 windows run in plus_one mode, so each doc's run total bounds its
    true windowed score from above; the top `candidates` bounds form the
    pool, and the (pool+1)-th bound, plus the mass a truncated window may
    hide (each query weight times its window's least stored impact + 0.5),
    bounds every doc outside the pool. Every pooled doc is rescored against
    its full doc vector: K6 on the quantized rows (with its matched-weight
    output and tail_max on rows truncated at doc_cap), or the raw f32 rows
    (doc_terms / doc_w). A query is certified when its least returned score,
    less its rescore slack, clears every bound outside the returned k up to
    the tie band tie_rel_eps · (|ret_lb| + |bound|): the returned k ids are
    then the true top-k of the stored weights, up to swaps inside the band.

    The parameters are the JAX function's, in its order. The pool is the
    bitonic pool (K4 or K5, the TPU's route and tie order) when it is a
    strict part of the row and bitonic is not False; else topk_first (JAX's
    route off the TPU), with the bound outside it the largest bound left
    unpooled. Every selection is exact, which meets pool_recall;
    dma_gather has no effect. presorted=True reads the dual layout
    (p_cap == build cap): a term's stored length is then half its region,
    and a length of cap counts as truncated."""
    if not 0.0 < pool_recall <= 1.0:
        raise ValueError(f"pool_recall={pool_recall} must be in (0, 1]")
    return certify(packed, offsets, term_scales, doc_packed, doc_scale, q_terms, q_weights,
                   k=k, p_cap=p_cap, candidates=candidates, bitonic=bitonic,
                   imp_bits=imp_bits, doc_terms=doc_terms, doc_w=doc_w,
                   tie_rel_eps=tie_rel_eps, presorted=presorted, tail_max=tail_max)[:4]
