"""Plain reference of the ensemble step in its default sparse mode ("sort"),
from the benchmark's own data (the impact-ordered postings cut to each
term's first p_cap, the int8 rows and their scales), never from the
program's packed index.

Sparse views (BM25, SPLADE), f32 pair-sum semantics: a term's impacts
quantize to 8 bits on its grid (largest impact / 255, reference/ensemble.py:
term_grid); each of a query term's first min(df, p_cap) postings contributes
its 8-bit impact x (the grid step x the query weight), in the float type. A
doc's score is the sum of its contributions over the query's terms (a term
twice in a query counts twice, as its window does), added per doc directly:
exactly, in float64, and rounded to the float type once. No contribution is
requantized: that is q8's semantics (reference/ensemble.py), not this
mode's. The top k come by score, ties lowest doc id first.

Ties. On 8-bit impacts equal sums are everywhere (every doc of one term at
one impact level), and the mode's f32 sums leave their order open: the
program takes each doc's total as a difference of prefix sums over the
query's whole row, so tied docs get totals a few roundings apart, and the
rounding picks which of them make the k-th rank. Which of them does changes
BM25's candidates for the two rerank views, and so the fused lists and QPP.
So each view holds the program's own pick of its top k (data["picks"],
taken by the step's set-up from the program's sparse scorer on the same
batches) to the mode's meaning: the pick stands where every doc in it is a
doc of the query's windows, none twice, as many as the reference's, and
none scoring below the reference's k-th score by more than the tie band
(limits "sparse_tie_band", a share of the query's best score). Then the
view is those docs, in the reference's order and with the reference's
scores; otherwise the reference's own top k. Every score, the dense view,
the reranks, QPP and fusion are the reference's own.

Dense view, rerank views, QPP and fusion: reference/ensemble.py and
reference/common.py, as for the q8 cell; run() repeats reference/ensemble.py's
run with this file's sparse view, since that file may not be edited.
Matrix products run in f32 without TF32 (common.exact_float32).
"""

from __future__ import annotations

import torch

from benchmark_torch.reference import common as C
from benchmark_torch.reference import ensemble as Q8

SCORE_SHIFT = Q8.SUM_SHIFT     # key = f32 score bits << 23 | (2^23 - 1 - doc)


def sparse_view(csr: dict, grid, terms: torch.Tensor, qw: torch.Tensor, n_docs: int,
                k: int, ft, picks=None, band: float = 0.0, block: int = 64):
    """One sparse view of a batch. picks: the program's ids [B, k] (-1 pad)
    or None. -> (scores [B, k] in ft (-inf pad), ids int64 [B, k] (-1 pad),
    shortfall float64 [B]: how far the pick's lowest doc scores below the
    reference's k-th score, over the query's best score (0 at or above it,
    inf for a pick that is no top k at all, 0 where picks is None))."""
    dev = csr["docs"].device
    step, imp = grid
    off, docs = csr["offsets"], csr["docs"].to(torch.int64)
    counts = off[1:] - off[:-1]
    terms = terms.to(dev).long()
    qw = qw.to(dev, torch.float32)
    ok = terms >= 0
    t = torch.where(ok, terms, 0)
    qwt = torch.where(ok, qw.to(ft) * step[t].to(ft), 0.0).to(ft)
    B, Tq = terms.shape
    lens = torch.where(ok, counts[t], 0)
    doc_key = Q8.DOC_MASK - torch.arange(n_docs, device=dev)
    out_s, out_i, out_f = [], [], []
    for b0 in range(0, B, block):
        b1 = min(B, b0 + block)
        b = b1 - b0
        L = lens[b0:b1].reshape(-1)
        E = int(L.sum())
        seg = torch.repeat_interleave(torch.arange(L.numel(), device=dev), L, output_size=E)
        first = torch.cumsum(L, 0) - L
        pos = off[t[b0:b1].reshape(-1)][seg] + torch.arange(E, device=dev) - first[seg]
        contrib = imp[pos].to(ft) * qwt[b0:b1].reshape(-1)[seg]
        flat = (seg // Tq) * n_docs + docs[pos]
        # a doc's contributions are a few dozen floats of one sign within
        # 2^29 of each other, so their float64 sum is exact in any order
        acc = torch.zeros(b * n_docs, dtype=torch.float64, device=dev)
        acc.index_add_(0, flat, contrib.to(torch.float64))
        hit = torch.zeros(b * n_docs, dtype=torch.bool, device=dev)
        hit[flat] = True
        score = acc.view(b, n_docs).to(ft).to(torch.float32)
        hit = hit.view(b, n_docs)
        del acc
        # sums are >= 0, so their f32 bits order as their values
        key = torch.where(hit, (score.view(torch.int32).to(torch.int64) << SCORE_SHIFT)
                          | doc_key, -1)
        top = torch.topk(key, min(k, n_docs), dim=1).values
        real = top >= 0
        ids = torch.where(real, Q8.DOC_MASK - (top & Q8.DOC_MASK), -1)
        fall = torch.zeros(b, dtype=torch.float64, device=dev)
        if picks is not None:
            p = picks[b0:b1].to(dev, torch.int64)
            p_real = p >= 0
            p_safe = p.clamp_min(0)
            p_key = torch.where(p_real, torch.gather(key, 1, p_safe), -1)
            n_ref = real.sum(1)
            at_k = ids.gather(1, (n_ref - 1).clamp_min(0)[:, None]).clamp_min(0)
            best = score.gather(1, ids[:, :1].clamp_min(0)).double().squeeze(1).clamp_min(1e-30)
            s_k = score.gather(1, at_k).double()
            p_s = torch.where(p_real, score.gather(1, p_safe).double(), float("inf"))
            fall = torch.clamp((s_k - p_s).amax(1) / best, min=0.0)
            srt = torch.sort(torch.where(p_real, p, -1 - torch.arange(p.shape[1], device=dev)),
                             dim=1).values
            dup = (srt[:, 1:] == srt[:, :-1]).any(1)
            bad = dup | (p_real.sum(1) != n_ref) | ((p_key < 0) & p_real).any(1)
            fall = torch.where(bad, float("inf"), fall)
            # a standing pick: its docs, ordered by the reference's own keys
            p_top = torch.sort(p_key, dim=1, descending=True).values[:, :top.shape[1]]
            p_top = torch.nn.functional.pad(p_top, (0, top.shape[1] - p_top.shape[1]), value=-1)
            top = torch.where((fall <= band)[:, None], p_top, top)
            real = top >= 0
            ids = torch.where(real, Q8.DOC_MASK - (top & Q8.DOC_MASK), -1)
        del key
        sc = (top >> SCORE_SHIFT).to(torch.int32).view(torch.float32)
        out_i.append(ids)
        out_s.append(torch.where(real, sc, float("-inf")).to(ft))
        out_f.append(fall)
    return torch.cat(out_s), torch.cat(out_i), torch.cat(out_f)


def run(data: dict, i: int, cell: dict, ft=torch.float32) -> dict:
    """The reference's answers for pool batch i. -> {"ids", "scores": the
    whole fused ranking, "qpp": [5, B, 13]}."""
    C.exact_float32()
    cfg = cell["config"]
    k, n = cfg["k"], cfg["docs"]
    band = float(cell["limits"]["sparse_tie_band"])
    bt, bq, st, sq, q_emb, proj, text = data["batches"][i]
    grids = data.setdefault("_grids", {})
    views = []
    for name, terms, qw in (("bm25", bt, bq), ("splade", st, sq)):
        if name not in grids:
            grids[name] = Q8.term_grid(data[name])
        s, ids, _ = sparse_view(data[name], grids[name], terms, qw, n, k, ft,
                                picks=data["picks"][i][name], band=band)
        views.append((s, ids))
    qi, qs = C.quantize_rows(q_emb.to(torch.float32))
    ds, di = C.group_max_topk(qi, data["rows"], k, row_scale=data["d_scale"])
    views.append(((ds * qs).to(ft), di))
    qv = torch.einsum("bd,vdw->vbw", q_emb.to(torch.float32), proj.to(torch.float32))
    for v in range(qv.shape[0]):
        views.append(Q8.rerank(qv[v], views[0][1], data["rows"], data["d_scale"], ft))
    vals = torch.stack([s for s, _ in views])
    ids = torch.stack([x for _, x in views])
    return C.fuse_views(ids, vals, text, cfg["qpp_index"])
