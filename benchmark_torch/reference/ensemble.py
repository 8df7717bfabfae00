"""Plain reference of the ensemble step in q8 mode, from the benchmark's
own data (the impact-ordered postings cut to each term's top p_cap, the
int8 rows and their scales), never from the program's packed index.

Sparse views (BM25, SPLADE), q8 semantics: a term's impacts quantize to
8 bits on its grid (largest impact / 255); a query term's weight is that
grid step times the query weight, and each contribution requantizes to
round(impact8 x weight / the query's largest weight); a doc's score is the
exact integer sum of its contributions over the query's terms times that
largest weight. The top k come by score, ties lowest doc id first: scores
accumulate per query over every doc (not by sorting the windows, as the
program does). Dense view: group_max_topk over the int8 rows (the query
quantized per row). Rerank views: BM25's top k rescored by each projected
query (both sides rounded to bf16, f32 products) times the doc's scale,
stable by score. Then QPP and fusion (common.fuse_views).
"""

from __future__ import annotations

import torch

from benchmark_torch.reference import common as C

SUM_SHIFT = 23                 # key = score sum << 23 | (2^23 - 1 - doc)
DOC_MASK = (1 << SUM_SHIFT) - 1


def term_grid(csr: dict):
    """-> (per-term step f32 [V], per-posting 8-bit impact f32 [P])."""
    off, w = csr["offsets"], csr["weights"]
    counts = off[1:] - off[:-1]
    term = torch.repeat_interleave(torch.arange(counts.numel(), device=w.device), counts,
                                   output_size=w.numel())
    top = torch.zeros(counts.numel(), dtype=torch.float32, device=w.device)
    top = top.scatter_reduce(0, term, w, reduce="amax")
    # a tensor divisor: a Python scalar one becomes a reciprocal multiply on
    # the card, one rounding off the grid the index was quantized on
    step = torch.where(top > 0, top / torch.full_like(top, 255.0), 1.0)
    imp = torch.clamp(torch.round(w / torch.clamp(step[term], min=1e-12)), 0, 255)
    return step, imp


def sparse_view(csr: dict, grid, terms: torch.Tensor, qw: torch.Tensor, n_docs: int,
                k: int, ft, block: int = 64):
    """-> (scores [B, k] in ft (-inf pad), ids int64 [B, k] (-1 pad))."""
    dev = csr["docs"].device
    step, imp = grid
    off, docs = csr["offsets"], csr["docs"].to(torch.int64)
    counts = off[1:] - off[:-1]
    terms = terms.to(dev).long()
    qw = qw.to(dev, torch.float32)
    ok = terms >= 0
    t = torch.where(ok, terms, 0)
    qwt = torch.where(ok, torch.clamp(qw.to(ft) * step[t].to(ft), min=0.0), 0.0)
    top_w = torch.clamp(qwt.amax(dim=1, keepdim=True), min=1e-30)
    ratio = (qwt / top_w).to(ft)
    B, Tq = terms.shape
    lens = torch.where(ok, counts[t], 0)
    out_s, out_i = [], []
    doc_key = DOC_MASK - torch.arange(n_docs, device=dev)
    for b0 in range(0, B, block):
        b1 = min(B, b0 + block)
        L = lens[b0:b1].reshape(-1)
        E = int(L.sum())
        seg = torch.repeat_interleave(torch.arange(L.numel(), device=dev), L, output_size=E)
        first = torch.cumsum(L, 0) - L
        pos = off[t[b0:b1].reshape(-1)][seg] + torch.arange(E, device=dev) - first[seg]
        q8 = torch.round(imp[pos].to(ft) * ratio[b0:b1].reshape(-1)[seg]).to(torch.int64)
        flat = (seg // Tq) * n_docs + docs[pos]
        acc = torch.zeros((b1 - b0) * n_docs, dtype=torch.int64, device=dev)
        acc.index_add_(0, flat, q8)
        hit = torch.zeros((b1 - b0) * n_docs, dtype=torch.bool, device=dev)
        hit[flat] = True
        key = torch.where(hit.view(b1 - b0, n_docs), (acc.view(b1 - b0, n_docs) << SUM_SHIFT)
                          | doc_key, -1)
        del acc, hit
        top = torch.topk(key, min(k, n_docs), dim=1).values
        del key
        real = top >= 0
        out_i.append(torch.where(real, DOC_MASK - (top & DOC_MASK), -1))
        sums = (top >> SUM_SHIFT).to(ft)
        out_s.append(torch.where(real, sums * top_w[b0:b1].to(ft), float("-inf")).to(ft))
    return torch.cat(out_s), torch.cat(out_i)


def rerank(qv: torch.Tensor, cand: torch.Tensor, rows: torch.Tensor, scale: torch.Tensor, ft):
    """BM25's candidates rescored: bf16-rounded query and rows, products
    and sums in ft, times the doc's scale; stable by score.
    -> (scores [B, K] desc, ids [B, K])."""
    safe = cand.clamp_min(0)
    qb = qv.to(torch.bfloat16).to(ft)
    cb = rows[safe].to(torch.bfloat16).to(ft)
    s = (cb * qb[:, None, :]).sum(-1) * scale[safe].to(ft)
    s = torch.where(cand >= 0, s, float("-inf")).to(ft)
    vals, order = torch.sort(s, dim=-1, descending=True, stable=True)
    return vals, torch.gather(cand, -1, order)


def run(data: dict, i: int, cell: dict, ft=torch.float32) -> dict:
    """The reference's answers for pool batch i. -> {"ids", "scores": the
    whole fused ranking, "qpp": [5, B, 13]}."""
    C.exact_float32()
    cfg = cell["config"]
    k, n = cfg["k"], cfg["docs"]
    bt, bq, st, sq, q_emb, proj, text = data["batches"][i]
    grids = data.setdefault("_grids", {})
    views = []
    for name, terms, qw in (("bm25", bt, bq), ("splade", st, sq)):
        if name not in grids:
            grids[name] = term_grid(data[name])
        views.append(sparse_view(data[name], grids[name], terms, qw, n, k, ft))
    qi, qs = C.quantize_rows(q_emb.to(torch.float32))
    ds, di = C.group_max_topk(qi, data["rows"], k, row_scale=data["d_scale"])
    views.append(((ds * qs).to(ft), di))
    qv = torch.einsum("bd,vdw->vbw", q_emb.to(torch.float32), proj.to(torch.float32))
    for v in range(qv.shape[0]):
        views.append(rerank(qv[v], views[0][1], data["rows"], data["d_scale"], ft))
    vals = torch.stack([s for s, _ in views])
    ids = torch.stack([x for _, x in views])
    return C.fuse_views(ids, vals, text, cfg["qpp_index"])
