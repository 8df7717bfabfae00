"""Plain reference of the rank-safe ensemble step (q8r with a dense rescore
pool), from the benchmark's own data: the postings cut to each term's top
p_cap (what the q8 windows read), the full postings (what the doc vectors
hold), the int8 rows with their scales and the bf16 rows; never from the
program's packed index or doc vectors.

Sparse views (BM25, SPLADE). The pool: the q8 sums of reference/ensemble.py
over the cut lists, the top `sparse_candidates` by sum. Where tied sums
straddle the pool's edge, the higher doc id goes first: the program's
documented order (ops/sparse.py:_bitonic_pool takes tied sums highest
position first, and a q8 row's runs lie in ascending doc order). Each
pooled doc is scored from the full lists under the published rule: the
doc's doc_cap heaviest terms, equal weights by ascending term; each weight
quantized per doc to imp_bits against the doc's largest (scale = largest /
(2^imp_bits - 1), impact = round-half-even(weight / scale)); score = scale
x sum over the kept terms of impact x the weight of each query slot that
holds the term (a term twice in a query counts twice, as its window does in
the q8 sum). The top k follow, stable by score in pool order.

Dense view: the int8 group-max top `dense_rescore_pool` (common.group_max_topk),
rescored with both operands rounded to bf16 and f32 products and sums,
stable by score; the top k follow. Rerank views: BM25's top k rescored by
each projected query over the bf16 rows, the same way. Then QPP and fusion
(common.fuse_views).

Departures from the published description (bench.py's rank_safe_qps, the
JAX package's q8r): the doc-major table is built here by sorting, not
packed into (term << imp_bits | impact) words, and the sums run in another
order; the pool is selected exactly (the published TPU route takes a
bitonic pool, with the same tie order); the top k of a rescored pool take
ties in pool order, as lax.top_k does.
"""

from __future__ import annotations

import torch

from benchmark_torch.reference import common as C
from benchmark_torch.reference import ensemble as Q8

POOL_TIES_HIGH_DOC_FIRST = True    # the pool's order among tied q8 sums


def q8_pool(csr: dict, grid, terms: torch.Tensor, qw: torch.Tensor, n_docs: int,
            pool: int, ft, block: int = 64) -> torch.Tensor:
    """The top `pool` docs of each query by q8 sum over the cut lists (the
    sums of reference/ensemble.py:sparse_view), tied sums by doc id in
    POOL_TIES_HIGH_DOC_FIRST's order. -> ids int64 [B, pool] (-1 pad)."""
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
    doc = torch.arange(n_docs, device=dev)
    doc_key = doc if POOL_TIES_HIGH_DOC_FIRST else Q8.DOC_MASK - doc
    out = []
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
        key = torch.where(hit.view(b1 - b0, n_docs),
                          (acc.view(b1 - b0, n_docs) << Q8.SUM_SHIFT) | doc_key, -1)
        del acc, hit
        top = torch.topk(key, min(pool, n_docs), dim=1).values
        del key
        low = top & Q8.DOC_MASK
        ids = low if POOL_TIES_HIGH_DOC_FIRST else Q8.DOC_MASK - low
        out.append(torch.where(top >= 0, ids, -1))
    return torch.cat(out)


def doc_table(full: dict, n_docs: int, cap: int, bits: int):
    """Each doc's `cap` heaviest terms from the full lists (equal weights by
    ascending term), their weights quantized against the doc's largest.
    -> (terms int32 [N, cap] (-1 pad), impacts f32 [N, cap], scale f32 [N])."""
    off, docs, w = full["offsets"], full["docs"], full["weights"]
    dev = w.device
    top = torch.zeros(n_docs, dtype=torch.float32, device=dev).scatter_reduce(
        0, docs.to(torch.int64), w, reduce="amax", include_self=False)
    scale = torch.where(top > 0, top / torch.full_like(top, float((1 << bits) - 1)), 1.0)
    # heaviest first, equal weights in list order (ascending term), then by doc
    by_w = torch.sort(w, descending=True, stable=True).indices
    by_doc = by_w[torch.sort(docs[by_w], stable=True).indices]
    del by_w
    d = docs[by_doc].to(torch.int64)
    n_of = torch.bincount(d, minlength=n_docs)
    rank = torch.arange(d.numel(), device=dev) - (torch.cumsum(n_of, 0) - n_of)[d]
    keep = rank < cap
    sel, d, rank = by_doc[keep], d[keep], rank[keep]
    del by_doc, keep
    terms = torch.full((n_docs, cap), -1, dtype=torch.int32, device=dev)
    impacts = torch.zeros((n_docs, cap), dtype=torch.float32, device=dev)
    term = torch.searchsorted(off.to(torch.int64), sel, right=True) - 1
    terms[d, rank] = term.to(torch.int32)
    impacts[d, rank] = torch.clamp(torch.round(w[sel] / scale[d]), 0, (1 << bits) - 1)
    return terms, impacts, scale


def rescore_pool(table, ids: torch.Tensor, terms: torch.Tensor, qw: torch.Tensor, k: int, ft,
                 block: int = 128):
    """Each pooled doc scored from its table row, then the top k, stable by
    score in pool order. -> (scores [B, k] in ft (-inf pad), ids [B, k])."""
    t_tab, i_tab, scale = table
    dev = t_tab.device
    terms = terms.to(dev).long()
    qw = torch.where(terms >= 0, qw.to(dev, torch.float32), 0.0).to(ft)
    vals, out = [], []
    for b0 in range(0, ids.shape[0], block):
        b1 = min(ids.shape[0], b0 + block)
        cand = ids[b0:b1]
        safe = cand.clamp_min(0)
        rt = t_tab[safe].long()                              # [b, C, cap]
        weight = torch.zeros(rt.shape, dtype=ft, device=dev)
        for j in range(terms.shape[1]):
            hit = rt == terms[b0:b1, j, None, None]
            weight = weight + torch.where(hit, qw[b0:b1, j, None, None], 0.0)
        s = (i_tab[safe].to(ft) * weight).sum(-1) * scale[safe].to(ft)
        s = torch.where(cand >= 0, s, float("-inf")).to(ft)
        v, order = torch.sort(s, dim=-1, descending=True, stable=True)
        vals.append(v[:, :k])
        out.append(torch.gather(cand, -1, order)[:, :k])
    return torch.cat(vals), torch.cat(out)


def bf16_rescore(q: torch.Tensor, cand: torch.Tensor, rows16: torch.Tensor, ft):
    """Candidates scored over bf16 rows: bf16-rounded query, products and
    sums in ft; stable by score. -> (scores [B, C] desc, ids [B, C])."""
    safe = cand.clamp_min(0)
    qb = q.to(torch.bfloat16).to(ft)
    s = (rows16[safe].to(ft) * qb[:, None, :]).sum(-1)
    s = torch.where(cand >= 0, s, float("-inf")).to(ft)
    vals, order = torch.sort(s, dim=-1, descending=True, stable=True)
    return vals, torch.gather(cand, -1, order)


def run(data: dict, i: int, cell: dict, ft=torch.float32) -> dict:
    """The reference's answers for pool batch i. -> {"ids", "scores": the
    whole fused ranking, "qpp": [5, B, 13]}."""
    C.exact_float32()
    cfg, tr = cell["config"], cell["traffic"]
    k, n = cfg["k"], cfg["docs"]
    bt, bq, st, sq, q_emb, proj, text = data["batches"][i]
    grids = data.setdefault("_grids", {})
    tables = data.setdefault("_doc_tables", {})
    views = []
    for name, terms, qw in (("bm25", bt, bq), ("splade", st, sq)):
        if name not in grids:
            grids[name] = Q8.term_grid(data[name])
        if name not in tables:
            tables[name] = doc_table(data[f"{name}_full"], n, cfg["doc_cap"], cfg["imp_bits"])
        pool = q8_pool(data[name], grids[name], terms, qw, n, tr["sparse_candidates"], ft)
        views.append(rescore_pool(tables[name], pool, terms, qw, k, ft))
    q = q_emb.to(torch.float32)
    qi, _ = C.quantize_rows(q)
    _, di = C.group_max_topk(qi, data["rows"], tr["dense_rescore_pool"],
                             row_scale=data["d_scale"])
    ds, di = bf16_rescore(q, di, data["rerank_rows"], ft)
    views.append((ds[:, :k], di[:, :k]))
    qv = torch.einsum("bd,vdw->vbw", q, proj.to(torch.float32))
    for v in range(qv.shape[0]):
        views.append(bf16_rescore(qv[v], views[0][1], data["rerank_rows"], ft))
    vals = torch.stack([s for s, _ in views])
    ids = torch.stack([x for _, x in views])
    return C.fuse_views(ids, vals, text, cfg["qpp_index"])
