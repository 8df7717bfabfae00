"""The ensemble step in its default sparse mode, ``pipeline.ensemble.
ensemble_retrieval_step(..., sparse_mode="sort")``, over the plain posting
layout: each sparse view reads, per query term, a window of the first
p_cap postings of the term's whole impact-ordered list (K3), sorts the
window pairs by doc id and sums each doc's f32 contributions as
differences of one blocked cumsum of the row, then takes the exact top k
of the run totals by a full-row sort; the int8 dense view, the two BM25 ->
dense rerank views, 13 QPP statistics per view and RSD-weighted CombSUM
follow, as in the q8 cell.

Set-up: the postings, the int8 corpus, the queries and the rerank
projections come from the same harness.gen calls and sub-seeds as
steps/ensemble.py, so the corpus is the q8 cell's. Each view's whole lists
are copied to the host and packed there by the program's own packer
(``ops.sparse.term_scales_from_csr`` and ``pack_postings``: the index a
deployment of this mode holds), the two views in two threads; the
reference reads the lists cut to each term's first p_cap postings
(harness.gen.truncate_csr), which is what the windows read.

The program's own pick of each sparse view's top k on each pool batch
(its sort-mode scorer, ``pipeline.ensemble.make_sparse_scorer("sort")``,
on the step's own inputs) is kept beside the data, once, at set-up: the
reference holds it to the tie band of its own sums, since the mode leaves
the order of tied sums open (reference/ensemble_plain.py).

The step itself, its call and its release are steps/ensemble.py's
(EnsembleStep, subclassed). Its set-up is repeated here, the postings and
the packing changed, because that file may not be edited.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from benchmark_torch.harness import gen as G
from benchmark_torch.steps.ensemble import VIEWS, EnsembleStep, _sync


class EnsemblePlainStep(EnsembleStep):
    """The step over one pool of batches. `parts` holds set-up seconds by
    part; `ref` what the plain reference needs: data, and the program's
    sparse picks ("picks": per pool batch, per view, ids [B, k] on the
    host), never program state."""

    def __init__(self, cell: dict, seed: int, device, log):
        from qpp_fusion_rag_tpu_torch.ops.sparse import pack_postings, term_scales_from_csr
        from qpp_fusion_rag_tpu_torch.pipeline import ensemble as E

        self.E = E
        cfg, tr = cell["config"], cell["traffic"]
        self.cfg, self.tr = cfg, tr
        n, dim, cap = cfg["docs"], cfg["dim"], cfg["p_cap"]
        self.parts = {}
        self.ref = {"device": device}
        host = {}
        for view in VIEWS:
            v = cfg[view]
            t0 = _sync(device)
            csr = G.zipf_csr(n, v["vocab"], v["avg_doc_len"], v["zipf_a"], v["lognormal_sigma"],
                             v["k1"], v["b"], G.generator(device, seed, view), device)
            cut = G.truncate_csr(csr, cap)
            t1 = _sync(device)
            host[view] = [csr[f].cpu().numpy() for f in ("offsets", "docs", "weights")]
            t2 = time.perf_counter()
            self.parts[f"{view}_postings_s"] = t1 - t0
            self.parts[f"{view}_to_host_s"] = t2 - t1
            log(f"{view}: {csr['docs'].numel()} postings made on the card, all packed; "
                f"{cut['docs'].numel()} in the p_cap {cap} windows")
            del csr
            self.ref[view] = cut
            self.ref[f"{view}_df"] = cut["df"].cpu().numpy()

        t0 = time.perf_counter()

        def pack(view):
            """The program's host packer over one view's whole lists (numpy
            releases the interpreter lock in its large element-wise passes,
            so the two views pack side by side)."""
            off, docs, w = host[view]
            scales = term_scales_from_csr(w, off)
            packed, scales = pack_postings(docs, w, off, scales=scales)
            return packed, scales, off

        with ThreadPoolExecutor(len(VIEWS)) as pool:
            packed = dict(zip(VIEWS, pool.map(pack, VIEWS)))
        t1 = time.perf_counter()
        sparse = {view: (torch.from_numpy(p).to(device), torch.from_numpy(sc).to(device),
                         torch.from_numpy(off.astype(np.int32)).to(device))
                  for view, (p, sc, off) in packed.items()}
        del packed, host
        self.parts["pack_host_s"] = t1 - t0
        self.parts["upload_s"] = _sync(device) - t1

        t0 = _sync(device)
        rows, d_scale = G.int8_rows(n, dim, G.generator(device, seed, "corpus"), device)
        self.parts["corpus_s"] = _sync(device) - t0
        self.ref.update(rows=rows, d_scale=d_scale)
        self.idx = E.EnsembleIndexes(
            bm25_packed=sparse["bm25"][0], bm25_scales=sparse["bm25"][1],
            bm25_offsets=sparse["bm25"][2], splade_packed=sparse["splade"][0],
            splade_scales=sparse["splade"][1], splade_offsets=sparse["splade"][2],
            corpus_rows=rows, d_scale=d_scale)

        t0 = time.perf_counter()
        B = tr["batch"]
        rng = np.random.default_rng(G.sub_seed(seed, "queries"))
        gq = G.generator(device, seed, "embeddings")
        self.rerank_proj = G.grid_projections((2, dim, dim), cfg["rerank_proj_scale"],
                                              G.generator(device, seed, "rerank"), device)
        text = torch.tensor([cfg["text_feats"]], dtype=torch.float32).repeat(B, 1)
        self.batches = []
        for _ in range(tr["pool"]):
            bt = G.zipf_queries(self.ref["bm25_df"], B, tr["bm25_terms"], rng,
                                tr["skip_top"], tr["min_df"])
            st = G.zipf_queries(self.ref["splade_df"], B, tr["splade_terms"], rng,
                                tr["skip_top"], tr["min_df"])
            self.batches.append((
                torch.from_numpy(bt), torch.ones(bt.shape, dtype=torch.float32),
                torch.from_numpy(st), torch.ones(st.shape, dtype=torch.float32),
                G.grid_queries((B, dim), gq, device), self.rerank_proj, text))
        self.parts["queries_s"] = _sync(device) - t0
        self.queries_per_batch = B
        self.ref.update(batches=self.batches, rerank_proj=self.rerank_proj)

        t0 = _sync(device)
        scorer = E.make_sparse_scorer("sort", 0, cfg["k"], cap)
        self.ref["picks"] = [
            {view: scorer(getattr(self.idx, f"{view}_packed"),
                          getattr(self.idx, f"{view}_offsets"),
                          getattr(self.idx, f"{view}_scales"),
                          terms.to(device, torch.int32), qw.to(device))[1].cpu()
             for view, terms, qw in (("bm25", bt, bq), ("splade", st, sq))}
            for bt, bq, st, sq, *_ in self.batches]
        self.parts["picks_s"] = _sync(device) - t0


def build(cell: dict, seed: int, device, log) -> EnsemblePlainStep:
    return EnsemblePlainStep(cell, seed, device, log)
