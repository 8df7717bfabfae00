"""The heterogeneous ensemble step, ``pipeline.ensemble.ensemble_retrieval_step``:
BM25 and SPLADE impact postings (presorted dual layout), an int8 dense
view, two BM25 -> dense rerank views, 13 QPP statistics per view and
RSD-weighted CombSUM.

Set-up: each view's postings are made on the card from the seed
(harness.gen.zipf_csr), cut to each term's impact top of p_cap postings
(what a window reads), and packed by the program's own host packer
(``ops.sparse.term_scales_from_csr`` and ``pack_postings_presorted``); the
int8 corpus is drawn on the card. Query terms and weights are host
tensors, as a tokenizer hands them over; embeddings and the rerank
projections live on the card.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from benchmark_torch.harness import gen as G

VIEWS = ("bm25", "splade")


def _sync(device) -> float:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


class EnsembleStep:
    """The step over one pool of batches. `parts` holds set-up seconds by
    part; `ref` what the plain reference needs (data, never program state)."""

    def __init__(self, cell: dict, seed: int, device, log):
        from qpp_fusion_rag_tpu_torch.ops.sparse import (
            pack_postings_presorted,
            term_scales_from_csr,
        )
        from qpp_fusion_rag_tpu_torch.pipeline import ensemble as E

        self.E = E
        cfg, tr = cell["config"], cell["traffic"]
        self.cfg, self.tr = cfg, tr
        n, dim, cap = cfg["docs"], cfg["dim"], cfg["p_cap"]
        self.parts = {}
        self.ref = {"device": device}
        cut = {}
        for view in VIEWS:
            v = cfg[view]
            t0 = _sync(device)
            csr = G.zipf_csr(n, v["vocab"], v["avg_doc_len"], v["zipf_a"], v["lognormal_sigma"],
                             v["k1"], v["b"], G.generator(device, seed, view), device)
            full = csr["docs"].numel()
            cut[view] = G.truncate_csr(csr, cap)
            del csr
            self.parts[f"{view}_postings_s"] = _sync(device) - t0
            log(f"{view}: {full} postings made on the card, {cut[view]['docs'].numel()} in "
                f"the p_cap {cap} windows")
            self.ref[view] = cut[view]
            self.ref[f"{view}_df"] = cut[view]["df"].cpu().numpy()

        t0 = time.perf_counter()
        host = {view: [cut[view][f].cpu().numpy() for f in ("offsets", "docs", "weights")]
                for view in VIEWS}

        def pack(view):
            """The program's host packer over one view's lists (numpy
            releases the interpreter lock in its sorts and gathers, so the
            two views pack side by side)."""
            off, docs, w = host[view]
            scales = term_scales_from_csr(w, off)
            return pack_postings_presorted(docs, w, off, cap=cap, scales=scales)

        with ThreadPoolExecutor(len(VIEWS)) as pool:
            packed = dict(zip(VIEWS, pool.map(pack, VIEWS)))
        t1 = time.perf_counter()
        sparse = {view: (torch.from_numpy(p).to(device), torch.from_numpy(sc).to(device),
                         torch.from_numpy(off2.astype(np.int32)).to(device))
                  for view, (p, off2, sc) in packed.items()}
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

    def __call__(self, i: int):
        """-> (fused_ids [B, k_out], fused_scores [B, k_out], qpp [5, B, 13])."""
        cfg = self.cfg
        return self.E.ensemble_retrieval_step(
            self.idx, *self.batches[i], k=cfg["k"], k_out=cfg["k_out"], p_cap=cfg["p_cap"],
            qpp_index=cfg["qpp_index"], sparse_mode=self.tr["mode"],
            sparse_presorted=cfg["presorted"])

    def release(self) -> None:
        """Drop the program's state (the packed postings); the data the
        reference reads stays."""
        self.idx = None


def build(cell: dict, seed: int, device, log) -> EnsembleStep:
    return EnsembleStep(cell, seed, device, log)
