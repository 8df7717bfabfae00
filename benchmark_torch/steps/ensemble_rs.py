"""The rank-safe ensemble step, ``pipeline.ensemble.ensemble_retrieval_step``
in ``sparse_mode="q8r"`` with a dense rescore pool: each sparse view pools
its top candidates by q8 sums over the p_cap windows (K3, K2, K4) and
rescores every pooled doc against its doc vector (K6); the dense view
pools by the int8 group max (K1) and rescores the pool over bf16 rows; the
two rerank views score BM25's top k over the same bf16 rows; then 13 QPP
statistics per view and RSD-weighted CombSUM.

Set-up: the postings, queries and text features come from the same
harness.gen calls and sub-seeds as steps/ensemble.py, so the corpus is the
q8 cell's. Each view's doc vectors are packed on the card by the program's
``ops.sparse.pack_doc_vectors_device`` from the full lists, before those
are cut to each term's impact top of p_cap postings and packed by the
program's host packer (``pack_postings_presorted``). The dense rows are
drawn once in f32, chunk by chunk, as harness.gen.int8_rows draws them,
and give both the int8 rows with their scales and the bf16 rows.
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


def int8_and_bf16_rows(n: int, dim: int, gen: torch.Generator, device):
    """harness.gen.int8_rows' draws and quantization, plus each draw in bf16.
    -> (rows int8 [n, dim], scales f32 [n], rows bf16 [n, dim])."""
    rows = torch.empty((n, dim), dtype=torch.int8, device=device)
    scale = torch.empty(n, dtype=torch.float32, device=device)
    rows16 = torch.empty((n, dim), dtype=torch.bfloat16, device=device)
    for n0 in range(0, n, G.CORPUS_CHUNK):
        n1 = min(n, n0 + G.CORPUS_CHUNK)
        x = torch.randn((n1 - n0, dim), generator=gen, device=device)
        amax = x.abs().amax(dim=1, keepdim=True)
        s = torch.where(amax > 0, amax * (1.0 / 127.0), 1.0)
        rows[n0:n1] = torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)
        scale[n0:n1] = s[:, 0]
        rows16[n0:n1] = x
    return rows, scale, rows16


class EnsembleRsStep:
    """The step over one pool of batches. `parts` holds set-up seconds by
    part; `ref` what the plain reference needs (data, never program state)."""

    def __init__(self, cell: dict, seed: int, device, log):
        from qpp_fusion_rag_tpu_torch.ops.sparse import (
            pack_doc_vectors_device,
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
        cut, docvec = {}, {}
        for view in VIEWS:
            v = cfg[view]
            t0 = _sync(device)
            csr = G.zipf_csr(n, v["vocab"], v["avg_doc_len"], v["zipf_a"], v["lognormal_sigma"],
                             v["k1"], v["b"], G.generator(device, seed, view), device)
            t1 = _sync(device)
            dp, ds, td = pack_doc_vectors_device(csr["offsets"], csr["docs"], csr["weights"], n,
                                                 doc_cap=cfg["doc_cap"],
                                                 imp_bits=cfg["imp_bits"])
            t2 = _sync(device)
            docvec[view] = (dp, ds)
            cut[view] = G.truncate_csr(csr, cap)
            self.parts[f"{view}_postings_s"] = t1 - t0 + _sync(device) - t2
            self.parts[f"{view}_doc_vectors_s"] = t2 - t1
            log(f"{view}: {csr['docs'].numel()} postings made on the card, "
                f"{cut[view]['docs'].numel()} in the p_cap {cap} windows; doc vectors "
                f"[{n}, {td}] packed on the card in {t2 - t1:.3f} s")
            self.ref[view] = cut[view]
            self.ref[f"{view}_full"] = {f: csr[f] for f in ("offsets", "docs", "weights")}
            self.ref[f"{view}_df"] = cut[view]["df"].cpu().numpy()
            del csr

        t0 = time.perf_counter()
        host = {view: [cut[view][f].cpu().numpy() for f in ("offsets", "docs", "weights")]
                for view in VIEWS}

        def pack(view):
            """The program's host packer over one view's cut lists."""
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
        rows, d_scale, rows16 = int8_and_bf16_rows(n, dim, G.generator(device, seed, "corpus"),
                                                   device)
        self.parts["corpus_s"] = _sync(device) - t0
        self.ref.update(rows=rows, d_scale=d_scale, rerank_rows=rows16)
        self.idx = E.EnsembleIndexes(
            bm25_packed=sparse["bm25"][0], bm25_scales=sparse["bm25"][1],
            bm25_offsets=sparse["bm25"][2], splade_packed=sparse["splade"][0],
            splade_scales=sparse["splade"][1], splade_offsets=sparse["splade"][2],
            corpus_rows=rows, d_scale=d_scale, rerank_rows=rows16,
            bm25_doc_packed=docvec["bm25"][0], bm25_doc_scale=docvec["bm25"][1],
            splade_doc_packed=docvec["splade"][0], splade_doc_scale=docvec["splade"][1],
            doc_imp_bits=cfg["imp_bits"])

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
        cfg, tr = self.cfg, self.tr
        return self.E.ensemble_retrieval_step(
            self.idx, *self.batches[i], k=cfg["k"], k_out=cfg["k_out"], p_cap=cfg["p_cap"],
            qpp_index=cfg["qpp_index"], sparse_candidates=tr["sparse_candidates"],
            sparse_mode=tr["mode"], doc_imp_bits=cfg["imp_bits"],
            dense_rescore_pool=tr["dense_rescore_pool"], sparse_presorted=cfg["presorted"])

    def release(self) -> None:
        """Drop the program's state (the packed postings and doc vectors);
        the data the reference reads stays."""
        self.idx = None


def build(cell: dict, seed: int, device, log) -> EnsembleRsStep:
    return EnsembleRsStep(cell, seed, device, log)
