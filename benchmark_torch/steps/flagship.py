"""The dense flagship step, ``pipeline.engine.fused_retrieval_step``: R
projected query views over one corpus (bf16 rows through K7, or int8 rows
with per-doc scales through K1), 13 QPP statistics per view normalized over
the batch, and RSD-weighted CombSUM.

Set-up: the corpus is drawn on the card from the seed in the traffic's
route; queries and the view projections are drawn on the card too, on the
grids of harness.gen, so the f32 projection is exact. Text features are
host tensors.
"""

from __future__ import annotations

import time

import torch

from benchmark_torch.harness import gen as G


def _sync(device) -> float:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


class FlagshipStep:
    def __init__(self, cell: dict, seed: int, device, log):
        from qpp_fusion_rag_tpu_torch.pipeline import engine

        self.engine = engine
        cfg, tr = cell["config"], cell["traffic"]
        self.cfg, self.tr = cfg, tr
        n, dim, dv, R = cfg["docs"], cfg["dim"], cfg["view_dim"], cfg["views"]
        self.route = tr["route"]
        self.parts = {}
        t0 = _sync(device)
        gen = G.generator(device, seed, "corpus")
        if self.route == "int8":
            self.corpus, self.scale = G.int8_rows(n, dv, gen, device)
        elif self.route == "bf16":
            self.corpus, self.scale = G.bf16_rows(n, dv, gen, device), None
        else:
            raise ValueError(f"unknown route {self.route!r}")
        self.parts["corpus_s"] = _sync(device) - t0
        log(f"corpus: {n} x {dv} {self.corpus.dtype} rows on the card")

        t0 = time.perf_counter()
        B = tr["batch"]
        self.view_proj = G.grid_projections((R, dim, dv), cfg["proj_scale"],
                                            G.generator(device, seed, "views"), device)
        gq = G.generator(device, seed, "embeddings")
        text = torch.tensor([cfg["text_feats"]], dtype=torch.float32).repeat(B, 1)
        self.batches = [(G.grid_queries((B, dim), gq, device), text) for _ in range(tr["pool"])]
        self.parts["queries_s"] = _sync(device) - t0
        self.queries_per_batch = B
        self.ref = {"device": device, "corpus": self.corpus, "scale": self.scale,
                    "route": self.route, "view_proj": self.view_proj, "batches": self.batches}

    def __call__(self, i: int):
        """-> (fused_ids [B, k_out], fused_scores [B, k_out], qpp [R, B, 13])."""
        q, text = self.batches[i]
        cfg = self.cfg
        return self.engine.fused_retrieval_step(
            q, self.view_proj, self.corpus, text, k=cfg["k"], k_out=cfg["k_out"],
            qpp_index=cfg["qpp_index"], use_pallas=self.route == "bf16",
            corpus_scale=self.scale)

    def release(self) -> None:
        """The corpus is data the reference reads; the step keeps no other
        state of the program's."""


def build(cell: dict, seed: int, device, log) -> FlagshipStep:
    return FlagshipStep(cell, seed, device, log)
