#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (qpp_fusion_rag_tpu_torch) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It builds the port's CUDA kernels from csrc/ (one nvcc per source, in
parallel, into build/torch_kernels/), builds the bench-scale synthetic index
on the host (2,621,440 docs, BM25 and SPLADE presorted postings at p_cap
2048, their doc-major term vectors at imp_bits 14 and doc_cap 128) and the
768-wide dense corpus on the card from a seed (int8 rows for the kernels,
bf16 rows of the same draws for the rank-safe rerank), holds each kernel
against its plain PyTorch version at the main paths' shapes, then drives
the ensemble step over three batches of 1024 queries in q8 mode and three
in rank-safe q8r mode (256 sparse candidates, a 128-doc dense pool), and
one q8r BM25 call at 8192 candidates (the pool's full-sort branch). Each
path checks that every kernel it runs launched, with the counts set to 0
just before it. Last, the kernel-bearing views are cross-checked against
the plain versions on CPU copies. Every phase raises on failure. The line
before the last is a JSON summary of the kernels; the last line is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Without a CUDA device, or without the package beside it, it exits non-zero
and prints no result. It imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
N_DOCS = 2_621_440
DIM = 768
BATCH = 1024
TOP_K = 100
P_CAP = 2048
BM25_TQ, SPLADE_TQ = 8, 16
BM25_VOCAB, SPLADE_VOCAB = 100_000, 30_000
DOC_CAP = 128
Q8R_CANDIDATES, DENSE_POOL = 256, 128
FALLBACK_CANDIDATES = 8192        # bs 16384: 2*bs > M = 16384 for BM25 -> K5
QUERY_SEEDS = ((1, 2), (3, 4), (5, 6))
CROSS_Q = 8
RTOL = 4e-6                       # f32 rescore / rerank sums in another order
CORPUS_CHUNK = 262_144
VIEWS = ("bm25", "splade")
DEVICE = "cuda"


def log(msg: str) -> None:
    print(msg, flush=True)


def median_ms(fn, reps: int) -> float:
    """Median device time of fn over reps calls (CUDA events), after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(statistics.median(times))


def host_build(n_docs: int):
    """Bench-scale synthetic BM25 + SPLADE indexes: presorted postings and
    doc-major vectors (the parameters of the JAX package's bench)."""
    from qpp_fusion_rag_tpu_torch.data import synthetic as S
    from qpp_fusion_rag_tpu_torch.ops.sparse import (
        doc_vector_imp_bits,
        pack_doc_vectors,
        pack_postings_presorted,
        term_scales_from_csr,
    )

    imp_bits = doc_vector_imp_bits(BM25_VOCAB)
    out = {"imp_bits": imp_bits}
    for name, vocab, avg_len, seed, zipf_a, max_post in (
            ("bm25", BM25_VOCAB, 30.0, 0, S.CALIBRATED_ZIPF_A_BM25, 80_000_000),
            ("splade", SPLADE_VOCAB, 40.0, 7, S.CALIBRATED_ZIPF_A_SPLADE, 60_000_000)):
        off, docs, w, _ = S.zipf_bm25_csr(
            n_docs, vocab_size=vocab, avg_doc_len=avg_len, seed=seed, zipf_a=zipf_a,
            lognormal_sigma=S.CALIBRATED_LOGNORMAL_SIGMA, max_postings=max_post)
        scales = term_scales_from_csr(w, off)
        packed, off2, _ = pack_postings_presorted(docs, w, off, cap=P_CAP, scales=scales)
        t0 = time.perf_counter()
        dp, dsc, td, tail = pack_doc_vectors(off, docs, w, n_docs, doc_cap=DOC_CAP,
                                             imp_bits=imp_bits, return_tail=True)
        log(f"  {name}: {len(docs)} postings -> {len(packed)} packed; doc vectors "
            f"[{n_docs}, {td}] imp_bits {imp_bits} in {time.perf_counter() - t0:.1f} s, "
            f"truncated {(tail > 0).mean() * 100:.2f}% of docs")
        out.update({f"{name}_packed": packed, f"{name}_scales": scales,
                    f"{name}_offsets": off2, f"{name}_csr_offsets": off,
                    f"{name}_doc_packed": dp, f"{name}_doc_scale": dsc})
    return out


def dense_corpus(n_docs: int, dev):
    """int8 [N, D] rows + per-doc scales, and bf16 [N, D] rows of the same
    seeded draws (the rank-safe rerank rows), made on the card."""
    from qpp_fusion_rag_tpu_torch.ops.kernels.dense_topk import quantize_rows

    gen = torch.Generator(device=dev).manual_seed(0)
    rows = torch.empty((n_docs, DIM), dtype=torch.int8, device=dev)
    rows_bf16 = torch.empty((n_docs, DIM), dtype=torch.bfloat16, device=dev)
    scale = torch.empty(n_docs, dtype=torch.float32, device=dev)
    for n0 in range(0, n_docs, CORPUS_CHUNK):
        n1 = min(n_docs, n0 + CORPUS_CHUNK)
        x = torch.randn((n1 - n0, DIM), generator=gen, device=dev)
        q, s = quantize_rows(x)
        rows[n0:n1] = q
        rows_bf16[n0:n1] = x
        scale[n0:n1] = s[:, 0]
    return rows, scale, rows_bf16


def make_batches(h, dev):
    from qpp_fusion_rag_tpu_torch.data.synthetic import zipf_queries

    gen = torch.Generator(device=dev).manual_seed(1)
    batches = []
    for s1, s2 in QUERY_SEEDS:
        bt, bq = zipf_queries(h["bm25_csr_offsets"], BATCH, n_terms=BM25_TQ, seed=s1)
        st, sq = zipf_queries(h["splade_csr_offsets"], BATCH, n_terms=SPLADE_TQ, seed=s2)
        q_emb = torch.randn((BATCH, DIM), generator=gen, device=dev)
        proj = torch.randn((2, DIM, DIM), generator=gen, device=dev) * 0.05
        tf = np.tile(np.array([6.0, 6.0, 9.0, 5.0], np.float32), (BATCH, 1))
        batches.append(tuple(torch.as_tensor(x, device=dev) if not isinstance(x, torch.Tensor)
                             else x for x in (bt, bq, st, sq, q_emb, proj, tf)))
    return batches


def view_args(idx, view, fields=("packed", "offsets", "scales")):
    return [getattr(idx, f"{view}_{f}") for f in fields]


def kernels_vs_plain(idx, batch, imp_bits):
    """Each kernel against its plain version on the card, at the shapes the
    main paths give it (batch 0's real windows, keys, pools and rows).
    -> per-kernel {max_abs_err, ms, plain_ms}, both sparse views summed."""
    from qpp_fusion_rag_tpu_torch.ops import sparse as S
    from qpp_fusion_rag_tpu_torch.ops.kernels import bitonic, dense_topk, row_gather, window_gather

    bt, bq, st, sq, q_emb, _, _ = batch
    res = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0}
           for k in ("group_max_packed_int8", "bitonic_segsum_rows", "gather_windows",
                     "bitonic_topp_rows", "bitonic_sort_rows", "rescore_match")}

    def timed(name, kernel, plain, reps=10, plain_reps=10):
        res[name]["ms"] += median_ms(kernel, reps)
        res[name]["plain_ms"] += median_ms(plain, plain_reps)

    for view, terms, qw in (("bm25", bt, bq), ("splade", st, sq)):
        packed, offsets, scales = view_args(idx, view)
        starts = S.q8_windows(offsets, terms, P_CAP, packed.shape[0],
                              presorted=True)[0].reshape(-1).contiguous()
        got = window_gather.gather_windows(packed, starts, P_CAP)
        ref = window_gather.gather_windows_plain(packed, starts, P_CAP)
        if not torch.equal(got, ref):
            raise AssertionError(f"K3 gather_windows != plain ({view}, G={starts.numel()})")
        timed("gather_windows", lambda: window_gather.gather_windows(packed, starts, P_CAP),
              lambda: window_gather.gather_windows_plain(packed, starts, P_CAP))
        log(f"  K3 gather_windows {view} [G={starts.numel()}, cap={P_CAP}]: equal")

        keys, _, start_block = S._q8_keys(packed, offsets, scales, terms, qw, P_CAP,
                                          presorted=True)
        tq = terms.shape[1]
        sums, sids = bitonic.bitonic_segsum_rows(keys, start_block=start_block, max_run=tq)
        r_sums, r_sids = bitonic.bitonic_segsum_rows_plain(keys)
        real = r_sids < S.SID_INVALID
        if not torch.equal(sids, r_sids) or not torch.equal(sums[real], r_sums[real]):
            raise AssertionError(f"K2 bitonic_segsum_rows != plain ({view}, {tuple(keys.shape)})")
        r = res["bitonic_segsum_rows"]
        r["max_abs_err"] = max(r["max_abs_err"], float((sums - r_sums)[real].abs().max()),
                               float((sids - r_sids).abs().max()))
        timed("bitonic_segsum_rows", lambda: bitonic.bitonic_segsum_rows(
            keys, start_block=start_block, max_run=tq),
            lambda: bitonic.bitonic_segsum_rows_plain(keys))
        log(f"  K2 bitonic_segsum_rows {view} {tuple(keys.shape)} start_block="
            f"{start_block} max_run={tq}: sids equal, sums equal on real positions "
            f"({int(real.sum())} of {real.numel()}; pads equal too: "
            f"{torch.equal(sums, r_sums)})")

        # the q8r pool keys of this batch: (sum << 16 | position), -1 off runs
        sums, sids, wmax = S._q8_row_sums(packed, offsets, scales, terms, qw, P_CAP,
                                          presorted=True)
        pkeys = S._pool_keys(sums)
        got = bitonic.bitonic_topp_rows(pkeys, bs=1024)
        if not torch.equal(got, bitonic.bitonic_topp_rows_plain(pkeys, 1024)):
            raise AssertionError(f"K4 bitonic_topp_rows != plain ({view}, {tuple(pkeys.shape)})")
        timed("bitonic_topp_rows", lambda: bitonic.bitonic_topp_rows(pkeys, bs=1024),
              lambda: bitonic.bitonic_topp_rows_plain(pkeys, 1024))
        log(f"  K4 bitonic_topp_rows {view} {tuple(pkeys.shape)} bs=1024: equal "
            f"({int((pkeys >= 0).sum())} run keys)")
        got = bitonic.bitonic_sort_rows(pkeys)
        if not torch.equal(got, bitonic.bitonic_sort_rows_plain(pkeys)):
            raise AssertionError(f"K5 bitonic_sort_rows != plain ({view}, {tuple(pkeys.shape)})")
        timed("bitonic_sort_rows", lambda: bitonic.bitonic_sort_rows(pkeys),
              lambda: bitonic.bitonic_sort_rows_plain(pkeys))
        log(f"  K5 bitonic_sort_rows {view} {tuple(pkeys.shape)}: equal")

        _, ci, _ = S._bitonic_pool(sums, sids, Q8R_CANDIDATES, wmax)
        dp = getattr(idx, f"{view}_doc_packed")
        qwz = torch.where(terms >= 0, qw, 0.0)
        args = (dp, ci, terms, qwz, imp_bits)
        got = row_gather.rescore_match(*args)
        ref = row_gather.rescore_match_plain(*args)
        torch.testing.assert_close(got, ref, rtol=RTOL, atol=0,
                                   msg=lambda m: f"K6 rescore_match != plain ({view}): {m}")
        r = res["rescore_match"]
        r["max_abs_err"] = max(r["max_abs_err"], float((got - ref).abs().max()))
        timed("rescore_match", lambda: row_gather.rescore_match(*args),
              lambda: row_gather.rescore_match_plain(*args), plain_reps=5)
        log(f"  K6 rescore_match {view} ids {tuple(ci.shape)} over {tuple(dp.shape)}: "
            f"within rtol {RTOL} (max rel err "
            f"{float(((got - ref).abs() / ref.abs().clamp_min(1e-30)).max()):.3g})")

    q_int, _ = dense_topk.quantize_rows(q_emb)
    args = (q_int, idx.corpus_rows, idx.d_scale)
    got = dense_topk.group_max_packed_int8(*args)
    ref = dense_topk.group_max_packed_int8_plain(*args, idx.corpus_rows.shape[0])
    if not torch.equal(got.view(torch.int32), ref.view(torch.int32)):
        raise AssertionError("K1 group_max_packed_int8 != plain (int32 bit patterns)")
    r = res["group_max_packed_int8"]
    r["max_abs_err"] = float((got - ref).abs().max())
    timed("group_max_packed_int8", lambda: dense_topk.group_max_packed_int8(*args),
          lambda: dense_topk.group_max_packed_int8_plain(*args, idx.corpus_rows.shape[0]),
          reps=5, plain_reps=3)
    log(f"  K1 group_max_packed_int8 {tuple(q_int.shape)} x {tuple(idx.corpus_rows.shape)}"
        f" -> {tuple(got.shape)}: equal as int32 bit patterns")
    for name, r in res.items():
        log(f"  {name}: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms per step")
    return res


def check_step_output(out, n_docs):
    fused_ids, fused_scores, qpp = out
    shapes = [tuple(x.shape) for x in out]
    if shapes != [(BATCH, TOP_K), (BATCH, TOP_K), (5, BATCH, 13)]:
        raise AssertionError(f"unexpected output shapes {shapes}")
    if not torch.isfinite(qpp).all():
        raise AssertionError("non-finite QPP values")
    valid = fused_ids >= 0
    if not valid.any(dim=1).all():
        raise AssertionError("a query fused to no documents")
    if int(fused_ids.max()) >= n_docs:
        raise AssertionError("fused id beyond the corpus")
    s = torch.where(valid, fused_scores, float("-inf"))
    if (s[:, 1:] > s[:, :-1]).any():
        raise AssertionError("fused scores increase along a row")
    srt = torch.sort(torch.where(valid, fused_ids, -1 - torch.arange(
        TOP_K, device=fused_ids.device)), dim=1).values
    if (srt[:, 1:] == srt[:, :-1]).any():
        raise AssertionError("duplicate fused ids in a row")


def run_path(name, idx, batches, smi, expect, **kw):
    """Drive ensemble_retrieval_step over the batches with the launch
    counts set to 0 just before; check the outputs and that every kernel in
    `expect` launched. -> (launch counts, per-batch ms)."""
    from qpp_fusion_rag_tpu_torch.ops.kernels import LAUNCHES
    from qpp_fusion_rag_tpu_torch.pipeline.ensemble import ensemble_retrieval_step

    LAUNCHES.clear()
    outs, step_ms = [], []
    for i, batch in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = ensemble_retrieval_step(idx, *batch, k=TOP_K, k_out=TOP_K, p_cap=P_CAP,
                                      sparse_presorted=True, **kw)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        outs.append(out)
        log(f"  {name} batch {i}: {step_ms[-1]:.1f} ms -> {BATCH / step_ms[-1] * 1e3:.0f} q/s "
            f"({smi})")
    launches = dict(LAUNCHES)
    log(f"  launches during the {name} path: {launches}")
    missing = [k for k in expect if launches.get(k, 0) < 1]
    if missing:
        raise AssertionError(f"kernels of the {name} path never launched: {missing}")
    for out in outs:
        check_step_output(out, idx.corpus_rows.shape[0])
    log("  outputs: shapes, finite QPP, non-increasing fused scores, unique ids < N: ok")
    return launches, step_ms


def assert_close_ranking(g_s, g_i, c_s, c_i, what):
    """Scores within RTOL; ids equal except adjacent swaps whose scores
    differ by less than RTOL (sums taken in another order)."""
    torch.testing.assert_close(g_s, c_s, rtol=RTOL, atol=0, msg=lambda m: f"{what}: {m}")
    g_i, c_i, g_s = g_i.tolist(), c_i.tolist(), g_s.tolist()
    for b in range(len(g_i)):
        i = 0
        while i < len(g_i[b]):
            if g_i[b][i] == c_i[b][i]:
                i += 1
                continue
            if not (i + 1 < len(g_i[b]) and g_i[b][i] == c_i[b][i + 1]
                    and g_i[b][i + 1] == c_i[b][i]
                    and abs(g_s[b][i] - g_s[b][i + 1]) <= RTOL * abs(g_s[b][i])):
                raise AssertionError(f"{what}: ids differ at query {b}, rank {i}")
            i += 2


def main() -> None:
    if not (ROOT / "qpp_fusion_rag_tpu_torch" / "__init__.py").is_file():
        raise SystemExit("chip_smoke.py: no qpp_fusion_rag_tpu_torch package beside "
                         "this script; run it from the root of a checkout")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch.cuda.is_available() is False; "
                         "this check runs only on an NVIDIA GPU")
    sys.path.insert(0, str(ROOT))
    from qpp_fusion_rag_tpu_torch.ops import sparse as S
    from qpp_fusion_rag_tpu_torch.ops.kernels import LAUNCHES, _build, dense_topk
    from qpp_fusion_rag_tpu_torch.pipeline.ensemble import dense_view_rescored
    from qpp_fusion_rag_tpu_torch.pipeline.interop import indexes_from_numpy

    t_all = time.perf_counter()
    dev = torch.device(DEVICE)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    card = torch.cuda.get_device_name(0)
    log(f"[1] card: {smi}")
    log(f"    torch {torch.__version__}, CUDA {torch.version.cuda}, {card}, "
        f"{torch.cuda.device_count()} device(s)")
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on; the f32 reference paths need them off")

    path, build_s, build_log = _build.build_library()
    _build.load_library()
    log(f"[2] kernels built in {build_s:.1f} s (one nvcc per source, in parallel) -> "
        f"{path.relative_to(ROOT)}")
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log(f"    ptxas: {line.strip()}")

    t0 = time.perf_counter()
    h = host_build(N_DOCS)
    host_s = time.perf_counter() - t0
    imp_bits = h["imp_bits"]
    t0 = time.perf_counter()
    rows, scale, rows_bf16 = dense_corpus(N_DOCS, dev)
    idx = indexes_from_numpy({f"{v}_{f}": h[f"{v}_{f}"] for v in VIEWS
                              for f in ("packed", "scales", "offsets")}
                             | {"corpus_rows": rows, "d_scale": scale}, dev)
    idx_rs = idx._replace(rerank_rows=rows_bf16, doc_imp_bits=imp_bits, **{
        f"{v}_{f}": torch.as_tensor(h[f"{v}_{f}"], device=dev)
        for v in VIEWS for f in ("doc_packed", "doc_scale")})
    torch.cuda.synchronize()
    log(f"[3] host build {host_s:.1f} s (n_docs {N_DOCS}, no cut); dense corpus "
        f"{tuple(rows.shape)} int8 + bf16 rerank rows + index upload "
        f"{time.perf_counter() - t0:.1f} s")
    batches = make_batches(h, dev)
    del h

    log("[4] kernels vs plain versions on the card, main-path shapes")
    res = kernels_vs_plain(idx_rs, batches[0], imp_bits)

    q8_kernels = ("group_max_packed_int8", "bitonic_segsum_rows", "gather_windows")
    log(f"[5] q8 path: ensemble_retrieval_step (q8, presorted) over {len(batches)} batches "
        f"of {BATCH} queries, {N_DOCS} docs")
    q8_launches, q8_ms = run_path("q8", idx, batches, smi, q8_kernels, sparse_mode="q8")

    q8r_kernels = q8_kernels + ("bitonic_topp_rows", "rescore_match")
    log(f"[6] q8r path: ensemble_retrieval_step (q8r, {Q8R_CANDIDATES} candidates, dense "
        f"pool {DENSE_POOL}, bf16 rerank rows, doc_imp_bits {imp_bits}) over "
        f"{len(batches)} batches of {BATCH} queries, {N_DOCS} docs")
    q8r_launches, q8r_ms = run_path(
        "q8r", idx_rs, batches, smi, q8r_kernels, sparse_mode="q8r",
        sparse_candidates=Q8R_CANDIDATES, dense_rescore_pool=DENSE_POOL,
        doc_imp_bits=imp_bits)

    log(f"[7] q8r pool fallback: one BM25 sparse_score_topk_q8_rescored call at "
        f"{FALLBACK_CANDIDATES} candidates (bs 16384, 2*bs > M = {BM25_TQ * P_CAP})")
    bt, bq, st, sq, q_emb, _, _ = batches[0]
    bm25_rs = view_args(idx_rs, "bm25", ("packed", "offsets", "scales", "doc_packed",
                                         "doc_scale"))
    fb_kw = dict(k=TOP_K, p_cap=P_CAP, candidates=FALLBACK_CANDIDATES, imp_bits=imp_bits,
                 presorted=True)
    LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fb_s, fb_i = S.sparse_score_topk_q8_rescored(*bm25_rs, bt, bq, **fb_kw)
    torch.cuda.synchronize()
    fb_ms = (time.perf_counter() - t0) * 1e3
    fb_launches = dict(LAUNCHES)
    log(f"  {fb_ms:.1f} ms; launches: {fb_launches}")
    if fb_launches.get("bitonic_sort_rows", 0) < 1 or fb_launches.get("bitonic_topp_rows", 0):
        raise AssertionError(f"the fallback call did not take the K5 pool: {fb_launches}")

    log(f"[8] cross-check of the kernel views for {CROSS_Q} queries on CPU copies")
    for view, terms, qw in (("bm25", bt, bq), ("splade", st, sq)):
        c = [x.cpu() for x in view_args(idx_rs, view, ("packed", "offsets", "scales",
                                                       "doc_packed", "doc_scale"))]
        ct, cq = terms[:CROSS_Q].cpu(), qw[:CROSS_Q].cpu()
        g_s, g_i = S.sparse_score_topk_q8(*view_args(idx_rs, view), terms, qw,
                                          k=TOP_K, p_cap=P_CAP, presorted=True)
        c_s, c_i = S.sparse_score_topk_q8(*c[:3], ct, cq, k=TOP_K, p_cap=P_CAP, presorted=True)
        if not (torch.equal(g_i[:CROSS_Q].cpu(), c_i) and torch.equal(g_s[:CROSS_Q].cpu(), c_s)):
            raise AssertionError(f"{view} q8 view: card and CPU disagree")
        rs_kw = dict(k=TOP_K, p_cap=P_CAP, candidates=Q8R_CANDIDATES, imp_bits=imp_bits,
                     presorted=True)
        g_s, g_i = S.sparse_score_topk_q8_rescored(
            *view_args(idx_rs, view, ("packed", "offsets", "scales", "doc_packed",
                                      "doc_scale")), terms, qw, **rs_kw)
        c_s, c_i = S.sparse_score_topk_q8_rescored(*c, ct, cq, **rs_kw)
        assert_close_ranking(g_s[:CROSS_Q].cpu(), g_i[:CROSS_Q].cpu(), c_s, c_i,
                             f"{view} q8r view")
        if view == "bm25":
            c_s, c_i = S.sparse_score_topk_q8_rescored(*c, ct, cq, **fb_kw)
            assert_close_ranking(fb_s[:CROSS_Q].cpu(), fb_i[:CROSS_Q].cpu(), c_s, c_i,
                                 "bm25 q8r fallback (K5 pool)")
        del c
    c_rows, c_scale = idx_rs.corpus_rows.cpu(), idx_rs.d_scale.cpu()
    g_s, g_i = dense_topk.dense_topk_int8(q_emb, idx_rs.corpus_rows, idx_rs.d_scale, k=TOP_K)
    c_s, c_i = dense_topk.dense_topk_int8(q_emb[:CROSS_Q].cpu(), c_rows, c_scale, k=TOP_K)
    if not (torch.equal(g_i[:CROSS_Q].cpu(), c_i) and torch.equal(g_s[:CROSS_Q].cpu(), c_s)):
        raise AssertionError("dense view: card and CPU disagree")
    c_bf16 = idx_rs.rerank_rows.cpu()
    g_s, g_i = dense_view_rescored(q_emb, idx_rs.corpus_rows, idx_rs.d_scale,
                                   idx_rs.rerank_rows, TOP_K, DENSE_POOL)
    c_s, c_i = dense_view_rescored(q_emb[:CROSS_Q].cpu(), c_rows, c_scale, c_bf16, TOP_K,
                                   DENSE_POOL)
    assert_close_ranking(g_s[:CROSS_Q].cpu(), g_i[:CROSS_Q].cpu(), c_s, c_i,
                         "dense_view_rescored")
    del c_rows, c_bf16
    log(f"  q8 views and dense view equal; q8r views, the K5 fallback and the rescored "
        f"dense view within rtol {RTOL} (ids up to near-tie swaps)")
    log("  cross-check ok")

    src = "qpp_fusion_rag_tpu_torch/csrc/"
    tpu = "qpp_fusion_rag_tpu/ops/pallas/"
    meta = {"group_max_packed_int8": (src + "dense_topk_int8.cu", tpu + "dense_topk.py:184"),
            "bitonic_segsum_rows": (src + "bitonic_segsum.cu", tpu + "bitonic.py:275"),
            "gather_windows": (src + "window_gather.cu", tpu + "window_gather.py:101"),
            "bitonic_topp_rows": (src + "bitonic_topp.cu", tpu + "bitonic.py:166"),
            "bitonic_sort_rows": (src + "bitonic_sort.cu", tpu + "bitonic.py:93"),
            "rescore_match": (src + "rescore_match.cu", tpu + "row_gather.py:122")}
    paths = {"q8": q8_launches, "q8r": q8r_launches, "q8r_fallback": fb_launches}
    kernels = []
    for name, (source, replaces) in meta.items():
        main_path = "q8r_fallback" if name == "bitonic_sort_rows" else "q8r"
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": paths[main_path].get(name, 0),
                        "path": main_path,
                        "launches_by_path": {p: c.get(name, 0) for p, c in paths.items()},
                        "max_abs_err": res[name]["max_abs_err"], "ms": res[name]["ms"],
                        "plain_ms": res[name]["plain_ms"]})
    log(f"  total {time.perf_counter() - t_all:.1f} s; q8 step ms {q8_ms}; q8r step ms "
        f"{q8r_ms}; fallback call {fb_ms:.1f} ms; host build {host_s:.1f} s; kernel "
        f"build {build_s:.1f} s; {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
