#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (qpp_fusion_rag_tpu_torch) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It checks what no test and no benchmark cell does: the kernels at full
size against their plain versions, and every path's outputs and launches.
Step times, traces and roofline shares are the benchmark's
(benchmark_torch/); the peak rates of the kernels' bounds come from its
benchmark_torch/harness/peaks.py.

It builds the port's CUDA kernels from csrc/ (one nvcc per source, in
parallel, into build/torch_kernels/), builds the bench-scale synthetic index
(2,621,440 docs; on the host the BM25 and SPLADE presorted postings at p_cap
2048 and the impact-ordered layout, on the card their doc-major term
vectors at imp_bits 14 and doc_cap 128 with their tails, packed by
pack_doc_vectors_device from the CSR moved there) and the 768-wide dense
corpus on the card from a seed (int8 rows for the kernels, bf16 rows of the
same draws for the rank-safe rerank and the dense flagship), holds each
kernel against its plain PyTorch version at the main paths' shapes (with its
time, its bound from those shapes and, where one PyTorch call computes the
same function, that call's time; K6 also with its matched-weight output at
the certified pool), then runs the ensemble step once over three batches of
1024 queries in q8 mode, in rank-safe q8r mode (256 sparse candidates, a
128-doc dense pool) and in certified q8c mode (the same, with the tails;
certified_frac on a line of its own), then checks the certificates of 8
queries per view against exhaustive float64 scores over the full CSR, makes
one q8c BM25 call on the f32 route (exact doc vectors), runs the three
batches in the default "sort" mode and one window-rescore step
(sparse_candidates 4) over the impact-ordered layout, one q8r BM25 call at
8192 candidates (the pool's full-sort branch), and one q8 and one q8r SPLADE
call of 32-term queries (rows of 65,536 keys: K2 on four-CTA clusters), with
K2, K4 and K5 then timed alone at those rows, and q8's top-k kernel (M3)
held to its plain version and timed on the run sums of batch 0's BM25 and
SPLADE queries and of the 32-term ones.
Between them (phase 6g) it drives the sparse index layer at full size:
SparseIndex over the BM25 CSR (docnos "d<i>", queries "q<i>" through the
query_encoder hook) with its lazy device arrays timed, search on the
"exact", "q8" and "q8r" engines (1024 queries, each bit-equal to the direct
ops/sparse.py call), search_certified on 32 queries (certified ones checked
against float64 exhaustive scores, escalated ones against the exhaustive
"exact" pass, whose peak memory it prints), SpladeIndex.search_impacts
(q8r), BM25Retriever.retrieve_batch (1024 queries), a TwoStageRetriever
over 64 queries with a dense reranker on the bf16 rows, autotune_sparse on
32 sample queries, and one build_bm25 of a small text corpus (the native
g++ build). The
registers and spill bytes that ptxas reported for the bitonic kernels (K2,
K4, K5), for K6 and for the wgmma group-max instances (K1, K7, K8 / K10, K9)
are printed after the build. The dense flagship follows (R = 5 views, 5,120
scoring rows per batch): K7-K10 against their plain versions on the full
corpus (K7 in both layouts; K1 again at the 5,120 rows, its maxima then
merged by the row top-k kernel, bit-equal to topk_first and timed beside it
and torch.topk at 5,120 and 1024 rows; K8 and K10 also at D 1024 on a
131,072-doc corpus), fused_retrieval_step over the three batches on the
int8 route (K1) and on the bf16 route (K7), learned-fusion calls, and one
full-size call of each dense entry point (K8 at stride 4, K9, K10). Each
path checks its outputs and that every kernel it runs launched, with the
counts set to 0 just before it. Last, the kernel-bearing views (the q8c
certificates and the f32 route too) and the flagship's runs and fused
outputs, and the index layer's "exact" and "q8" searches, are
cross-checked against the plain versions on CPU copies. Then phase [13]
trains: 4 learned_fusion_train_step calls at full width (the flagship's
5 views x 1024 queries over the bf16 corpus, chunk 8192; no kernel, as in
JAX), the same step on the card and on a CPU copy of the first 131,072
docs and 64 queries from the same parameters and Adam state, the trained
weights served by learned_fused_retrieval_step through K7, and
FusionMLP.train and PerRetrieverGBDT.fit with the config defaults on the
int8 route's raw QPP features of the three batches (80/20 split, seeded
soft targets), their card predictions held to CPU copies and to the host
traversal. Phase [14] drives the offline research path (stages 03-06 and
10) over runs the kernels make: the ensemble step's five views of the
three batches in q8 mode (K1, K2, K3) become a RunTensor [5, 3072, 100]
("BM25", "Splade", "BGE", "BM25_TCT", "BM25_MonoT5"; qids test0..test3071;
docnos doc<row>); it writes their TREC runs (raw and .norm.res), a
queries.jsonl, seeded qrels and a corpus .jsonl under build/, reads them
back through the loaders, runs the QPP stage (compute_qpp_dir), the six
fusion methods and combsum at the default depth (run_fusion), ten IR
metrics over the five views and six fused runs, the oracle, ProbFuse and
argmax-QPP baselines, and stage 04 (train_fusion_models, per_retriever and
mlp) with the learned method served from its pickle; QPP, fusion and
metrics are held to CPU copies. Every
phase raises on failure and prints its seconds. The line before the last
is a JSON summary of the ten kernels, the row top-k (M1) and the run-sum
kernels (M2, M3); the last line is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Without a CUDA device, or without the package beside it, it exits non-zero
and prints no result. It imports nothing of JAX.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from benchmark_torch.harness.peaks import HBM_BYTES_PER_S, PEAK_OPS_PER_S

ROOT = Path(__file__).resolve().parent
N_DOCS = 2_621_440
DIM = 768
BATCH = 1024
TOP_K = 100
P_CAP = 2048
TIE_REL_EPS = 1e-5                # the certified scorer's tie band (its default)
WINDOW_CANDIDATES = 4             # the window rescore's pool: 4 x TOP_K raw contributions
BM25_TQ, SPLADE_TQ = 8, 16
BM25_VOCAB, SPLADE_VOCAB = 100_000, 30_000
DOC_CAP = 128
Q8R_CANDIDATES, DENSE_POOL = 256, 128
FALLBACK_CANDIDATES = 8192        # bs 16384: 2*bs > M = 16384 for BM25 -> K5
QUERY_SEEDS = ((1, 2), (3, 4), (5, 6))
CROSS_Q = 8
RTOL = 4e-6                       # f32 rescore / rerank sums in another order
VIEWS_R = 5                       # dense flagship views (bench.py's view_proj)
MLP_SIZES = (VIEWS_R * 13, 32, 16, VIEWS_R)
PACK_RTOL = 2.0 ** -15            # one packing quantum (2^-16) + the sum order
ORDER_ATOL = 1e-6                 # x |q| max|c|: f32 sums of 768 products in another order
STEP_RTOL, STEP_ATOL = 2e-3, 1e-5  # card vs CPU flagship outputs (see flagship_cross_check)
SNQC, SNQC_ATOL = 10, 0.1         # snqc sums |s - mean|^0.109: near-tied scores make it
                                  # jump with the last bits of a score (not a fusion weight)
CORPUS_CHUNK = 262_144
VIEWS = ("bm25", "splade")
DEVICE = "cuda"
LONG_TQ = 32                      # a SPLADE query of 32 terms: M = 32 x 2048 = 65,536 keys
WIDE_DIM, WIDE_DOCS = 1024, 131_072   # K8 / K10 at the large BGE / e5 encoders' width
TRAIN_STEPS = 4                   # learned_fusion_train_step calls over the three batches
TRAIN_CHUNK = 8192                # JAX's default chunk of the training step
TRAIN_CUT_DOCS, TRAIN_CUT_Q = 131_072, 64   # the card-vs-CPU step check's cut
TRAIN_RTOL, TRAIN_ATOL = 1e-4, 1e-6   # f32 matmuls and sums in the card's order
PREDICT_RTOL, PREDICT_ATOL = 1e-5, 1e-6


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


def bound(nbytes: float, ops: float, kind: str):
    """The least time the card could take: the larger of the bytes the
    function must move over the HBM rate and its operations over the peak
    rate of their type. -> (ms, "bytes" or "operations")."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS_PER_S[kind] * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def template_args(mangled: str, at: int):
    """The template arguments of a mangled kernel name from position `at`
    (just after the name): integers (Li<n>E), bools (Lb<0|1>E) and types of
    the kernel's namespace (NS_<len><name>E). -> list of str, empty without
    a list."""
    args = []
    if not mangled.startswith("I", at):
        return args
    i = at + 1
    while i < len(mangled) and mangled[i] != "E":
        if m := re.match(r"L[ib](-?\d+)E", mangled[i:]):
            args.append(m.group(1))
        elif m := re.match(r"NS_(\d+)", mangled[i:]):
            n = int(m.group(1))
            args.append(mangled[i + m.end():i + m.end() + n])
            m = re.match(r"NS_\d+\w{%d}E" % n, mangled[i:])
        else:
            break
        i += m.end()
    return args


def ptxas_summary(build_log: str):
    """Registers and spill bytes that ptxas reported (-Xptxas -v) for each
    kernel of the bitonic sources (K2, K4, K5), of K6 and of the wgmma group
    max (K1, K7, K8 / K10, K9). -> {kernel<template args>: {"source",
    "registers", "stack", "spill_stores", "spill_loads"}}."""
    sources = ("bitonic_segsum.cu", "bitonic_topp.cu", "bitonic_sort.cu", "rescore_match.cu",
               "dense_topk_int8.cu", "group_max_packed.cu", "group_max_scores.cu",
               "group_max_int8_global.cu", "row_topk.cu", "run_sums_topk.cu")
    out, src, fn = {}, None, None
    for line in build_log.splitlines():
        if line.startswith("== "):
            src, fn = line[3:].strip(), None
        elif m := re.search(r"(?:Compiling entry function '|Function properties for )(\w+)", line):
            fn = m.group(1)
        if src not in sources or fn is None:
            continue
        name = re.search(r"([a-z_]+_kernel)", fn)
        if name is None:
            continue
        args = template_args(fn, name.end())
        key = name.group(1) + (f"<{', '.join(args)}>" if args else "")
        entry = out.setdefault(key, {"source": src})
        if m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line):
            entry.update(stack=int(m[1]), spill_stores=int(m[2]), spill_loads=int(m[3]))
        elif m := re.search(r"Used (\d+) registers", line):
            entry["registers"] = int(m[1])
    return out


def long_row_kernels(res, keys, start_block, pkeys, tq):
    """K2, K4 and K5 alone at rows of 65,536 keys (the SPLADE Tq 32 call's
    keys and pool keys), against their plain versions, bit for bit; their
    times, bounds and (K4) torch.topk's and (K5) torch.sort's times go into
    their entries of `res` as *_65536."""
    from qpp_fusion_rag_tpu_torch.ops import sparse as S
    from qpp_fusion_rag_tpu_torch.ops.kernels import bitonic

    B, M = keys.shape
    sums, sids = bitonic.bitonic_segsum_rows(keys, start_block=start_block, max_run=tq)
    r_sums, r_sids = bitonic.bitonic_segsum_rows_plain(keys)
    real = r_sids < S.SID_INVALID
    if not torch.equal(sids, r_sids) or not torch.equal(sums[real], r_sums[real]):
        raise AssertionError(f"K2 bitonic_segsum_rows != plain at {tuple(keys.shape)}")
    del sums, sids, r_sums, r_sids, real
    r = res["bitonic_segsum_rows"]
    r["ms_65536"] = median_ms(lambda: bitonic.bitonic_segsum_rows(
        keys, start_block=start_block, max_run=tq), 10)
    r["plain_ms_65536"] = median_ms(lambda: bitonic.bitonic_segsum_rows_plain(keys), 3)
    r["bound_ms_65536"] = bound(12 * B * M, 0, "int8")[0]
    got = bitonic.bitonic_topp_rows(pkeys, bs=1024)
    if not torch.equal(got, bitonic.bitonic_topp_rows_plain(pkeys, 1024)):
        raise AssertionError(f"K4 bitonic_topp_rows != plain at {tuple(pkeys.shape)}")
    r4 = res["bitonic_topp_rows"]
    r4["ms_65536"] = median_ms(lambda: bitonic.bitonic_topp_rows(pkeys, bs=1024), 10)
    r4["plain_ms_65536"] = median_ms(lambda: bitonic.bitonic_topp_rows_plain(pkeys, 1024), 3)
    r4["library_ms_65536"] = median_ms(lambda: torch.topk(pkeys, 1024, dim=-1), 10)
    r4["bound_ms_65536"] = bound(4 * B * (M + 1024), 0, "int8")[0]
    got = bitonic.bitonic_sort_rows(pkeys)
    if not torch.equal(got, bitonic.bitonic_sort_rows_plain(pkeys)):
        raise AssertionError(f"K5 bitonic_sort_rows != plain at {tuple(pkeys.shape)}")
    del got
    r5 = res["bitonic_sort_rows"]
    r5["ms_65536"] = median_ms(lambda: bitonic.bitonic_sort_rows(pkeys), 10)
    r5["plain_ms_65536"] = median_ms(lambda: bitonic.bitonic_sort_rows_plain(pkeys), 3)
    r5["library_ms_65536"] = median_ms(lambda: torch.sort(pkeys, dim=-1), 10)
    r5["bound_ms_65536"] = bound(8 * B * M, 0, "int8")[0]
    log(f"  K2 alone at {tuple(keys.shape)} start_block={start_block}: equal to plain; kernel "
        f"{r['ms_65536']:.3f} ms, plain {r['plain_ms_65536']:.3f} ms, bound "
        f"{r['bound_ms_65536']:.4f} ms (bytes)")
    log(f"  K4 alone at {tuple(pkeys.shape)} bs=1024: equal to plain "
        f"({int((pkeys >= 0).sum())} run keys); kernel {r4['ms_65536']:.3f} ms, plain "
        f"{r4['plain_ms_65536']:.3f} ms, torch.topk {r4['library_ms_65536']:.3f} ms, bound "
        f"{r4['bound_ms_65536']:.4f} ms (bytes)")
    log(f"  K5 alone at {tuple(pkeys.shape)}: equal to plain; kernel {r5['ms_65536']:.3f} ms, "
        f"plain {r5['plain_ms_65536']:.3f} ms, torch.sort {r5['library_ms_65536']:.3f} ms, bound "
        f"{r5['bound_ms_65536']:.4f} ms (bytes)")


def host_build(n_docs: int, dev):
    """Bench-scale synthetic BM25 + SPLADE indexes (the parameters of the
    JAX package's bench): on the host the presorted postings, the
    impact-ordered layout of the "sort" and window-rescore modes and the
    raw CSR (offsets, docs, f32 weights) of the soundness check; on `dev`
    the doc-major vectors with their tails, packed from the CSR moved
    there."""
    from qpp_fusion_rag_tpu_torch.data import synthetic as S
    from qpp_fusion_rag_tpu_torch.ops.sparse import (
        doc_vector_imp_bits,
        pack_doc_vectors_device,
        pack_postings,
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
        dp, dsc, td, tail = pack_doc_vectors_device(
            *(torch.from_numpy(x).to(dev) for x in (off, docs, w)), n_docs, doc_cap=DOC_CAP,
            imp_bits=imp_bits, return_tail=True)
        torch.cuda.synchronize()
        log(f"  {name}: {len(docs)} postings -> {len(packed)} packed; doc vectors "
            f"[{n_docs}, {td}] imp_bits {imp_bits} packed on the card in "
            f"{time.perf_counter() - t0:.2f} s, truncated "
            f"{float((tail > 0).float().mean()) * 100:.2f}% of docs")
        plain, _ = pack_postings(docs, w, off, scales=scales)
        out.update({f"{name}_packed": packed, f"{name}_scales": scales,
                    f"{name}_offsets": off2, f"{name}_csr_offsets": off,
                    f"{name}_doc_packed": dp, f"{name}_doc_scale": dsc, f"{name}_tail": tail,
                    f"{name}_plain_packed": plain, f"{name}_csr_docs": docs,
                    f"{name}_csr_w": w})
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
    main paths give it (batch 0's real windows, keys, pools and rows), with
    its bound from these shapes and, where one PyTorch call computes the
    same function (K3 an indexing gather, K4 torch.topk, K5 torch.sort), that
    call's time; the port never calls them. K2-K6 compare, exchange and
    gather on the CUDA cores out of shared memory, for which no peak rate is
    cited: their bound counts bytes only. -> per-kernel {max_abs_err, ms,
    plain_ms, bound_ms, bound_by, library_ms}, both sparse views summed."""
    from qpp_fusion_rag_tpu_torch.ops import sparse as S
    from qpp_fusion_rag_tpu_torch.ops.kernels import bitonic, dense_topk, row_gather, window_gather

    bt, bq, st, sq, q_emb, _, _ = batch
    res = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": None}
           for k in ("group_max_packed_int8", "bitonic_segsum_rows", "gather_windows",
                     "bitonic_topp_rows", "bitonic_sort_rows", "rescore_match")}
    work = {k: [0.0, 0.0] for k in res}      # bytes, int8 operations
    k6_q8c_bytes = [0.0, 0.0]                # K6 at q8c's pool: without, with the output

    def timed(name, kernel, plain, reps=10, plain_reps=10, library=None, nbytes=0, ops=0):
        res[name]["ms"] += median_ms(kernel, reps)
        res[name]["plain_ms"] += median_ms(plain, plain_reps)
        if library is not None:
            res[name]["library_ms"] = (res[name]["library_ms"] or 0.0) + median_ms(library, reps)
        work[name][0] += nbytes
        work[name][1] += ops

    for view, terms, qw in (("bm25", bt, bq), ("splade", st, sq)):
        packed, offsets, scales = view_args(idx, view)
        starts = S.q8_windows(offsets, terms, P_CAP, packed.shape[0],
                              presorted=True)[0].reshape(-1).contiguous()
        got = window_gather.gather_windows(packed, starts, P_CAP)
        ref = window_gather.gather_windows_plain(packed, starts, P_CAP)
        if not torch.equal(got, ref):
            raise AssertionError(f"K3 gather_windows != plain ({view}, G={starts.numel()})")
        gidx = starts.long()[:, None] + torch.arange(P_CAP, device=starts.device)
        timed("gather_windows", lambda: window_gather.gather_windows(packed, starts, P_CAP),
              lambda: window_gather.gather_windows_plain(packed, starts, P_CAP),
              library=lambda: packed[gidx], nbytes=starts.numel() * (4 + 8 * P_CAP))
        log(f"  K3 gather_windows {view} [G={starts.numel()}, cap={P_CAP}]: equal")

        keys, _, start_block = S._q8_keys(packed, offsets, scales, terms, qw, P_CAP,
                                          presorted=True)
        tq = terms.shape[1]
        B, M = keys.shape
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
            lambda: bitonic.bitonic_segsum_rows_plain(keys), nbytes=12 * B * M)
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
              lambda: bitonic.bitonic_topp_rows_plain(pkeys, 1024),
              library=lambda: torch.topk(pkeys, 1024, dim=-1),
              nbytes=4 * B * (M + 1024))
        log(f"  K4 bitonic_topp_rows {view} {tuple(pkeys.shape)} bs=1024: equal "
            f"({int((pkeys >= 0).sum())} run keys)")
        got = bitonic.bitonic_sort_rows(pkeys)
        if not torch.equal(got, bitonic.bitonic_sort_rows_plain(pkeys)):
            raise AssertionError(f"K5 bitonic_sort_rows != plain ({view}, {tuple(pkeys.shape)})")
        timed("bitonic_sort_rows", lambda: bitonic.bitonic_sort_rows(pkeys),
              lambda: bitonic.bitonic_sort_rows_plain(pkeys),
              library=lambda: torch.sort(pkeys, dim=-1), nbytes=8 * B * M)
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
        n_cand = int((ci >= 0).sum())
        timed("rescore_match", lambda: row_gather.rescore_match(*args),
              lambda: row_gather.rescore_match_plain(*args), plain_reps=5,
              nbytes=n_cand * dp.shape[1] * 4 + ci.numel() * 8 + terms.numel() * 8)
        log(f"  K6 rescore_match {view} ids {tuple(ci.shape)} over {tuple(dp.shape)}: "
            f"within rtol {RTOL} (max rel err "
            f"{float(((got - ref).abs() / ref.abs().clamp_min(1e-30)).max()):.3g})")

        # the q8c pool (bitonic pool of the plus_one bound sums) through
        # both K6 instances: with the matched-weight output, and without it
        sums, sids, wmax = S._q8_row_sums(packed, offsets, scales, terms, qw, P_CAP,
                                          presorted=True, plus_one=True)
        _, ci, _ = S._bitonic_pool(sums, sids, Q8R_CANDIDATES, wmax)
        args = (dp, ci, terms, qwz, imp_bits)
        got, got_m = row_gather.rescore_match(*args, return_matched=True)
        ref, ref_m = row_gather.rescore_match_plain(*args, return_matched=True)
        for what, a, b in (("sums", got, ref), ("matched weights", got_m, ref_m)):
            torch.testing.assert_close(a, b, rtol=RTOL, atol=0, msg=lambda m: (
                f"K6 rescore_match with its matched output != plain ({view}, {what}): {m}"))
        if not torch.equal(got, row_gather.rescore_match(*args)):
            raise AssertionError(f"K6's two instances give different sums ({view})")
        r = res["rescore_match"]
        r["max_abs_err_matched"] = max(r.get("max_abs_err_matched", 0.0),
                                       float((got - ref).abs().max()),
                                       float((got_m - ref_m).abs().max()))
        n_cand = int((ci >= 0).sum())
        k6_bytes = n_cand * dp.shape[1] * 4 + ci.numel() * 8 + terms.numel() * 8
        k6_q8c_bytes[0] += k6_bytes
        k6_q8c_bytes[1] += k6_bytes + 4 * ci.numel()
        for key, fn, reps in (
                ("ms_q8c", lambda: row_gather.rescore_match(*args), 10),
                ("ms_matched", lambda: row_gather.rescore_match(*args, return_matched=True), 10),
                ("plain_ms_matched", lambda: row_gather.rescore_match_plain(
                    *args, return_matched=True), 5)):
            r[key] = r.get(key, 0.0) + median_ms(fn, reps)
        log(f"  K6 rescore_match at q8c's pool {view} ids {tuple(ci.shape)}: sums and matched "
            f"weights within rtol {RTOL} of plain; the instance without the output gives "
            "the same sums bit for bit")

    q_int, _ = dense_topk.quantize_rows(q_emb)
    args = (q_int, idx.corpus_rows, idx.d_scale)
    got = dense_topk.group_max_packed_int8(*args)
    ref = dense_topk.group_max_packed_int8_plain(*args, idx.corpus_rows.shape[0])
    if not torch.equal(got.view(torch.int32), ref.view(torch.int32)):
        raise AssertionError("K1 group_max_packed_int8 != plain (int32 bit patterns)")
    r = res["group_max_packed_int8"]
    r["max_abs_err"] = float((got - ref).abs().max())
    (M, D), N = q_int.shape, idx.corpus_rows.shape[0]
    timed("group_max_packed_int8", lambda: dense_topk.group_max_packed_int8(*args),
          lambda: dense_topk.group_max_packed_int8_plain(*args, idx.corpus_rows.shape[0]),
          reps=5, plain_reps=3, nbytes=M * D + N * (D + 4) + 4 * got.numel(),
          ops=2.0 * M * N * D)
    r["matmul_only_ms"] = median_ms(lambda: int8_product(q_int, idx.corpus_rows), 3)
    log(f"  K1 group_max_packed_int8 {tuple(q_int.shape)} x {tuple(idx.corpus_rows.shape)}"
        f" -> {tuple(got.shape)}: equal as int32 bit patterns; the int8 product alone "
        f"(torch._int_mm over corpus chunks, no group max): {r['matmul_only_ms']:.3f} ms")
    k6 = res["rescore_match"]
    k6["bound_ms_q8c"], k6["bound_ms_matched"] = (bound(b, 0, "int8")[0] for b in k6_q8c_bytes)
    log(f"  rescore_match at q8c's pool: without the matched output {k6['ms_q8c']:.3f} ms "
        f"(bound {k6['bound_ms_q8c']:.4f}), with it {k6['ms_matched']:.3f} ms (bound "
        f"{k6['bound_ms_matched']:.4f}), plain with it {k6['plain_ms_matched']:.3f} ms per step")
    for name, r in res.items():
        r["bound_ms"], r["bound_by"] = bound(*work[name], "int8")
        log(f"  {name}: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), library "
            f"{'n/a' if r['library_ms'] is None else format(r['library_ms'], '.3f')} ms per step")
    return res


def int8_product(q_int, rows):
    """The int8 product alone, [M, D] x [N, D]^T -> int32 chunks (cuBLAS
    through torch._int_mm), a yardstick for K1's main loop: no scale, no
    group max. Chunks bound the [M, chunk] int32 output."""
    for n0 in range(0, rows.shape[0], CORPUS_CHUNK):
        torch._int_mm(q_int, rows[n0:n0 + CORPUS_CHUNK].T)


def bf16_product(q, rows):
    """The bf16 product alone (torch.matmul, bf16 out) in corpus chunks, a
    yardstick for K7's main loop."""
    for n0 in range(0, rows.shape[0], CORPUS_CHUNK):
        torch.matmul(q, rows[n0:n0 + CORPUS_CHUNK].T)


def check_step_output(out, n_docs):
    """A step's outputs: (fused ids, fused scores, qpp), and in q8c mode
    (certified [B] bool, slack [B] f32) after them."""
    fused_ids, fused_scores, qpp, *cert = out
    shapes = [tuple(x.shape) for x in out]
    want = [(BATCH, TOP_K), (BATCH, TOP_K), (5, BATCH, 13)] + [(BATCH,)] * len(cert)
    if shapes != want or len(cert) not in (0, 2):
        raise AssertionError(f"unexpected output shapes {shapes}")
    if cert:
        certified, slack = cert
        if certified.dtype != torch.bool or torch.isnan(slack).any():
            raise AssertionError("q8c: certified must be bool and slack a number")
        if (certified & torch.isneginf(slack)).any():
            raise AssertionError("q8c: a query certified with a slack of -inf")
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


def drive(name, step_fn, batches, expect, n_docs):
    """Run step_fn once over the batches with the launch counts set to 0
    just before; check the outputs and that every kernel in `expect`
    launched. -> (launch counts, the outputs)."""
    from qpp_fusion_rag_tpu_torch.ops.kernels import LAUNCHES

    LAUNCHES.clear()
    outs = [step_fn(batch) for batch in batches]
    launches = dict(LAUNCHES)
    log(f"  launches during the {name} path ({len(outs)} steps): {launches}")
    missing = [k for k in expect if launches.get(k, 0) < 1]
    if missing:
        raise AssertionError(f"kernels of the {name} path never launched: {missing}")
    for out in outs:
        check_step_output(out, n_docs)
    log("  outputs: shapes, finite QPP, non-increasing fused scores, unique ids < N: ok")
    return launches, outs


def run_path(name, idx, batches, expect, presorted=True, **kw):
    """The ensemble step over the batches (drive)."""
    from qpp_fusion_rag_tpu_torch.pipeline.ensemble import ensemble_retrieval_step

    return drive(name, lambda b: ensemble_retrieval_step(
        idx, *b, k=TOP_K, k_out=TOP_K, p_cap=P_CAP, sparse_presorted=presorted, **kw),
        batches, expect, idx.corpus_rows.shape[0])


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


def flagship_inputs(batches, dev):
    """The flagship's inputs: per batch (queries, text features), the view
    projections [5, D, D] (bench.py's 0.05 scale) and MLP parameters
    [65, 32, 16, 5] (He init, as the JAX package's init_mlp_params).

    Queries and projections are seeded normal draws put on grids (queries
    in steps of 1/64 within +-4, projections in steps of 1/256 within
    +-1/8) on which every product is a multiple of 2^-14 and every sum of
    768 of them stays below 2^24 such steps: the f32 projection is then
    exact in any summation order, so the card and the CPU project alike
    and the cross-check compares retrieval, not projection rounding."""
    gen = torch.Generator(device=dev).manual_seed(2)
    view_proj = torch.randn((VIEWS_R, DIM, DIM), generator=gen, device=dev) * 0.05
    view_proj = torch.round(view_proj * 256).clamp(-32, 32) / 256
    fbatches = [(torch.round(b[4] * 64).clamp(-256, 256) / 64, b[6]) for b in batches]
    rng = np.random.default_rng(3)
    mlp = [{"w": (rng.standard_normal((a, b)) * np.sqrt(2.0 / a)).astype(np.float32),
            "b": np.zeros(b, np.float32)} for a, b in zip(MLP_SIZES[:-1], MLP_SIZES[1:])]
    return fbatches, view_proj, mlp


def global_int8(rows_bf16):
    """quantize_global of the bf16 rows, chunk by chunk (no f32 copy of the
    whole corpus). -> (int8 rows [N, D], 0-d scale)."""
    amax = rows_bf16.abs().amax().float()
    scale = torch.where(amax > 0, amax * (1.0 / 127.0), 1.0)
    out = torch.empty(rows_bf16.shape, dtype=torch.int8, device=rows_bf16.device)
    for n0 in range(0, rows_bf16.shape[0], CORPUS_CHUNK):
        x = rows_bf16[n0:n0 + CORPUS_CHUNK].float() / scale
        out[n0:n0 + CORPUS_CHUNK] = torch.clamp(torch.round(x), -127, 127).to(torch.int8)
    return out, scale


def max_row_norm(rows):
    return max(float(rows[n0:n0 + CORPUS_CHUNK].float().norm(dim=1).max())
               for n0 in range(0, rows.shape[0], CORPUS_CHUNK))


def f64_scores(q, corpus, m, n):
    """float64 dot products of the pairs (q[m], corpus[n])."""
    out = torch.empty(m.numel(), dtype=torch.float64, device=q.device)
    for i in range(0, m.numel(), 65_536):
        out[i:i + 65_536] = (q[m[i:i + 65_536]].double()
                             * corpus[n[i:i + 65_536]].double()).sum(-1)
    return out


def check_group_close(what, q, corpus, cmax, got, ref):
    """A bf16 kernel against its plain version on random data: the values
    within PACK_RTOL |v| + ORDER_ATOL |q_m| max|c|; where the chosen docs
    differ, their float64 scores within the same band (a near-tie that the
    other summation order decided the other way). got/ref = (values, doc
    ids) [M, G]. -> (max abs value error, entries whose docs differ)."""
    (gv, gi), (rv, ri) = got, ref
    band = (PACK_RTOL * torch.maximum(gv.abs(), rv.abs())
            + ORDER_ATOL * q.float().norm(dim=1, keepdim=True) * cmax)
    err = torch.where(gv == rv, 0.0, (gv - rv).abs())     # -inf pads agree
    if (err > band).any():
        raise AssertionError(f"{what}: {int((err > band).sum())} values beyond the tolerance "
                             f"(max err {float(err.max()):.3g})")
    diff = gi != ri
    m = diff.nonzero()[:, 0]
    sg = f64_scores(q, corpus, m, gi[diff].long())
    sr = f64_scores(q, corpus, m, ri[diff].long())
    if ((sg - sr).abs() > band[diff].double()).any():
        raise AssertionError(f"{what}: a chosen doc differs from plain's beyond a near-tie")
    return float(err.max()), int(diff.sum())


def packed_parts(v):
    """Packed group maxima -> (clean values, global doc ids)."""
    bits = v.view(torch.int32)
    base = torch.arange(v.shape[1], device=v.device, dtype=torch.int32) * 128
    return (bits & ~0x7F).view(torch.float32), base + (bits & 0x7F)


def dense_kernels_vs_plain(rows_bf16, q_emb, view_proj, rows_i8, d_scale, k1):
    """K7-K10 against their plain versions on the card over the full corpus,
    at the shapes their paths give them: K7 the flagship's 5,120 projected
    bf16 rows, in both corpus layouts; K8 (stride 1 and 4), K9 and K10 the
    entry points' 1024 queries. K1 too at the int8 flagship's 5,120
    quantized rows, bit for bit, its times added to k1 (K1's entry) as
    ms_5120, plain_ms_5120 and bound_ms_5120. -> (per-kernel {max_abs_err,
    ms, plain_ms, ...}, the corpus's largest row norm)."""
    from qpp_fusion_rag_tpu_torch.ops.kernels import dense_topk as DK
    from qpp_fusion_rag_tpu_torch.ops.kernels import streaming_topk as ST

    n = rows_bf16.shape[0]
    cmax = max_row_norm(rows_bf16)
    qf = DK._project(q_emb, view_proj).reshape(-1, DIM)
    q5, _ = DK.quantize_rows(qf)          # what pallas_dense_topk_int8 gives K1 on the flagship
    args = (q5, rows_i8, d_scale)
    got = DK.group_max_packed_int8(*args)
    ref = DK.group_max_packed_int8_plain(*args, n)
    if not torch.equal(got.view(torch.int32), ref.view(torch.int32)):
        raise AssertionError("K1 group_max_packed_int8 at the flagship's rows != plain "
                             "(int32 bit patterns)")
    k1["max_abs_err"] = max(k1["max_abs_err"], float((got - ref).abs().max()))
    merge = row_topk_vs_plain(got)
    M5 = q5.shape[0]
    k1["bound_ms_5120"] = bound(M5 * DIM + n * (DIM + 4) + 4 * got.numel(),
                                2.0 * M5 * n * DIM, "int8")[0]
    del got, ref
    k1["ms_5120"] = median_ms(lambda: DK.group_max_packed_int8(*args), 5)
    k1["plain_ms_5120"] = median_ms(lambda: DK.group_max_packed_int8_plain(*args, n), 1)
    log(f"  K1 group_max_packed_int8 {tuple(q5.shape)} x {tuple(rows_i8.shape)}: equal as "
        f"int32 bit patterns; kernel {k1['ms_5120']:.3f} ms, plain {k1['plain_ms_5120']:.3f} "
        f"ms, bound {k1['bound_ms_5120']:.3f} ms")
    del q5, args
    qv = qf.to(torch.bfloat16).contiguous()
    del qf
    qb = q_emb.to(torch.bfloat16).contiguous()
    res = {"row_topk": merge}

    def timed(name, kernel, plain, err, q, out_bytes, kind="bf16", reps=5, plain_reps=3,
              **extra):
        """Kernel and plain times; the bound counts q and the corpus read
        once, out_bytes written once and 2 M N D operations. No single
        PyTorch call computes a group max: library_ms is null."""
        M = q.shape[0]
        nbytes = q.numel() * q.element_size() + n * DIM * (2 if kind == "bf16" else 1) + out_bytes
        b_ms, b_by = bound(nbytes, 2.0 * M * n * DIM, kind)
        res[name] = {"max_abs_err": err, "ms": median_ms(kernel, reps),
                     "plain_ms": median_ms(plain, plain_reps), "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": None, **extra}
        log(f"  {name}: kernel {res[name]['ms']:.3f} ms, plain {res[name]['plain_ms']:.3f} ms, "
            f"bound {b_ms:.3f} ms ({b_by})")

    got = DK.group_max_packed(qv, rows_bf16)
    ref = DK.group_max_packed_plain(qv, rows_bf16, n)
    err, nd = check_group_close("K7 rows", qv, rows_bf16, cmax, packed_parts(got),
                                packed_parts(ref))
    log(f"  K7 group_max_packed {tuple(qv.shape)} x {tuple(rows_bf16.shape)} -> "
        f"{tuple(got.shape)}: within tolerance (max err {err:.3g}; docs differ in {nd} of "
        f"{got.numel()} groups, all near-ties)")
    del ref
    t_ms = {}
    rows_t = rows_bf16.T.contiguous()
    got_t = DK.group_max_packed(qv, rows_t, transposed=True)
    ref_t = DK.group_max_packed_plain(qv, rows_t, n, transposed=True)
    err_t, nd_t = check_group_close("K7 [D, N]", qv, rows_bf16, cmax, packed_parts(got_t),
                                    packed_parts(ref_t))
    same = torch.equal(got_t.view(torch.int32), got.view(torch.int32))
    del ref_t, got_t, got
    t_ms["ms_transposed"] = median_ms(lambda: DK.group_max_packed(qv, rows_t, transposed=True), 5)
    t_ms["plain_ms_transposed"] = median_ms(
        lambda: DK.group_max_packed_plain(qv, rows_t, n, transposed=True), 3)
    del rows_t
    log(f"  K7 [D, N] layout: within tolerance (max err {err_t:.3g}, {nd_t} groups differ); "
        f"bit-equal to the row layout: {same}; kernel {t_ms['ms_transposed']:.3f} ms, plain "
        f"{t_ms['plain_ms_transposed']:.3f} ms")
    t_ms["matmul_only_ms"] = median_ms(lambda: bf16_product(qv, rows_bf16), 3)
    log(f"  the bf16 product alone (torch.matmul over corpus chunks, bf16 out, no group "
        f"max): {t_ms['matmul_only_ms']:.3f} ms")
    timed("group_max_packed", lambda: DK.group_max_packed(qv, rows_bf16),
          lambda: DK.group_max_packed_plain(qv, rows_bf16, n), max(err, err_t), qv,
          4 * qv.shape[0] * -(-n // 128), **t_ms)

    for stride in (1, 4):
        got = DK.group_max_scores(qb, rows_bf16, stride=stride)
        ref = DK.group_max_scores_plain(qb, rows_bf16, n, stride)
        err, nd = check_group_close(f"K8 stride {stride}", qb, rows_bf16, cmax, got, ref)
        log(f"  K8 group_max_scores stride {stride} {tuple(qb.shape)} -> {tuple(got[0].shape)}: "
            f"within tolerance (max err {err:.3g}, {nd} ids differ, all near-ties)")
        del got, ref
    n_pad = -(-n // 2048) * 2048
    timed("group_max_scores", lambda: DK.group_max_scores(qb, rows_bf16, stride=4),
          lambda: DK.group_max_scores_plain(qb, rows_bf16, n, 4), err, qb,
          8 * qb.shape[0] * (n_pad // 512),
          ms_stride1=median_ms(lambda: DK.group_max_scores(qb, rows_bf16), 5),
          bound_ms_stride1=bound(qb.numel() * 2 + n * DIM * 2 + 8 * qb.shape[0] * (n_pad // 128),
                                 2.0 * qb.shape[0] * n * DIM, "bf16")[0])

    rows_g, _ = global_int8(rows_bf16)
    q_int, _ = DK.quantize_rows(q_emb)
    got = DK.group_max_packed_int8_global(q_int, rows_g)
    ref = DK.group_max_packed_int8_global_plain(q_int, rows_g, n)
    if not torch.equal(got, ref):
        raise AssertionError("K9 group_max_packed_int8_global != plain")
    log(f"  K9 group_max_packed_int8_global {tuple(q_int.shape)} x {tuple(rows_g.shape)}: equal")
    timed("group_max_packed_int8_global", lambda: DK.group_max_packed_int8_global(q_int, rows_g),
          lambda: DK.group_max_packed_int8_global_plain(q_int, rows_g, n), 0.0, q_int,
          4 * got.numel(), kind="int8")
    del got, ref, rows_g

    got = ST.streaming_group_max(qb, rows_bf16)
    out_bytes = 8 * got[0].numel()
    ref = ST.streaming_group_max_plain(qb, rows_bf16, n)
    err, nd = check_group_close("K10", qb, rows_bf16, cmax, got, ref)
    log(f"  K10 streaming_group_max {tuple(qb.shape)} -> {tuple(got[0].shape)}: within "
        f"tolerance (max err {err:.3g}, {nd} ids differ, all near-ties)")
    del got, ref
    timed("streaming_group_max", lambda: ST.streaming_group_max(qb, rows_bf16),
          lambda: ST.streaming_group_max_plain(qb, rows_bf16, n), err, qb, out_bytes)
    wide_group_argmax(res, rows_bf16.device)
    return res, cmax


def row_topk_vs_plain(vals):
    """The dense merge on K1's packed maxima of the int8 flagship (5,120 x
    20,480 at k 100) and on their first 1024 rows, the ensemble's dense view
    (k 100, and 128: the rank-safe pool): row_topk bit-equal to topk_first
    on the card, and timed beside its bound (bytes, each once: 4 M G read,
    12 M k written), topk_first (its plain version) and torch.topk (the
    library's call, which the port never makes). -> the flagship shape's
    {ms, plain_ms, library_ms, bound_ms, bound_by, max_abs_err}, each other
    shape's under "<M>x<G>_k<k>"."""
    from qpp_fusion_rag_tpu_torch.ops.kernels.row_topk import row_topk
    from qpp_fusion_rag_tpu_torch.ops.segment import topk_first

    out = {}
    for M, k in ((vals.shape[0], TOP_K), (BATCH, TOP_K), (BATCH, DENSE_POOL)):
        x = vals[:M].contiguous()
        G = x.shape[1]
        (gv, gi), (rv, ri) = row_topk(x, k), topk_first(x, k)
        if not (torch.equal(gi, ri) and torch.equal(gv.view(torch.int32), rv.view(torch.int32))):
            raise AssertionError(f"row_topk {M} x {G} k {k} != topk_first on the card")
        b_ms, b_by = bound(4 * M * G + 12 * M * k, 0.0, "int8")
        fin = torch.isfinite(rv)
        err = float((gv - rv)[fin].abs().max()) if bool(fin.any()) else 0.0
        r = {"max_abs_err": err, "ms": median_ms(lambda: row_topk(x, k), 20),
             "plain_ms": median_ms(lambda: topk_first(x, k), 5),
             "library_ms": median_ms(lambda: torch.topk(x, k), 10), "bound_ms": b_ms,
             "bound_by": b_by}
        log(f"  row_topk {M} x {G}, k {k}: bit-equal to topk_first; kernel {r['ms']:.3f} ms, "
            f"bound {b_ms:.3f} ms ({b_by}), topk_first {r['plain_ms']:.3f} ms, torch.topk "
            f"{r['library_ms']:.3f} ms")
        if out:
            out[f"{M}x{G}_k{k}"] = r
        else:
            out.update(r)
    return out


def run_sums_vs_plain(idx, batch):
    """The "sort" path's run sums on batch 0's id-sorted pairs of each view
    (BM25 Tq x p_cap, SPLADE Tq x p_cap pairs a query, k 100): run_sums_topk
    bit-equal to segmented_topk_presorted on the card, and timed beside its
    bound (bytes, each once: 8 B a pair read, 12 B a winner), the torch
    route (its plain version) and topk_first alone over its totals. -> the
    views summed {ms, plain_ms, library_ms (topk_first), bound_ms, bound_by,
    max_abs_err}, each view's under "<B>x<M>"."""
    from qpp_fusion_rag_tpu_torch.ops import sparse as S
    from qpp_fusion_rag_tpu_torch.ops.kernels.run_sums import run_sums_topk
    from qpp_fusion_rag_tpu_torch.ops.segment import (
        run_totals_presorted,
        segmented_topk_presorted,
        topk_first,
    )

    bt, bq, st, sq = batch[:4]
    out = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
           "bound_by": "bytes"}
    for view, terms, qw in (("bm25", bt, bq), ("splade", st, sq)):
        packed, offsets, scales = view_args(idx, view)
        docs, vals = S._packed_contributions(packed, offsets, scales, terms, qw, P_CAP)
        sids, order = torch.sort(docs, dim=-1, stable=True)
        svals = torch.gather(vals, -1, order)
        B, M = sids.shape
        (gs, gi), (ri, rs, _) = run_sums_topk(sids, svals, TOP_K), \
            segmented_topk_presorted(sids, svals, TOP_K)
        if not (torch.equal(gi, ri) and torch.equal(gs.view(torch.int32), rs.view(torch.int32))):
            raise AssertionError(f"run_sums_topk {B} x {M} != segmented_topk_presorted on the card")
        sums, _, at_last = run_totals_presorted(sids, svals)
        totals = torch.where(at_last, sums, float("-inf"))
        b_ms, _ = bound(8 * B * M + 12 * B * TOP_K, 0.0, "int8")
        r = {"max_abs_err": 0.0, "ms": median_ms(lambda: run_sums_topk(sids, svals, TOP_K), 20),
             "plain_ms": median_ms(lambda: segmented_topk_presorted(sids, svals, TOP_K), 5),
             "library_ms": median_ms(lambda: topk_first(totals, TOP_K), 10), "bound_ms": b_ms,
             "bound_by": "bytes"}
        log(f"  run_sums_topk {B} x {M}, k {TOP_K}: bit-equal to segmented_topk_presorted; "
            f"kernel {r['ms']:.3f} ms, bound {b_ms:.4f} ms (bytes), torch route "
            f"{r['plain_ms']:.3f} ms, topk_first of the totals {r['library_ms']:.3f} ms")
        out[f"{B}x{M}"] = r
        for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
            out[key] += r[key]
    return out


def q8_topk_vs_plain(rows):
    """q8's selection on run sums K2 made: rows is (sums, sids, wmax_col, tq)
    for each view (batch 0's BM25 and SPLADE queries, 8 x P_CAP and 16 x
    P_CAP sums a row, and the 32-term SPLADE queries, LONG_TQ x P_CAP), k
    100: q8_topk bit-equal to q8_topk_plain (topk_first over the scores) on
    the card, and timed beside its bound (bytes, each once: 4 B a sum read,
    12 B a winner) and the plain version. -> the views summed {ms,
    plain_ms, bound_ms, bound_by, max_abs_err}, each view's under "<B>x<M>"."""
    from qpp_fusion_rag_tpu_torch.ops.kernels.q8_topk import q8_topk, q8_topk_plain

    out = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bound_by": "bytes"}
    for sums, sids, wmax, tq in rows:
        B, M = sums.shape
        (gs, gi), (rs, ri) = q8_topk(sums, sids, wmax, TOP_K, tq), \
            q8_topk_plain(sums, sids, wmax, TOP_K)
        if not (torch.equal(gi, ri) and torch.equal(gs.view(torch.int32), rs.view(torch.int32))):
            raise AssertionError(f"q8_topk {B} x {M} != q8_topk_plain on the card")
        b_ms, _ = bound(4 * B * M + 12 * B * TOP_K, 0.0, "int8")
        r = {"max_abs_err": 0.0, "ms": median_ms(lambda: q8_topk(sums, sids, wmax, TOP_K, tq), 20),
             "plain_ms": median_ms(lambda: q8_topk_plain(sums, sids, wmax, TOP_K), 5),
             "bound_ms": b_ms, "bound_by": "bytes"}
        log(f"  q8_topk {B} x {M}, k {TOP_K}: bit-equal to q8_topk_plain; kernel "
            f"{r['ms']:.4f} ms, bound {b_ms:.4f} ms (bytes), plain version "
            f"{r['plain_ms']:.3f} ms")
        out[f"{B}x{M}"] = r
        for key in ("ms", "plain_ms", "bound_ms"):
            out[key] += r[key]
    return out


def wide_group_argmax(res, dev):
    """K8 (stride 1 and 4) and K10 at D = 1024 against their plain versions:
    1024 bf16 queries x a 131,072-doc bf16 corpus, both seeded normal draws
    made on the card. Their max value errors go into the kernels' entries of
    `res` as max_abs_err_d1024."""
    from qpp_fusion_rag_tpu_torch.ops.kernels import dense_topk as DK
    from qpp_fusion_rag_tpu_torch.ops.kernels import streaming_topk as ST

    gen = torch.Generator(device=dev).manual_seed(4)
    c = torch.randn((WIDE_DOCS, WIDE_DIM), generator=gen, device=dev).to(torch.bfloat16)
    q = torch.randn((BATCH, WIDE_DIM), generator=gen, device=dev).to(torch.bfloat16)
    cmax = max_row_norm(c)
    for name, what, kernel, plain in (
            ("group_max_scores", "K8 stride 1", lambda: DK.group_max_scores(q, c),
             lambda: DK.group_max_scores_plain(q, c, WIDE_DOCS)),
            ("group_max_scores", "K8 stride 4", lambda: DK.group_max_scores(q, c, stride=4),
             lambda: DK.group_max_scores_plain(q, c, WIDE_DOCS, 4)),
            ("streaming_group_max", "K10", lambda: ST.streaming_group_max(q, c),
             lambda: ST.streaming_group_max_plain(q, c, WIDE_DOCS))):
        got = kernel()
        err, nd = check_group_close(f"{what} at D {WIDE_DIM}", q, c, cmax, got, plain())
        r = res[name]
        r["max_abs_err_d1024"] = max(r.get("max_abs_err_d1024", 0.0), err)
        log(f"  {what} at D {WIDE_DIM} {tuple(q.shape)} x {tuple(c.shape)} -> "
            f"{tuple(got[0].shape)}: within tolerance (max err {err:.3g}, {nd} ids differ, "
            "all near-ties)")


def run_flagship(name, step, corpus, batches, view_proj, expect, **kw):
    """A flagship step over the batches (drive)."""
    return drive(name, lambda b: step(b[0], view_proj, corpus, b[1], k=TOP_K, k_out=TOP_K, **kw),
                 batches, expect, corpus.shape[0])


def entry_call(name, kernel, fn, n_docs):
    """One full-size call of a dense entry point, counts set to 0 just
    before; it must launch `kernel` and return a sane [B, k] run."""
    from qpp_fusion_rag_tpu_torch.ops.kernels import LAUNCHES

    LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vals, ids = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = dict(LAUNCHES)
    log(f"  {name}: {ms:.1f} ms; launches {launches}")
    if launches.get(kernel, 0) < 1:
        raise AssertionError(f"{name} never launched {kernel}")
    if tuple(vals.shape) != (BATCH, TOP_K) or tuple(ids.shape) != (BATCH, TOP_K):
        raise AssertionError(f"{name}: shapes {tuple(vals.shape)}, {tuple(ids.shape)}")
    if not torch.isfinite(vals).all() or int(ids.min()) < 0 or int(ids.max()) >= n_docs:
        raise AssertionError(f"{name}: non-finite scores or ids out of range")
    if (vals[:, 1:] > vals[:, :-1]).any():
        raise AssertionError(f"{name}: scores increase along a row")
    return launches


def assert_ranked_close(g_s, g_i, c_s, c_i, band, what):
    """Rows sorted by score: scores within `band`; where the ids differ at a
    position, the CPU score there lies within 2 band of another position's
    score or of the row's last (a near-tie decided the other way)."""
    g_s, c_s = g_s.double(), c_s.double()
    band = torch.broadcast_to(torch.as_tensor(band, dtype=torch.float64), c_s.shape)
    err = (g_s - c_s).abs()
    if (err > band).any():       # -inf on both sides gives nan, which passes
        raise AssertionError(f"{what}: scores beyond the tolerance (max err "
                             f"{float(err[torch.isfinite(err)].max()):.3g})")
    for r, p in (g_i != c_i).nonzero().tolist():
        near = (c_s[r] - c_s[r, p]).abs() <= 2 * band[r, p]
        near[p] = False
        if not (near.any() or c_s[r, p] - c_s[r, -1] <= 2 * band[r, p]):
            raise AssertionError(f"{what}: ids differ at row {r}, rank {p} without a near-tie")


def flagship_cross_check(rows_bf16, rows_i8, scale, fbatch, view_proj, cmax):
    """CROSS_Q queries of the flagship on CPU copies: the per-view runs of
    both routes from the same projected queries (int8: equal; bf16: the
    kernel tolerance), and the fused outputs of the whole step under frozen
    QPP stats: qpp and fused scores within rtol STEP_RTOL, atol STEP_ATOL
    (qpp atol STEP_RTOL; snqc atol SNQC_ATOL), ids up to near-ties. The
    projection is exact on both devices (flagship_inputs); what differs is
    the bf16 kernel's summation order, which the per-view min-max
    normalisation magnifies, and the last bits of the QPP arithmetic."""
    from qpp_fusion_rag_tpu_torch.ops.kernels import dense_topk as DK
    from qpp_fusion_rag_tpu_torch.pipeline import engine as E

    q_emb, tf = fbatch
    qv = DK._project(q_emb[:CROSS_Q], view_proj).reshape(-1, DIM)
    c_i8, c_sc, c_bf = rows_i8.cpu(), scale.cpu(), rows_bf16.cpu()
    g = DK.pallas_dense_topk_int8(qv, rows_i8, scale, k=TOP_K)
    c = DK.pallas_dense_topk_int8(qv.cpu(), c_i8, c_sc, k=TOP_K)
    if not all(torch.equal(a.cpu(), b) for a, b in zip(g, c)):
        raise AssertionError("int8 route runs: card and CPU disagree")
    g = DK.pallas_dense_topk(qv, rows_bf16, k=TOP_K)
    c = DK.pallas_dense_topk(qv.cpu(), c_bf, k=TOP_K)
    band = (PACK_RTOL * c[0].abs().double()
            + ORDER_ATOL * qv.cpu().to(torch.bfloat16).float().norm(dim=1, keepdim=True)
            .double() * cmax)
    assert_ranked_close(g[0].cpu(), g[1].cpu(), c[0], c[1], band, "bf16 route runs")
    log(f"  per-view runs of {CROSS_Q} queries x {VIEWS_R} views: int8 route equal, bf16 "
        "route within the kernel tolerance")
    for name, corpus, c_corpus, kw, c_kw in (
            ("int8", rows_i8, c_i8, dict(corpus_scale=scale), dict(corpus_scale=c_sc)),
            ("bf16", rows_bf16, c_bf, dict(use_pallas=True), dict(use_pallas=True))):
        if name == "int8":
            vals, ids = DK.pallas_multi_view_topk_int8(q_emb, view_proj, corpus, scale, k=TOP_K)
        else:
            vals, ids = DK.pallas_multi_view_topk(q_emb, view_proj, corpus, k=TOP_K)
        stats = E.Q.qpp_calibration_stats(E.qpp_from_runs(vals, ids, tf, normalize=False))
        g = E.fused_retrieval_step(q_emb, view_proj, corpus, tf, k=TOP_K, k_out=TOP_K,
                                   qpp_norm_stats=stats, **kw)
        c = E.fused_retrieval_step(q_emb[:CROSS_Q].cpu(), view_proj.cpu(), c_corpus,
                                   tf[:CROSS_Q].cpu(), k=TOP_K, k_out=TOP_K,
                                   qpp_norm_stats=stats.cpu(), **c_kw)
        keep = torch.arange(13) != SNQC
        torch.testing.assert_close(g[2][:, :CROSS_Q, keep].cpu(), c[2][..., keep], rtol=STEP_RTOL,
                                   atol=STEP_RTOL, msg=lambda m: f"{name} step qpp: {m}")
        torch.testing.assert_close(g[2][:, :CROSS_Q, SNQC].cpu(), c[2][..., SNQC], rtol=0,
                                   atol=SNQC_ATOL, msg=lambda m: f"{name} step snqc: {m}")
        band = STEP_ATOL + STEP_RTOL * c[1].abs().double()
        assert_ranked_close(g[1][:CROSS_Q].cpu(), g[0][:CROSS_Q].cpu(), c[1], c[0], band,
                            f"{name} step fused output")
        n_same = int((g[0][:CROSS_Q].cpu() == c[0]).sum())
        log(f"  {name} step under frozen QPP stats: qpp and fused scores within rtol "
            f"{STEP_RTOL} (snqc atol {SNQC_ATOL}; max snqc diff "
            f"{float((g[2][:, :CROSS_Q, SNQC].cpu() - c[2][..., SNQC]).abs().max()):.3g}); "
            f"{n_same} of {c[0].numel()} fused ids equal, the rest near-ties")
    del c_i8, c_bf


def true_scores(csr, terms, weights):
    """float64 exhaustive scores [len(terms), N_DOCS] of the raw f32 CSR
    weights (offsets, docs, weights) for host query rows."""
    off, docs, w = csr
    out = np.zeros((len(terms), N_DOCS), np.float64)
    for r, (ts, ws) in enumerate(zip(terms, weights)):
        for t, qw in zip(ts, ws):
            if t >= 0:
                lo, hi = int(off[t]), int(off[t + 1])
                out[r] += np.bincount(docs[lo:hi], weights=float(qw) * w[lo:hi].astype(np.float64),
                                      minlength=N_DOCS)
    return out


def certified_soundness(idx, view, terms, qw, csr, imp_bits):
    """q8c on the card for one view of a batch (the scorer the step runs,
    tails included), and the soundness of its certificates on CROSS_Q of
    its queries: up to half of them certified, the rest not. Where a query
    is certified, its ids must carry the true top-k of the raw f32 weights,
    scored in float64 on the host over the full CSR (the JAX package's
    tests/test_sparse_certified.py contract). -> (Certificate, rows)."""
    from qpp_fusion_rag_tpu_torch.ops import sparse as S

    cert = S.certify(*view_args(idx, view, ("packed", "offsets", "scales", "doc_packed",
                                            "doc_scale")), terms, qw, k=TOP_K, p_cap=P_CAP,
                     candidates=Q8R_CANDIDATES, imp_bits=imp_bits, presorted=True,
                     tail_max=getattr(idx, f"{view}_tail"))
    ok = cert.certified.cpu().numpy()
    yes, no = np.flatnonzero(ok), np.flatnonzero(~ok)
    n_yes = max(CROSS_Q - len(no), min(len(yes), CROSS_Q // 2))
    rows = np.sort(np.concatenate([yes[:n_yes], no[:CROSS_Q - n_yes]]))
    true = true_scores(csr, terms[rows].cpu().numpy(), qw[rows].cpu().numpy())
    ids = cert.ids[rows].cpu().numpy()
    for r, b in enumerate(rows):
        if ok[b] and not true_topk_ok(true[r], ids[r], TOP_K):
            raise AssertionError(f"{view} q8c: query {b} is certified but its ids do not "
                                 "carry the true top-k")
    log(f"  {view}: {int(ok.sum())} of {len(ok)} queries certified; soundness over the full "
        f"CSR in float64 on {len(rows)} queries ({int(ok[rows].sum())} certified): every "
        "certified one returned the true top-k")
    return cert, rows


def certificate_close(g, c, rows, what):
    """A certificate from the card (rows of it) against the CPU's: scores
    within RTOL and ids up to near-tie swaps, slack within the tie band
    1e-5 (|ret_lb| + |bound|), and the same `certified` wherever the slack
    lies outside that band around the decision point."""
    g = type(g)(*(x[torch.as_tensor(rows, device=x.device)].cpu() for x in g))
    assert_close_ranking(g.scores, g.ids, c.scores, c.ids, what)
    band = TIE_REL_EPS * (c.ret_lb.abs() + c.bound.abs())
    fin = torch.isfinite(c.slack)
    if not torch.equal(fin, torch.isfinite(g.slack)) or ((g.slack - c.slack).abs()[fin]
                                                         > band[fin]).any():
        raise AssertionError(f"{what}: slack beyond the tie band")
    clear = ~fin | ((c.slack + band).abs() > band)
    if not torch.equal(g.certified[clear], c.certified[clear]):
        raise AssertionError(f"{what}: certified differs outside the tie band")


def f32_route(idx, csr, terms, qw, imp_bits, dev):
    """One BM25 q8c call of the batch on the f32 rescore route: the exact
    doc vectors (pack_doc_vectors_exact) over the full CSR, made on the host
    and moved to the card. -> (Certificate, doc_terms, doc_w numpy)."""
    from qpp_fusion_rag_tpu_torch.ops import sparse as S

    t0 = time.perf_counter()
    doc_terms, doc_w, td = S.pack_doc_vectors_exact(*csr, N_DOCS)
    pack_s = time.perf_counter() - t0
    dt, dw = torch.from_numpy(doc_terms).to(dev), torch.from_numpy(doc_w).to(dev)
    args = view_args(idx, "bm25", ("packed", "offsets", "scales", "doc_packed", "doc_scale"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cert = S.certify(*args, terms, qw, k=TOP_K, p_cap=P_CAP, candidates=Q8R_CANDIDATES,
                     imp_bits=imp_bits, presorted=True, doc_terms=dt, doc_w=dw)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    log(f"  exact doc vectors Td {td}: doc_terms + doc_w {doc_terms.nbytes + doc_w.nbytes} "
        f"bytes, packed on the host in {pack_s:.1f} s; one call {ms:.1f} ms; "
        f"{int(cert.certified.sum())} of {cert.certified.numel()} queries certified")
    return cert, doc_terms, doc_w


INDEX_SAMPLE = 32                 # search_certified's batch and autotune_sparse's sample
TWO_STAGE_Q = 64
SMALL_DOCS = 2000                 # the text corpus of the g++ build check


def timed_call(fn):
    """fn() between two synchronizations. -> (result, wall ms)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def launched(name, fn, expect, reps=1):
    """fn() `reps` times with the launch counts set to 0 just before and read
    just after; fails unless every kernel in `expect` launched.
    -> (the last result, median ms, launch counts)."""
    from qpp_fusion_rag_tpu_torch.ops.kernels import LAUNCHES

    LAUNCHES.clear()
    times = []
    for _ in range(reps):
        out, ms = timed_call(fn)
        times.append(ms)
    counts = dict(LAUNCHES)
    missing = [k for k in expect if counts.get(k, 0) < 1]
    if missing:
        raise AssertionError(f"{name}: kernels never launched: {missing} ({counts})")
    med = statistics.median(times)
    log(f"  {name}: {med:.3f} ms (median of {reps}: {', '.join(f'{t:.3f}' for t in times)}); "
        f"launches {counts}")
    return out, med, counts


def equal_np(a, b) -> bool:
    """numpy results against tensors (or numpy), bit for bit."""
    to = lambda x: x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return all(np.array_equal(to(x), to(y)) for x, y in zip(a, b))


def true_topk_ok(true_row, ids, k):
    """ids carry the k largest float64 scores (tie-tolerant)."""
    best = np.sort(np.partition(true_row, -k)[-k:])[::-1]
    return np.allclose(np.sort(true_row[ids[:k]])[::-1], best, rtol=1e-5, atol=1e-5)


def index_layer(csr, batches, rows_bf16, idx, idx_sort, dev, smi):
    """[6g] The sparse index layer at full size: SparseIndex over the bench
    BM25 CSR (docnos "d<i>", queries "q<i>" of the three batches through
    the query_encoder hook) and SpladeIndex over the SPLADE CSR; each call
    with the launch counts set to 0 before it. -> the results and counts
    the cross-check and the summary read."""
    from qpp_fusion_rag_tpu_torch.index import native
    from qpp_fusion_rag_tpu_torch.index import sparse as IS
    from qpp_fusion_rag_tpu_torch.index.autotune import autotune_sparse
    from qpp_fusion_rag_tpu_torch.ops import sparse as S
    from qpp_fusion_rag_tpu_torch.retrievers.bm25 import BM25Retriever
    from qpp_fusion_rag_tpu_torch.retrievers.splade import SpladeIndex
    from qpp_fusion_rag_tpu_torch.retrievers.two_stage import DenseReranker, TwoStageRetriever

    res = {"launches": {}, "ms": {}}
    K3, K2, K4, K6 = ("gather_windows", "bitonic_segsum_rows", "bitonic_topp_rows",
                      "rescore_match")
    t0 = time.perf_counter()
    docnos = [f"d{i}" for i in range(N_DOCS)]
    off, docs, w = csr["bm25"]
    ix = IS.SparseIndex(off, docs, w, np.bincount(docs, minlength=N_DOCS), docnos, "",
                        params={"kind": "bm25"}, device=dev)
    q_terms = np.concatenate([b[0].cpu().numpy() for b in batches])
    q_weights = np.concatenate([b[1].cpu().numpy() for b in batches])

    def encoder(texts, max_terms):
        rows = np.fromiter((int(t[1:]) for t in texts), np.int64, len(texts))
        return q_terms[rows], q_weights[rows]

    ix.query_encoder = encoder
    sx = SpladeIndex(*csr["splade"], docnos, SPLADE_VOCAB, device=dev)
    log(f"  BM25 SparseIndex: {ix.num_docs} docs, {ix.num_postings} postings, max_df "
        f"{ix.max_df}; SPLADE SpladeIndex max_df {sx.max_df}; docnos and host index "
        f"{time.perf_counter() - t0:.1f} s")

    lazy = {}
    for name, fn in (("exact arrays", ix._device_arrays),
                     ("packed", lambda: ix._device_packed(0)),
                     (f"presorted at {P_CAP}", lambda: ix._device_packed(P_CAP)),
                     ("doc vectors", ix._device_doc_vectors),
                     ("exact doc vectors", ix._device_doc_vectors_exact),
                     (f"SPLADE presorted at {P_CAP}", lambda: sx._device_packed(P_CAP)),
                     ("SPLADE doc vectors", sx._device_doc_vectors)):
        lazy[name] = round(timed_call(fn)[1] / 1e3, 3)
    td = ix._device_doc_vectors()[0].shape[1], ix._device_doc_vectors_exact()[0].shape[1]
    log(f"  lazy device arrays, host + copy seconds: {lazy}; BM25 Td {td[0]} packed / "
        f"{td[1]} exact, SPLADE Td {sx._device_doc_vectors()[0].shape[1]}")
    res["lazy_s"] = lazy
    # the index's own packers give the layouts the ensemble paths ran on
    for got, want, what in ((ix._device_packed(0), (idx_sort.bm25_packed, idx_sort.bm25_offsets,
                                                    idx.bm25_scales), "BM25 plain"),
                            (ix._device_packed(P_CAP), (idx.bm25_packed, idx.bm25_offsets,
                                                        idx.bm25_scales), "BM25 presorted"),
                            (sx._device_packed(P_CAP), (idx.splade_packed, idx.splade_offsets,
                                                        idx.splade_scales), "SPLADE presorted")):
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"{what}: the index's packed layout differs from the host build's")

    texts = [f"q{i}" for i in range(BATCH)]
    qt, qw = (torch.as_tensor(x, device=dev) for x in ix.encode_queries(texts))
    p_exact = min(ix.max_df, 4096)
    dp, dsc, bits = ix._device_doc_vectors()
    for eng, kw, expect, direct in (
            ("exact", {}, (K3,), lambda: S.sparse_score_topk(
                *ix._device_arrays()[:3], qt, qw, k=TOP_K, p_cap=p_exact)),
            ("q8", dict(p_cap=P_CAP, presorted=True), (K3, K2, K4),
             lambda: S.sparse_score_topk_q8(*ix._device_packed(P_CAP), qt, qw, k=TOP_K,
                                            p_cap=P_CAP, exact_topk=True, presorted=True)),
            ("q8r", dict(p_cap=P_CAP, presorted=True, candidates=Q8R_CANDIDATES), (K3, K2, K4, K6),
             lambda: S.sparse_score_topk_q8_rescored(
                 *ix._device_packed(P_CAP), dp, dsc, qt, qw, k=TOP_K, p_cap=P_CAP,
                 candidates=Q8R_CANDIDATES, imp_bits=bits, presorted=True))):
        call = lambda: ix.search(texts, k=TOP_K, engine=eng, **kw)
        call()                                                   # warm-up
        out, ms, counts = launched(f"SparseIndex.search {eng} {kw or f'(p_cap {p_exact})'}, "
                                   f"{BATCH} queries", call, expect, reps=3)
        if not equal_np(out, direct()):
            raise AssertionError(f"SparseIndex.search {eng}: differs from the direct ops call")
        res[f"index_{eng}"] = out
        res["launches"][f"index_{eng}"], res["ms"][f"index_{eng}"] = counts, ms
    log("  search (exact, q8, q8r): bit-equal to the direct ops/sparse.py calls on the "
        "index's arrays")

    # search_certified on INDEX_SAMPLE queries at its defaults, then on CROSS_Q of
    # them with one tight round (p_cap 256, 128 candidates), so that queries
    # escalate to the exhaustive pass; each round and each exhaustive pass timed
    sample = texts[:INDEX_SAMPLE]
    orig_c, orig_e = IS.sparse_score_topk_q8_certified, IS.sparse_score_topk
    round_ms, exh = [], []

    def t_cert(*a, **kw):
        out, ms = timed_call(lambda: orig_c(*a, **kw))
        round_ms.append(round(ms, 3))
        return out

    def t_exact(*a, **kw):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out, ms = timed_call(lambda: orig_e(*a, **kw))
        exh.append({"queries": a[3].shape[0], "tq": a[3].shape[1], "p_cap": kw["p_cap"],
                    "ms": round(ms, 3),
                    "peak_bytes": torch.cuda.max_memory_allocated() - base})
        return out

    true = true_scores(csr["bm25"], q_terms[:INDEX_SAMPLE], q_weights[:INDEX_SAMPLE])
    IS.sparse_score_topk_q8_certified, IS.sparse_score_topk = t_cert, t_exact
    try:
        ladders = []
        for qs, kw in ((sample, {}), (sample[:CROSS_Q], dict(p_cap=256, candidates=128,
                                                            max_rounds=1))):
            round_ms.clear()
            (cs, ci, info), ms, counts = launched(
                f"search_certified, {len(qs)} queries {kw or '(defaults)'}",
                lambda: ix.search_certified(qs, k=TOP_K, **kw), (K3, K2, K4))
            cr = info["certified_round"]
            log(f"  rounds: {info['rounds']}; round ms {list(round_ms)}")
            for b in np.flatnonzero(cr >= 0):
                if not true_topk_ok(true[b], ci[b], TOP_K):
                    raise AssertionError(f"search_certified: query {b} certified in round "
                                         f"{cr[b]} but its ids do not carry the true top-k")
            ladders.append((cs, ci, cr, info, list(round_ms), ms, counts))
        res["launches"]["index_certified"], res["ms"]["index_certified"] = ladders[0][-1], \
            ladders[0][-2]
        esc = [(n, b) for n, lad in enumerate(ladders) for b in np.flatnonzero(lad[2] < 0)]
        if not esc:
            raise AssertionError("search_certified: no query reached the exhaustive pass")
        (es, ei), ms, counts = launched(
            f"search exact at p_cap = max_df {ix.max_df}, the {len(esc)} escalated queries",
            lambda: ix.search([sample[b] for _, b in esc], k=TOP_K, p_cap=ix.max_df,
                              engine="exact"), (K3,))
    finally:
        IS.sparse_score_topk_q8_certified, IS.sparse_score_topk = orig_c, orig_e
    res["ms"]["exhaustive"] = ms
    for r, (n, b) in enumerate(esc):
        if not equal_np((ladders[n][0][b], ladders[n][1][b]), (es[r], ei[r])):
            raise AssertionError(f"search_certified: escalated query {b} differs from "
                                 "search(engine='exact', p_cap=max_df)")
    for e in exh:
        reckoned = e["queries"] * e["tq"] * e["p_cap"] * 8
        log(f"  exhaustive pass: [{e['queries']}, {e['tq']}, {e['p_cap']}] windows of docs + "
            f"weights = {reckoned} bytes reckoned; {e['ms']} ms; peak {e['peak_bytes']} bytes "
            f"allocated, {e['peak_bytes'] // max(e['queries'], 1)} a query")
    dev_max = max(float(np.abs(es[r] - true[b][ei[r]]).max()) for r, (_, b) in enumerate(esc))
    hit = sum(true_topk_ok(true[b], ei[r], TOP_K) for r, (_, b) in enumerate(esc))
    log(f"  certified queries carry the true float64 top-k over the full CSR; the "
        f"{len(esc)} escalated ones equal search(exact, p_cap=max_df); that pass against "
        f"float64: largest score error {dev_max:.4g}, the true top-k on {hit} of {len(esc)}")
    res["certified"] = {"rounds": [lad[3]["rounds"] for lad in ladders],
                        "round_ms": [lad[4] for lad in ladders], "exhaustive": exh,
                        "exhaustive_max_abs_err": dev_max, "exhaustive_true_topk": hit}

    st, sq = (x.cpu().numpy() for x in batches[0][2:4])
    sdp, sds, sbits = sx._device_doc_vectors()
    call = lambda: sx.search_impacts(st, sq, k=TOP_K, p_cap=P_CAP, engine="q8r",
                                     candidates=Q8R_CANDIDATES, presorted=True)
    call()
    out, ms, counts = launched(f"SpladeIndex.search_impacts q8r, {BATCH} queries, Tq "
                               f"{SPLADE_TQ}", call, (K3, K2, K4, K6), reps=3)
    if not equal_np(out, S.sparse_score_topk_q8_rescored(
            *sx._device_packed(P_CAP), sdp, sds, *(torch.as_tensor(x, device=dev)
                                                   for x in (st, sq)),
            k=TOP_K, p_cap=P_CAP, candidates=Q8R_CANDIDATES, imp_bits=sbits, presorted=True)):
        raise AssertionError("SpladeIndex.search_impacts q8r differs from the direct ops call")
    res["launches"]["splade_q8r"], res["ms"]["splade_q8r"] = counts, ms

    first = BM25Retriever(ix, p_cap=P_CAP, engine="q8", presorted=True)
    queries = {t: t for t in texts}
    got, ms, counts = launched(f"BM25Retriever.retrieve_batch (q8, presorted), {BATCH} "
                               "queries", lambda: first.retrieve_batch(queries, top_k=TOP_K),
                               (K3, K2, K4))
    s8, i8 = res["index_q8"]
    for b, t in enumerate(texts):
        want = [(docnos[r], float(x), n + 1) for n, (x, r) in enumerate(zip(s8[b], i8[b]))
                if r >= 0]
        if got[t].results != want:
            raise AssertionError(f"BM25Retriever: query {t} differs from SparseIndex.search")
    res["launches"]["bm25_retrieve_batch"], res["ms"]["bm25_retrieve_batch"] = counts, ms

    q_emb = batches[0][4]

    class DocnoText:
        def get_text(self, docno):
            return docno

    def dense_encoder(items):
        rows = torch.as_tensor([int(x[1:]) for x in items], device=dev)
        return (rows_bf16 if items[0][0] == "d" else q_emb)[rows]

    two = TwoStageRetriever(first, DenseReranker(dense_encoder), DocnoText(),
                            first_stage_k=TOP_K, name="bm25_dense")
    sub = {t: t for t in texts[:TWO_STAGE_Q]}
    got, ms, counts = launched(f"TwoStageRetriever.retrieve_batch (BM25 q8 -> bf16 dense "
                               f"rerank), {TWO_STAGE_Q} queries", lambda: two.retrieve_batch(
                                   sub, top_k=TOP_K), (K3, K2, K4))
    for b, t in enumerate(sub):
        ids = [r for r in i8[b] if r >= 0]
        scores = (rows_bf16[torch.as_tensor(ids, device=dev)].float() @ q_emb[b]).cpu().numpy()
        order = np.argsort(-scores)
        want = [(docnos[ids[j]], float(scores[j]), n + 1) for n, j in enumerate(order)]
        if got[t].results != want:
            raise AssertionError(f"TwoStageRetriever: query {t} differs from its reranking")
    res["launches"]["two_stage"], res["ms"]["two_stage"] = counts, ms

    cfg, ms, counts = launched(
        f"autotune_sparse, {INDEX_SAMPLE} sample queries, baseline_chunk 8",
        lambda: autotune_sparse(ix, sample, baseline_chunk=8), (K3, K2, K6))
    log(f"  autotune_sparse chose {cfg.engine} p_cap {cfg.p_cap} candidates {cfg.candidates}"
        f" recall {cfg.recall} meets_target {cfg.meets_target}; sweep "
        f"{[(x['engine'], x['p_cap'], x['candidates'], round(x['recall'], 4)) for x in cfg.sweep]}")
    res["launches"]["autotune_sparse"], res["ms"]["autotune_sparse"] = counts, ms
    res["autotune"] = {k: getattr(cfg, k) for k in ("engine", "p_cap", "candidates", "recall",
                                                   "meets_target")}

    (_, build_ms) = timed_call(native.build_library)
    rng = np.random.default_rng(9)
    words = np.array([f"w{j}" for j in range(500)])
    pz = 1.0 / np.arange(1, 501)
    pz /= pz.sum()
    corpus = [(f"s{i}", " ".join(rng.choice(words, rng.integers(8, 30), p=pz)))
              for i in range(SMALL_DOCS)]
    small, small_ms = timed_call(lambda: IS.SparseIndex.build_bm25(corpus, device=dev))
    qs = [" ".join(rng.choice(words[:150], 4)) for _ in range(64)]
    out, ms, counts = launched(f"build_bm25 over {SMALL_DOCS} texts ({small_ms:.0f} ms; native "
                               f"library {native.library_path().name} ready in "
                               f"{build_ms:.0f} ms), q8 search of 64 queries",
                               lambda: small.search(qs, k=10, p_cap=128, engine="q8"), (K3, K2))
    cpu = IS.SparseIndex(small.offsets, small.docs, small.weights, small.doc_lens, small.docnos,
                         small.vocab_dump, small.params, device="cpu")
    if not equal_np(out, cpu.search(qs, k=10, p_cap=128, engine="q8")):
        raise AssertionError("build_bm25 index: the card's q8 search differs from the CPU's")
    res["launches"]["build_bm25"] = counts
    res.update(ix=ix, qt=qt, qw=qw, p_exact=p_exact)
    log(f"  ({smi})")
    return res


def index_cross_check(r):
    """CROSS_Q queries of the index layer's "exact" and "q8" searches on CPU
    copies of the index's arrays, bit for bit."""
    from qpp_fusion_rag_tpu_torch.ops import sparse as S

    ix, qt, qw = r["ix"], r["qt"][:CROSS_Q].cpu(), r["qw"][:CROSS_Q].cpu()
    c = [x.cpu() for x in ix._device_arrays()[:3]]
    want = S.sparse_score_topk(*c, qt, qw, k=TOP_K, p_cap=r["p_exact"])
    s, i = r["index_exact"]
    if not equal_np((s[:CROSS_Q], i[:CROSS_Q]), want):
        raise AssertionError("SparseIndex.search exact: card and CPU disagree")
    c = [x.cpu() for x in ix._device_packed(P_CAP)]
    want = S.sparse_score_topk_q8(*c, qt, qw, k=TOP_K, p_cap=P_CAP, exact_topk=True,
                                  presorted=True)
    s, i = r["index_q8"]
    if not equal_np((s[:CROSS_Q], i[:CROSS_Q]), want):
        raise AssertionError("SparseIndex.search q8: card and CPU disagree")
    log(f"  index layer: search exact and q8 of {CROSS_Q} queries equal on CPU copies")


def train_targets(feats_rsd, seed):
    """Seeded soft targets [n, R] that depend on the RSD feature of each
    view (standardized, plus unit noise), so the models have something to
    learn: softmax over the views."""
    rng = np.random.default_rng(seed)
    z = (feats_rsd - feats_rsd.mean(0)) / np.maximum(feats_rsd.std(0), 1e-6)
    logits = z + rng.standard_normal(z.shape)
    y = np.exp(logits - logits.max(1, keepdims=True))
    return (y / y.sum(1, keepdims=True)).astype(np.float32)


def params_close(g, c, what):
    for i, (lg, lc) in enumerate(zip(g, c)):
        for name in ("w", "b"):
            torch.testing.assert_close(lg[name].detach().cpu(), lc[name].detach(),
                                       rtol=TRAIN_RTOL, atol=TRAIN_ATOL,
                                       msg=lambda m: f"{what}, layer {i} {name}: {m}")


def training_and_models(rows_bf16, rows_i8, d_scale, fbatches, view_proj, smi, dev):
    """Phase [13]: the learned-fusion training step at full width, the same
    step against a CPU copy on a cut corpus, serving the trained weights
    through K7, FusionMLP.train and PerRetrieverGBDT.fit with the config
    defaults on the int8 route's raw QPP features. -> summary dict."""
    import copy

    from qpp_fusion_rag_tpu_torch.models import FusionMLP, PerRetrieverGBDT
    from qpp_fusion_rag_tpu_torch.ops.kernels import LAUNCHES
    from qpp_fusion_rag_tpu_torch.ops.kernels import dense_topk as DK
    from qpp_fusion_rag_tpu_torch.pipeline import engine as E

    out = {}
    log(f"[13a] learned_fusion_train_step at full width: {TRAIN_STEPS} steps over the "
        f"{len(fbatches)} flagship batches ({BATCH} queries, {VIEWS_R} views, "
        f"{tuple(rows_bf16.shape)} bf16 corpus, k {TOP_K}, chunk {TRAIN_CHUNK})")
    state, opt = E.make_train_state(torch.Generator(device=dev).manual_seed(13), VIEWS_R,
                                    VIEWS_R * 13)
    p0 = [{k: v.detach().clone() for k, v in layer.items()} for layer in state.params]
    gen = torch.Generator(device=dev).manual_seed(14)
    targets = torch.rand((BATCH, VIEWS_R), generator=gen, device=dev) + 0.05
    targets = targets / targets.sum(1, keepdim=True)
    LAUNCHES.clear()
    losses, step_ms = [], []
    for i in range(TRAIN_STEPS):
        q_emb, tf = fbatches[i % len(fbatches)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = E.learned_fusion_train_step(state, opt, q_emb, targets, view_proj,
                                                  rows_bf16, tf, k=TOP_K, chunk=TRAIN_CHUNK)
        losses.append(float(loss))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    if LAUNCHES:
        raise AssertionError(f"the training step launched kernels: {dict(LAUNCHES)}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training losses {losses}")
    moved = min(float((a[k].detach() - b[k]).abs().max()) for a, b in zip(state.params, p0)
                for k in ("w", "b"))
    if moved == 0:
        raise AssertionError("a parameter tensor did not move in training")
    med = statistics.median(step_ms[1:])
    log(f"  losses {losses}; every parameter tensor moved (least max change {moved:.3g}); "
        "no kernel launched (the plain route, as JAX's step)")
    log(f"  step ms: first {step_ms[0]:.3f}, median of the other {TRAIN_STEPS - 1} "
        f"{med:.3f} (all {[round(x, 3) for x in step_ms]}) ({smi})")
    out["train_step_ms"] = {"first": step_ms[0], "median": med, "all": step_ms}

    log(f"[13a'] the training step on the card and on a CPU copy: the first "
        f"{TRAIN_CUT_DOCS} docs, {TRAIN_CUT_Q} queries, the parameters and Adam state "
        "after [13a]")
    cut = rows_bf16[:TRAIN_CUT_DOCS]
    q_emb, tf = fbatches[0]
    runs = {}
    for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
        params = [{k: v.detach().to(d).clone().requires_grad_(True) for k, v in layer.items()}
                  for layer in state.params]
        o = torch.optim.Adam([p for layer in params for p in layer.values()], lr=1e-3,
                             betas=(0.9, 0.999), eps=1e-8)
        o.load_state_dict(copy.deepcopy(opt.state_dict()))   # steps update it in place
        st, loss = E.learned_fusion_train_step(
            E.TrainState(params, o.state), o, q_emb[:TRAIN_CUT_Q].to(d),
            targets[:TRAIN_CUT_Q].to(d), view_proj.to(d), cut.to(d), tf[:TRAIN_CUT_Q].to(d),
            k=TOP_K, chunk=TRAIN_CHUNK)
        runs[where] = (float(loss), st.params)
    (gl, gp), (cl, cp) = runs["card"], runs["cpu"]
    if abs(gl - cl) > TRAIN_RTOL * abs(cl):
        raise AssertionError(f"training step loss: card {gl} vs CPU {cl}")
    params_close(gp, cp, "training step parameters")
    err = max(float((a[k].detach().cpu() - b[k].detach()).abs().max())
              for a, b in zip(gp, cp) for k in ("w", "b"))
    log(f"  loss card {gl} vs CPU {cl}; parameters within rtol {TRAIN_RTOL}, atol "
        f"{TRAIN_ATOL} (max abs diff {err:.3g})")
    out["train_step_check"] = {"loss_card": gl, "loss_cpu": cl, "max_param_diff": err}

    log("[13b] serving the trained weights: learned_fused_retrieval_step on the K7 route "
        "(use_pallas=True, bf16 rows), one batch")
    trained = [{k: v.detach() for k, v in layer.items()} for layer in state.params]
    launches, _ = run_flagship(
        "learned_trained", lambda *a, **kw: E.learned_fused_retrieval_step(trained, *a, **kw),
        rows_bf16, fbatches[:1], view_proj, ("group_max_packed",), use_pallas=True)
    out["serve_trained"] = {"launches": launches}

    feats = []
    for q_emb, tf in fbatches:
        vals, ids = DK.pallas_multi_view_topk_int8(q_emb, view_proj, rows_i8, d_scale, k=TOP_K)
        qpp = E.qpp_from_runs(vals, ids, tf, normalize=False)
        feats.append(qpp.permute(1, 0, 2).reshape(BATCH, VIEWS_R * 13))
    X = torch.cat(feats).cpu().numpy()
    if not np.isfinite(X).all():
        raise AssertionError("non-finite raw QPP features")
    Y = train_targets(X[:, 5::13], seed=15)
    n_tr = int(0.8 * len(X))
    split = (X[:n_tr], Y[:n_tr], X[n_tr:], Y[n_tr:])
    names = [f"view{i}" for i in range(VIEWS_R)]

    log(f"[13c] FusionMLP.train with the config defaults on the int8 route's raw QPP "
        f"features {X.shape} (train {n_tr}, validation {len(X) - n_tr})")
    mlp = FusionMLP(names)
    t0 = time.perf_counter()
    info = mlp.train(*split)
    fit_s = time.perf_counter() - t0
    log(f"  hidden {mlp.hidden_sizes}, qpp_indices {mlp.qpp_indices}, dropout {mlp.dropout}, "
        f"batch {mlp.batch_size}, patience {mlp.patience}: {fit_s:.3f} s, epochs_run "
        f"{info['epochs_run']}, best_loss {info['best_loss']} ({smi})")
    cpu_mlp = copy.copy(mlp)
    cpu_mlp.device = "cpu"
    g, c = mlp.predict(X), cpu_mlp.predict(X)
    np.testing.assert_allclose(g, c, rtol=PREDICT_RTOL, atol=0,
                               err_msg="FusionMLP.predict: card vs CPU")
    log(f"  predict on the card equals a CPU copy within rtol {PREDICT_RTOL} "
        f"(max abs diff {float(np.abs(g - c).max()):.3g})")
    out["fusion_mlp"] = {"fit_s": fit_s, "epochs_run": info["epochs_run"],
                         "best_loss": info["best_loss"]}

    log("[13d] PerRetrieverGBDT.fit with the config defaults on the same split (host numpy)")
    gbdt = PerRetrieverGBDT(names)
    t0 = time.perf_counter()
    ginfo = gbdt.train(*split)
    gfit_s = time.perf_counter() - t0
    for b in gbdt.boosters:
        b.ensemble()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dev_pred = np.stack([b.predict(X) for b in gbdt.boosters], 1)
    pred_ms = (time.perf_counter() - t0) * 1e3
    host_pred = np.stack([b.predict(X, device=False) for b in gbdt.boosters], 1)
    np.testing.assert_allclose(dev_pred, host_pred, rtol=PREDICT_RTOL, atol=PREDICT_ATOL,
                               err_msg="GBDT predict: card traversal vs host loop")
    n_trees = {k: v["n_trees"] for k, v in ginfo.items()}
    log(f"  fit {gfit_s:.3f} s, trees per view {n_trees}; predict of {len(X)} rows on the "
        f"card (ops/trees traversal, {len(gbdt.boosters)} boosters) {pred_ms:.3f} ms, equal to "
        f"the host loop within rtol {PREDICT_RTOL}, atol {PREDICT_ATOL} (max abs diff "
        f"{float(np.abs(dev_pred - host_pred).max()):.3g}) ({smi})")
    out["gbdt"] = {"fit_s": gfit_s, "n_trees": n_trees, "predict_ms": pred_ms}
    return out


# ------------------------------------------------- [14] offline research path

OFFLINE_VIEWS = ("BM25", "Splade", "BGE", "BM25_TCT", "BM25_MonoT5")
FUSION_METHODS = ("combsum", "combmnz", "rrf", "wcombsum", "wcombmnz", "wrrf")
QPP_TOL = dict(rtol=1e-5, atol=1e-6)          # tests/test_torch_qpp_fusion.py
SUM_ORDER_TOL = dict(rtol=1e-4, atol=1e-5)    # RSD and snqc (tests/test_torch_fusion_engine.py)
SUM_ORDER_COLS = (5, 10)
FUSED_RTOL, TIE_RTOL = 1e-6, 4e-6             # fused scores; consecutive near-ties
METRIC_ATOL = 1e-6
QRELS_SEED, CORPUS_SEED = 14, 15


def offline_views(idx, batches):
    """[14a] The ensemble step's five views of each batch, formed with the
    step's own calls (pipeline/ensemble.py) in q8 mode over the presorted
    index: K2 and K3 under the sparse views, K1 under the dense view, the
    two rerank views over the BM25 candidates. -> (ids [5, Q, K] int32 corpus
    rows, PAD_ID padded; scores [5, Q, K] f32, -inf padded), host numpy."""
    from qpp_fusion_rag_tpu_torch.data.vocab import PAD_ID
    from qpp_fusion_rag_tpu_torch.pipeline.ensemble import (
        dense_view_topk,
        make_sparse_scorer,
        rerank_candidates,
    )

    sparse = make_sparse_scorer("q8", 0, TOP_K, P_CAP, presorted=True)
    ids, vals = [], []
    for bt, bq, st, sq, q_emb, proj, _ in batches:
        bm25_s, bm25_i = sparse(idx.bm25_packed, idx.bm25_offsets, idx.bm25_scales, bt, bq)
        splade_s, splade_i = sparse(idx.splade_packed, idx.splade_offsets, idx.splade_scales,
                                    st, sq)
        dense_s, dense_i = dense_view_topk(q_emb, idx.corpus_rows, idx.d_scale, TOP_K)
        qv = torch.einsum("bd,vdw->vbw", q_emb, proj)
        rr_s, rr_i = rerank_candidates(qv, bm25_i, idx.corpus_rows, idx.d_scale)
        vals.append(torch.stack([bm25_s, splade_s, dense_s, rr_s[0], rr_s[1]]))
        ids.append(torch.stack([bm25_i, splade_i, dense_i, rr_i[0], rr_i[1]]))
    ids, vals = torch.cat(ids, dim=1), torch.cat(vals, dim=1)
    valid = ids >= 0
    return (torch.where(valid, ids, PAD_ID).to(torch.int32).cpu().numpy(),
            torch.where(valid, vals.float(), float("-inf")).cpu().numpy())


def write_stage_files(root, rt, terms):
    """[14b] The stage files: each view's raw run and its min-max
    normalized run (write_trec), queries.jsonl (the BM25 term ids as
    words), a seeded qrels/test.tsv (1-4 relevant docs a query at grades
    1-2, alternately from the union of the views' top-20 and uniformly from
    the corpus) and a corpus .jsonl of the views' top-5 docs with seeded
    text. -> (queries, qrels, corpus texts, write_trec host seconds)."""
    t0 = time.perf_counter()
    norm = rt.minmax_normalized()
    for r, name in enumerate(rt.retrievers):
        rt.write_trec(r, root / "runs" / f"{name}.res")
        norm.write_trec(r, root / "runs" / f"{name}.norm.res")
    write_s = time.perf_counter() - t0
    queries = {q: " ".join(f"t{t}" for t in row if t >= 0) for q, row in zip(rt.qids, terms)}
    with open(root / "queries.jsonl", "w") as f:
        for q, text in queries.items():
            f.write(json.dumps({"_id": q, "text": text}) + "\n")
    rng = np.random.default_rng(QRELS_SEED)
    n_docs = len(rt.vocab)
    qrels = {}
    for qi, q in enumerate(rt.qids):
        top = rt.doc_ids[:, qi, :20]
        pool = np.unique(top[top >= 0])
        docs = [int(rng.choice(pool)) if j % 2 == 0 else int(rng.integers(0, n_docs))
                for j in range(int(rng.integers(1, 5)))]
        qrels[q] = {rt.vocab.docno_of(d): int(rng.integers(1, 3)) for d in docs}
    (root / "qrels").mkdir()
    with open(root / "qrels" / "test.tsv", "w") as f:
        f.write("query-id\tcorpus-id\tscore\n")
        for q, rels in qrels.items():
            for d, g in rels.items():
                f.write(f"{q}\t{d}\t{g}\n")
    top5 = np.unique(rt.doc_ids[:, :, :5])
    top5 = top5[top5 >= 0]
    words = np.random.default_rng(CORPUS_SEED).integers(0, 5000, (len(top5), 8))
    corpus = {}
    with open(root / "corpus.jsonl", "w") as f:
        for d, w in zip(top5.tolist(), words.tolist()):
            docno, title = rt.vocab.docno_of(d), f"Title {d}" if d % 3 == 0 else ""
            text = " ".join(f"w{x}" for x in w)
            f.write(json.dumps({"_id": docno, "title": title, "text": text}) + "\n")
            corpus[docno] = f"{title} {text}".strip() if title else text
    return queries, qrels, corpus, write_s


def read_back(root, rt, queries, qrels, corpus):
    """[14b] The loaders return what was written: the raw runs' docnos row
    for row with scores within the .6f rounding, the queries, the qrels and
    every corpus text. -> from_trec_dir host seconds."""
    from qpp_fusion_rag_tpu_torch.data import LazyCorpus, RunTensor, load_qrels, load_queries

    if load_queries(root) != queries:
        raise AssertionError("load_queries differs from queries.jsonl")
    if load_qrels(root / "qrels" / "test.tsv") != qrels:
        raise AssertionError("load_qrels differs from qrels/test.tsv")
    t0 = time.perf_counter()
    back = RunTensor.from_trec_dir(root / "runs", use_normalized=False)
    load_s = time.perf_counter() - t0
    if back.retrievers != sorted(rt.retrievers) or back.qids != rt.qids or back.K != rt.K:
        raise AssertionError(f"from_trec_dir: {back.retrievers}, {back.Q} queries, K {back.K}")
    # a docno "doc<i>" is corpus row i, as is a vocab id of rt
    rows = np.array([int(d[3:]) for d in back.vocab.docnos()] + [-1], np.int64)
    for r, name in enumerate(back.retrievers):
        src = rt.retrievers.index(name)
        if not np.array_equal(rows[back.doc_ids[r]], rt.doc_ids[src]):
            raise AssertionError(f"{name}: the runs read back hold other docnos")
        want, got = rt.scores[src], back.scores[r]
        ok = np.isneginf(want) == np.isneginf(got)
        fin = np.isfinite(want)
        ok[fin] = np.abs(got[fin] - want[fin]) <= 5.0001e-7 + np.abs(want[fin]) * 2.0 ** -23
        if not ok.all():
            raise AssertionError(f"{name}: scores read back beyond the .6f rounding")
    lazy = LazyCorpus(root / "corpus.jsonl")
    if len(lazy) != len(corpus) or lazy.get_many(list(corpus)) != corpus:
        raise AssertionError("LazyCorpus.get_many differs from corpus.jsonl")
    return load_s


def qpp_close(g, c, what):
    g, c = np.asarray(g), np.asarray(c)
    other = [i for i in range(13) if i not in SUM_ORDER_COLS]
    np.testing.assert_allclose(g[..., other], c[..., other], **QPP_TOL, err_msg=what)
    np.testing.assert_allclose(g[..., list(SUM_ORDER_COLS)], c[..., list(SUM_ORDER_COLS)],
                               **SUM_ORDER_TOL, err_msg=f"{what} (RSD, snqc)")
    return float(np.abs(g - c).max())


def check_fused(fused, q, k_out, what):
    """A fused run as check_step_output checks a step: [1, Q, k_out], unique
    real ids within the vocab, finite scores that never increase along a
    row; padding only at a row's end (a query whose views hold fewer than
    k_out distinct docs)."""
    ids, s = fused.doc_ids[0], fused.scores[0]
    if fused.doc_ids.shape != (1, q, k_out):
        raise AssertionError(f"{what}: shape {fused.doc_ids.shape}")
    valid = ids >= 0
    if (valid[:, 1:] & ~valid[:, :-1]).any() or not valid[:, 0].all():
        raise AssertionError(f"{what}: padding before a real id, or an empty row")
    if int(ids.max()) >= len(fused.vocab) or not np.isfinite(s[valid]).all():
        raise AssertionError(f"{what}: an id beyond the vocab, or a non-finite score")
    if (np.diff(np.where(valid, s, 0), axis=1)[valid[:, 1:]] > 0).any():
        raise AssertionError(f"{what}: fused scores increase along a row")
    srt = np.sort(np.where(valid, ids, -1 - np.arange(k_out)), axis=1)
    if (srt[:, 1:] == srt[:, :-1]).any():
        raise AssertionError(f"{what}: duplicate ids in a row")
    return int((~valid).sum())


def fused_close(g, c, what):
    """Card against CPU: scores within FUSED_RTOL; ids equal outside
    near-ties (groups of consecutive CPU scores within TIE_RTOL hold the
    same ids; the group a row's end cuts may hold other near-equal ids)."""
    np.testing.assert_allclose(g.scores, c.scores, rtol=FUSED_RTOL, atol=0, err_msg=what)
    gi, ci, gs, cs = g.doc_ids[0], c.doc_ids[0], g.scores[0], c.scores[0]
    rows = np.flatnonzero((gi != ci).any(axis=1))
    for b in rows:
        n, i = ci.shape[1], 0
        while i < n:
            j = i + 1
            while j < n and np.isclose(cs[b, j], cs[b, j - 1], rtol=TIE_RTOL, atol=0):
                j += 1
            if set(gi[b, i:j]) != set(ci[b, i:j]) and (
                    j < n or not np.allclose(gs[b, i:j], cs[b, i], rtol=TIE_RTOL, atol=0)):
                raise AssertionError(f"{what}: ids differ outside a near-tie at query {b}, "
                                     f"ranks {i}-{j - 1}")
            i = j
    return len(rows)


def phase_done(name, t0):
    sec = time.perf_counter() - t0
    log(f"  {name} done in {sec:.1f} s")
    return sec


def offline_research_path(idx, batches, smi, dev):
    """Phase [14]: the offline research path (stages 03-06 and 10) over the
    runs that the port's kernels produce. Runs on `dev`; every check holds
    the card against a CPU copy."""
    import tempfile

    from qpp_fusion_rag_tpu_torch.data import DocVocab, RunTensor, load_qpp_scores
    from qpp_fusion_rag_tpu_torch.evaluation import IREvaluator
    from qpp_fusion_rag_tpu_torch.fusion import oracle_report, run_fusion
    from qpp_fusion_rag_tpu_torch.fusion.argmax_qpp import argmax_qpp_experiment
    from qpp_fusion_rag_tpu_torch.fusion.probfuse import probfuse_experiment
    from qpp_fusion_rag_tpu_torch.ops.kernels import LAUNCHES
    from qpp_fusion_rag_tpu_torch.qpp import compute_qpp_dir, compute_qpp_for_runtensor
    from qpp_fusion_rag_tpu_torch.train import train_fusion_models

    out, sub = {}, {}
    n_docs = idx.corpus_rows.shape[0]
    t0 = time.perf_counter()
    (ids, vals), views_ms, launches = launched(
        "[14a] the five views of the three batches (q8, presorted)",
        lambda: offline_views(idx, batches),
        ("group_max_packed_int8", "bitonic_segsum_rows", "gather_windows"))
    q = ids.shape[1]
    vocab = DocVocab(f"doc{i}" for i in range(n_docs))
    rt = RunTensor.from_arrays(ids, vals, [f"test{i}" for i in range(q)], OFFLINE_VIEWS, vocab)
    log(f"  views {tuple(ids.shape)} ({rt.valid_counts.sum()} real entries) named "
        f"{list(OFFLINE_VIEWS)}, vocab of {len(vocab)} docnos in row order")
    out["views"] = {"ms": views_ms, "launches": launches, "shape": list(ids.shape)}
    sub["[14a]"] = phase_done("[14a]", t0)

    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    LAUNCHES.clear()
    with tempfile.TemporaryDirectory(dir=build, prefix="offline_") as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        terms = torch.cat([b[0] for b in batches]).cpu().numpy()
        queries, qrels, corpus, write_s = write_stage_files(root, rt, terms)
        load_s = read_back(root, rt, queries, qrels, corpus)
        n_lines = 2 * int(rt.valid_counts.sum())
        log(f"[14b] stage files: {n_lines} TREC lines (raw and .norm.res) written in "
            f"{write_s:.3f} s (write_trec, host), the raw runs read back in {load_s:.3f} s "
            f"(from_trec_dir, host): docnos equal row for row, scores within the .6f "
            f"rounding; queries, qrels ({sum(map(len, qrels.values()))} judgments) and "
            f"{len(corpus)} corpus texts (LazyCorpus.get_many) equal")
        out["files"] = {"write_trec_s": write_s, "from_trec_dir_raw_s": load_s,
                        "trec_lines": n_lines}
        sub["[14b]"] = phase_done("[14b]", t0)

        t0 = time.perf_counter()
        written = compute_qpp_dir(root / "runs", root / "qpp", root / "queries.jsonl",
                                  device=dev)
        stage_s = time.perf_counter() - t0
        if sorted(p.name for p in written) != sorted(f"{n}.res.mmnorm.qpp" for n in OFFLINE_VIEWS):
            raise AssertionError(f"compute_qpp_dir wrote {written}")
        qpp_data = load_qpp_scores(root / "qpp")
        if len(qpp_data) != q or any(sorted(v) != sorted(OFFLINE_VIEWS) or
                                     any(len(x) != 13 for x in v.values())
                                     for v in qpp_data.values()):
            raise AssertionError("load_qpp_scores: not 13 scores per (query, view)")
        g_qpp, qpp_ms = timed_call(lambda: compute_qpp_for_runtensor(rt, queries, device=dev))
        c_qpp = compute_qpp_for_runtensor(rt, queries, device="cpu")
        qpp_diff = qpp_close(g_qpp, c_qpp, "compute_qpp_for_runtensor: card vs CPU")
        log(f"[14c] QPP stage: compute_qpp_dir wrote {len(written)} .res.mmnorm.qpp files in "
            f"{stage_s:.3f} s (parse + device + write), read back {len(qpp_data)} queries x "
            f"{len(OFFLINE_VIEWS)} views; compute_qpp_for_runtensor [{', '.join(map(str, g_qpp.shape))}] "
            f"{qpp_ms:.3f} ms on the card, equal to a CPU copy within rtol "
            f"{QPP_TOL['rtol']} atol {QPP_TOL['atol']} (RSD, snqc rtol "
            f"{SUM_ORDER_TOL['rtol']} atol {SUM_ORDER_TOL['atol']}; max abs diff {qpp_diff:.3g})")
        out["qpp"] = {"qpp_dir_s": stage_s, "runtensor_ms": qpp_ms, "max_abs_diff": qpp_diff}
        sub["[14c]"] = phase_done("[14c]", t0)

        t0 = time.perf_counter()
        t1 = time.perf_counter()
        rt_norm = RunTensor.from_trec_dir(root / "runs")
        norm_load_s = time.perf_counter() - t1
        fused, fusion_ms, write_ms = {}, {}, {}
        for method in FUSION_METHODS + ("combsum@default",):
            name, k_out = method.split("@")[0], (None if "@" in method else TOP_K)
            g, fusion_ms[method] = timed_call(lambda: run_fusion(
                name, rt_norm, qpp_data, k_out=k_out, device=dev))
            if k_out:
                _, write_ms[method] = timed_call(lambda: run_fusion(
                    name, rt_norm, qpp_data, k_out=k_out, device=dev,
                    output_path=root / "fused" / f"{name}.res"))
            want_k = k_out or min(rt_norm.R * rt_norm.K, 512)
            n_pad = check_fused(g, q, want_k, method)
            c = run_fusion(name, rt_norm, qpp_data, k_out=k_out, device="cpu")
            n_diff = fused_close(g, c, f"{method}: card vs CPU")
            log(f"  {method}: [1, {q}, {want_k}] in {fusion_ms[method]:.3f} ms"
                + (f" ({write_ms[method]:.3f} ms with the TREC write)" if k_out else "")
                + f", {n_pad} padded slots; card = CPU ({n_diff} rows reordered inside "
                  f"near-ties)")
            fused[method] = g
        if sorted(p.name for p in (root / "fused").iterdir()) != sorted(
                f"{m}.res" for m in FUSION_METHODS):
            raise AssertionError("run_fusion's output files are missing")
        log(f"[14d] fusion over the .norm.res runs (loaded once, from_trec_dir "
            f"{norm_load_s:.3f} s host): {len(fused)} runs checked ({smi})")
        out["fusion"] = {"from_trec_dir_norm_s": norm_load_s, "ms": fusion_ms,
                         "ms_with_write": write_ms}
        sub["[14d]"] = phase_done("[14d]", t0)

        t0 = time.perf_counter()
        ev, ev_cpu = IREvaluator(device=dev), IREvaluator(device="cpu")
        runs = {name: (rt_norm, name) for name in OFFLINE_VIEWS}
        runs.update({m: (fused[m], 0) for m in FUSION_METHODS})
        table = {}
        for name, (run, r) in runs.items():
            g, c = ev.evaluate(run, qrels, retriever=r), ev_cpu.evaluate(run, qrels, retriever=r)
            bad = [m for m in g if abs(g[m] - c[m]) > METRIC_ATOL or not 0 < g[m] < 1]
            if bad or list(g) != ev.metric_names:
                raise AssertionError(f"{name}: metrics {bad} differ from the CPU copy by more "
                                     f"than {METRIC_ATOL} or lie outside (0, 1): {g} vs {c}")
            table[name] = g
        _, eval_ms = timed_call(lambda: ev.evaluate(fused["combsum"], qrels))
        oracle = oracle_report(rt_norm, qrels, device=dev)
        if not (oracle["oracle_metric"] >= oracle["best_single"] > 0
                and sum(oracle["selection_histogram"].values()) == q):
            raise AssertionError(f"oracle_report: {oracle['oracle_metric']}, "
                                 f"{oracle['best_single']}, {oracle['selection_histogram']}")
        n_tr = int(0.8 * q)
        pf = probfuse_experiment(rt_norm, qrels, rt_norm.qids[:n_tr], rt_norm.qids[n_tr:],
                                 device=dev)
        am = argmax_qpp_experiment(rt_norm, qpp_data, qrels, device=dev)
        if not 0 < pf["nDCG@10"] < 1 or len(am) != 13 or any(
                sum(v["histogram"].values()) != q for v in am.values()):
            raise AssertionError(f"probfuse {pf['nDCG@10']} or argmax-QPP {am}")
        best_col = max(am, key=lambda k: am[k]["nDCG@10"])
        log(f"[14e] evaluation: {len(ev.metric_names)} metrics x {len(runs)} runs on the card, "
            f"each aggregate equal to a CPU copy within {METRIC_ATOL}; one "
            f"IREvaluator.evaluate {eval_ms:.3f} ms. nDCG@10 by run ({smi}):")
        for name, g in table.items():
            log(f"    {name:12s} {g['nDCG@10']:.6f}")
        log(f"    {'oracle':12s} {oracle['oracle_metric']:.6f} (best single "
            f"{oracle['best_single']:.6f}; selections {oracle['selection_histogram']})")
        log(f"    {'probfuse':12s} {pf['nDCG@10']:.6f} (train {n_tr} queries, test {q - n_tr})")
        log(f"    argmax-QPP, best column {best_col} {am[best_col]['nDCG@10']:.6f} "
            f"({am[best_col]['histogram']}); RSD {am['RSD']['nDCG@10']:.6f}")
        out["evaluation"] = {"evaluate_ms": eval_ms,
                             "ndcg10": {k: v["nDCG@10"] for k, v in table.items()},
                             "oracle": oracle["oracle_metric"], "probfuse": pf["nDCG@10"],
                             "argmax_best": [best_col, am[best_col]["nDCG@10"]]}
        sub["[14e]"] = phase_done("[14e]", t0)

        t0 = time.perf_counter()
        res = train_fusion_models(rt_norm, qpp_data, qrels, model_types=("per_retriever", "mlp"),
                                  output_dir=root / "models", device=dev)
        train_s = time.perf_counter() - t0
        path = res["mlp"]["path"]
        g, learned_ms = timed_call(lambda: run_fusion("learned", rt_norm, qpp_data,
                                                      model_path=path, k_out=TOP_K, device=dev))
        check_fused(g, q, TOP_K, "learned")
        c = run_fusion("learned", rt_norm, qpp_data, model_path=path, k_out=TOP_K, device="cpu")
        n_diff = fused_close(g, c, "learned: card vs CPU")
        base = res["_baselines"]
        log(f"[14f] stage 04: train_fusion_models (per_retriever, mlp) {train_s:.3f} s on "
            f"{base['n_train']} / {base['n_test']} queries; fused nDCG@10 on the test slice: "
            f"uniform {base['uniform']:.6f}, oracle {base['oracle']:.6f}, per_retriever "
            f"{res['per_retriever']['fused_nDCG@10']:.6f}, mlp {res['mlp']['fused_nDCG@10']:.6f} "
            f"({res['mlp']['train_info']['epochs_run']} epochs); run_fusion('learned', "
            f"fusion_mlp.pkl) {learned_ms:.3f} ms, card = CPU ({n_diff} rows reordered inside "
            f"near-ties) ({smi})")
        out["train"] = {"s": train_s, "learned_ms": learned_ms,
                        "baselines": {k: base[k] for k in ("uniform", "oracle")},
                        "fused_ndcg10": {m: res[m]["fused_nDCG@10"]
                                         for m in ("per_retriever", "mlp")}}
        sub["[14f]"] = phase_done("[14f]", t0)
    out["launches_after_14a"] = dict(LAUNCHES)
    out["sub_s"] = sub
    log(f"  launches in [14b-f] {dict(LAUNCHES)} (no kernel: the offline stages are torch "
        "ops, as JAX's are plain XLA)")
    return out


def main() -> None:
    if not (ROOT / "qpp_fusion_rag_tpu_torch" / "__init__.py").is_file():
        raise SystemExit("chip_smoke.py: no qpp_fusion_rag_tpu_torch package beside "
                         "this script; run it from the root of a checkout")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch.cuda.is_available() is False; "
                         "this check runs only on an NVIDIA GPU")
    sys.path.insert(0, str(ROOT))
    from qpp_fusion_rag_tpu_torch.ops import sparse as S
    from qpp_fusion_rag_tpu_torch.ops.kernels import _build, dense_topk
    from qpp_fusion_rag_tpu_torch.pipeline.ensemble import dense_view_rescored
    from qpp_fusion_rag_tpu_torch.pipeline.interop import indexes_from_numpy

    t_all = time.perf_counter()
    phase_s = {}
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
        if any(k in line for k in ("registers", "spill", "arning")) or line.startswith("=="):
            log(f"    ptxas: {line.strip()}")
    kernel_ptxas = ptxas_summary(build_log)
    log("    ptxas, bitonic kernels, K6 and the wgmma group max (registers, spill stores / "
        "loads, stack bytes): "
        + "; ".join(
        f"{k} [{v['source']}] {v.get('registers')} regs, {v.get('spill_stores')} / "
        f"{v.get('spill_loads')} spill, {v.get('stack')} stack"
        for k, v in kernel_ptxas.items()))

    t0 = time.perf_counter()
    h = host_build(N_DOCS, dev)
    host_s = time.perf_counter() - t0
    imp_bits = h["imp_bits"]
    t0 = time.perf_counter()
    rows, scale, rows_bf16 = dense_corpus(N_DOCS, dev)
    idx = indexes_from_numpy({f"{v}_{f}": h[f"{v}_{f}"] for v in VIEWS
                              for f in ("packed", "scales", "offsets")}
                             | {"corpus_rows": rows, "d_scale": scale}, dev)
    idx_rs = idx._replace(rerank_rows=rows_bf16, doc_imp_bits=imp_bits, **{
        f"{v}_{f}": h[f"{v}_{f}"] for v in VIEWS for f in ("doc_packed", "doc_scale", "tail")})
    # the impact-ordered layout of the "sort" and window-rescore modes
    idx_sort = idx._replace(**{
        f"{v}_{f}": torch.as_tensor(x, device=dev) for v in VIEWS for f, x in (
            ("packed", h[f"{v}_plain_packed"]),
            ("offsets", h[f"{v}_csr_offsets"].astype(np.int32)))})
    csr = {v: (h[f"{v}_csr_offsets"], h[f"{v}_csr_docs"], h[f"{v}_csr_w"]) for v in VIEWS}
    torch.cuda.synchronize()
    log(f"[3] host build {host_s:.1f} s (n_docs {N_DOCS}, no cut); dense corpus "
        f"{tuple(rows.shape)} int8 + bf16 rerank rows + index upload "
        f"{time.perf_counter() - t0:.1f} s")
    batches = make_batches(h, dev)
    from qpp_fusion_rag_tpu_torch.data.synthetic import zipf_queries
    long_q = [torch.as_tensor(x, device=dev) for x in zipf_queries(
        h["splade_csr_offsets"], BATCH, n_terms=LONG_TQ, seed=8)]
    del h

    log("[4] kernels vs plain versions on the card, main-path shapes")
    res = kernels_vs_plain(idx_rs, batches[0], imp_bits)

    q8_kernels = ("group_max_packed_int8", "row_topk", "bitonic_segsum_rows", "gather_windows")
    log(f"[5] q8 path: ensemble_retrieval_step (q8, presorted), {len(batches)} batches of "
        f"{BATCH} queries, {N_DOCS} docs")
    q8_launches, _ = run_path("q8", idx, batches, q8_kernels + ("q8_topk",), sparse_mode="q8")

    q8r_kernels = q8_kernels + ("bitonic_topp_rows", "rescore_match")
    log(f"[6] q8r path: ensemble_retrieval_step (q8r, {Q8R_CANDIDATES} candidates, dense "
        f"pool {DENSE_POOL}, bf16 rerank rows, doc_imp_bits {imp_bits}), {len(batches)} "
        f"batches of {BATCH} queries, {N_DOCS} docs")
    q8r_launches, _ = run_path(
        "q8r", idx_rs, batches, q8r_kernels, sparse_mode="q8r",
        sparse_candidates=Q8R_CANDIDATES, dense_rescore_pool=DENSE_POOL,
        doc_imp_bits=imp_bits)

    bt, bq, st, sq, q_emb, _, _ = batches[0]
    log(f"[6b] q8c path: ensemble_retrieval_step (q8c, {Q8R_CANDIDATES} candidates, dense "
        f"pool {DENSE_POOL}, bf16 rerank rows, doc_imp_bits {imp_bits}, doc_cap {DOC_CAP} "
        f"with tails), {len(batches)} batches of {BATCH} queries, {N_DOCS} docs")
    q8c_launches, q8c_outs = run_path(
        "q8c", idx_rs, batches, q8r_kernels, sparse_mode="q8c",
        sparse_candidates=Q8R_CANDIDATES, dense_rescore_pool=DENSE_POOL,
        doc_imp_bits=imp_bits)
    certified = torch.cat([out[3] for out in q8c_outs])
    certified_frac = float(certified.float().mean())
    log(f"certified_frac {certified_frac} ({int(certified.sum())} of {certified.numel()} "
        "queries: both sparse views certified)")

    log(f"[6c] q8c soundness: each sparse view's certified scorer on batch 0 on the card, "
        f"{CROSS_Q} queries of each checked against exhaustive float64 scores")
    q8c_cert = {view: certified_soundness(idx_rs, view, terms, qw, csr[view], imp_bits)
                for view, terms, qw in (("bm25", bt, bq), ("splade", st, sq))}

    log("[6d] q8c f32 rescore route: one BM25 call of batch 0 with doc_terms / doc_w")
    f32_cert, doc_terms, doc_w = f32_route(idx_rs, csr["bm25"], bt, bq, imp_bits, dev)

    sort_kernels = ("group_max_packed_int8", "row_topk", "gather_windows", "run_sums_topk")
    log(f"[6e] sort path: ensemble_retrieval_step (sparse_mode 'sort', the impact-ordered "
        f"layout), {len(batches)} batches of {BATCH} queries")
    sort_launches, _ = run_path("sort", idx_sort, batches, sort_kernels, presorted=False,
                                sparse_mode="sort")
    res["run_sums_topk"] = run_sums_vs_plain(idx_sort, batches[0])
    log(f"[6f] window rescore: one ensemble_retrieval_step (sparse_candidates "
        f"{WINDOW_CANDIDATES}: a pool of {WINDOW_CANDIDATES * TOP_K} raw contributions per view)")
    win_launches, _ = run_path("window_rescore", idx_sort, batches[:1], sort_kernels[:3],
                               presorted=False, sparse_candidates=WINDOW_CANDIDATES)

    t_ix = time.perf_counter()
    log(f"[6g] sparse index layer: SparseIndex over the BM25 CSR and SpladeIndex over the "
        f"SPLADE CSR ({N_DOCS} docs): search per engine, search_certified, search_impacts, "
        f"BM25Retriever, TwoStageRetriever, autotune_sparse, build_bm25")
    ix_res = index_layer(csr, batches, rows_bf16, idx, idx_sort, dev, smi)
    phase_s["[6g] sparse index layer"] = time.perf_counter() - t_ix

    log(f"[7] q8r pool fallback: one BM25 sparse_score_topk_q8_rescored call at "
        f"{FALLBACK_CANDIDATES} candidates (bs 16384, 2*bs > M = {BM25_TQ * P_CAP})")
    bm25_rs = view_args(idx_rs, "bm25", ("packed", "offsets", "scales", "doc_packed",
                                         "doc_scale"))
    fb_kw = dict(k=TOP_K, p_cap=P_CAP, candidates=FALLBACK_CANDIDATES, imp_bits=imp_bits,
                 presorted=True)
    (fb_s, fb_i), fb_ms, fb_launches = launched(
        "fallback call", lambda: S.sparse_score_topk_q8_rescored(*bm25_rs, bt, bq, **fb_kw),
        ("bitonic_sort_rows",))
    if fb_launches.get("bitonic_topp_rows", 0):
        raise AssertionError(f"the fallback call did not take the K5 pool: {fb_launches}")

    log(f"[7b] long rows: SPLADE queries of {LONG_TQ} terms, M = {LONG_TQ} x {P_CAP} = "
        f"{LONG_TQ * P_CAP} keys (K2 on a cluster of four CTAs per row, K4 on its warp "
        f"route): one "
        f"sparse_score_topk_q8 and one q8r call of {BATCH} queries")
    lt, lw = long_q
    splade_rs = view_args(idx_rs, "splade", ("packed", "offsets", "scales", "doc_packed",
                                             "doc_scale"))
    rs_kw = dict(k=TOP_K, p_cap=P_CAP, candidates=Q8R_CANDIDATES, imp_bits=imp_bits,
                 presorted=True)
    long_out, long_launches, long_ms = {}, {}, {}
    for mode, expect, call in (
            ("q8", ("bitonic_segsum_rows", "q8_topk"), lambda: S.sparse_score_topk_q8(
                *splade_rs[:3], lt, lw, k=TOP_K, p_cap=P_CAP, presorted=True)),
            ("q8r", ("bitonic_segsum_rows", "bitonic_topp_rows", "rescore_match"),
             lambda: S.sparse_score_topk_q8_rescored(*splade_rs, lt, lw, **rs_kw))):
        long_out[mode], long_ms[mode], long_launches[mode] = launched(
            f"long-row {mode} call", call, expect)
        if int((long_out[mode][1] >= 0).sum()) == 0:
            raise AssertionError(f"the long-row {mode} call found no documents")
    packed, offsets, scales = view_args(idx_rs, "splade")
    long_keys, _, long_sb = S._q8_keys(packed, offsets, scales, lt, lw, P_CAP, presorted=True)
    long_sums, long_sids, long_wmax = S._q8_row_sums(packed, offsets, scales, lt, lw, P_CAP,
                                                     presorted=True)
    long_row_kernels(res, long_keys, long_sb, S._pool_keys(long_sums), LONG_TQ)
    q8_rows = [(*S._q8_row_sums(*view_args(idx, view), terms, qw, P_CAP, presorted=True),
                terms.shape[1]) for view, terms, qw in (("bm25", bt, bq), ("splade", st, sq))]
    res["q8_topk"] = q8_topk_vs_plain(q8_rows + [(long_sums, long_sids, long_wmax, LONG_TQ)])
    del long_keys, long_sums, long_sids, long_wmax, q8_rows

    log(f"[8] cross-check of the kernel views for {CROSS_Q} queries on CPU copies")
    for view, terms, qw in (("bm25", bt, bq), ("splade", st, sq)):
        c = [x.cpu() for x in view_args(idx_rs, view, ("packed", "offsets", "scales",
                                                       "doc_packed", "doc_scale", "tail"))]
        tail = c.pop()
        g_cert, rows = q8c_cert[view]
        rows_t = torch.as_tensor(rows)
        c_cert = S.certify(*c, terms.cpu()[rows_t], qw.cpu()[rows_t], k=TOP_K, p_cap=P_CAP,
                           candidates=Q8R_CANDIDATES, imp_bits=imp_bits, presorted=True,
                           tail_max=tail)
        certificate_close(g_cert, c_cert, rows, f"{view} q8c")
        if view == "bm25":
            c_cert = S.certify(*c, terms[:CROSS_Q].cpu(), qw[:CROSS_Q].cpu(), k=TOP_K,
                               p_cap=P_CAP, candidates=Q8R_CANDIDATES, imp_bits=imp_bits,
                               presorted=True, doc_terms=torch.from_numpy(doc_terms),
                               doc_w=torch.from_numpy(doc_w))
            certificate_close(f32_cert, c_cert, np.arange(CROSS_Q), "bm25 q8c f32 route")
            del doc_terms, doc_w
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
        else:
            lt_c, lw_c = lt[:CROSS_Q].cpu(), lw[:CROSS_Q].cpu()
            g_s, g_i = long_out["q8"]
            c_s, c_i = S.sparse_score_topk_q8(*c[:3], lt_c, lw_c, k=TOP_K, p_cap=P_CAP,
                                              presorted=True)
            if not (torch.equal(g_i[:CROSS_Q].cpu(), c_i)
                    and torch.equal(g_s[:CROSS_Q].cpu(), c_s)):
                raise AssertionError(f"splade q8 at Tq {LONG_TQ}: card and CPU disagree")
            g_s, g_i = long_out["q8r"]
            c_s, c_i = S.sparse_score_topk_q8_rescored(*c, lt_c, lw_c, **rs_kw)
            assert_close_ranking(g_s[:CROSS_Q].cpu(), g_i[:CROSS_Q].cpu(), c_s, c_i,
                                 f"splade q8r at Tq {LONG_TQ}")
        del c
    index_cross_check(ix_res)
    del ix_res["ix"]
    c_rows, c_scale = idx_rs.corpus_rows.cpu(), idx_rs.d_scale.cpu()
    g_s, g_i = dense_topk.pallas_dense_topk_int8(q_emb, idx_rs.corpus_rows, idx_rs.d_scale, k=TOP_K)
    c_s, c_i = dense_topk.pallas_dense_topk_int8(q_emb[:CROSS_Q].cpu(), c_rows, c_scale, k=TOP_K)
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
    log(f"  q8 views (SPLADE at Tq {LONG_TQ} too) and dense view equal; q8r views (SPLADE "
        f"at Tq {LONG_TQ} too), the K5 fallback and the rescored dense view within rtol "
        f"{RTOL} (ids up to near-tie swaps); q8c views (the f32 route too): scores within "
        f"rtol {RTOL}, slack within the tie band, certified equal outside it")
    log("  cross-check ok")

    phase_s["[1-8] ensemble paths and cross-check"] = time.perf_counter() - t_all

    from qpp_fusion_rag_tpu_torch.ops.kernels import streaming_topk
    from qpp_fusion_rag_tpu_torch.pipeline.engine import (
        fused_retrieval_step,
        learned_fused_retrieval_step,
    )
    from qpp_fusion_rag_tpu_torch.pipeline.interop import mlp_params_from_numpy

    t0 = time.perf_counter()
    rows_bf16 = idx_rs.rerank_rows
    fbatches, view_proj, mlp = flagship_inputs(batches, dev)
    log(f"[9] dense kernels K7-K10, and K1 at the flagship's rows, vs plain on the card over "
        f"the full corpus {tuple(rows_bf16.shape)} (flagship: {VIEWS_R} views x {BATCH} "
        f"queries)")
    dres, cmax = dense_kernels_vs_plain(rows_bf16, fbatches[0][0], view_proj, idx.corpus_rows,
                                        idx.d_scale, res["group_max_packed_int8"])
    res.update(dres)
    phase_s["[9] dense kernels vs plain"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    log(f"[10] dense flagship: fused_retrieval_step, {VIEWS_R} views, {len(batches)} batches "
        f"of {BATCH} queries, {N_DOCS} docs, on each route")
    flag_launches = {}
    for name, corpus, kernel, kw in (
            ("flagship_int8", idx.corpus_rows, "group_max_packed_int8",
             dict(corpus_scale=idx.d_scale)),
            ("flagship_bf16", rows_bf16, "group_max_packed", dict(use_pallas=True))):
        flag_launches[name], _ = run_flagship(
            name, fused_retrieval_step, corpus, fbatches, view_proj, (kernel, "row_topk"), **kw)
    params = mlp_params_from_numpy(mlp, dev)
    flag_launches["flagship_learned"], _ = run_flagship(
        "flagship_learned", lambda *a, **kw: learned_fused_retrieval_step(params, *a, **kw),
        rows_bf16, fbatches[:1], view_proj, ("group_max_packed", "row_topk"), use_pallas=True)
    phase_s["[10] flagship paths"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    log(f"[11] dense entry points, one full-size call each ({BATCH} queries)")
    rows_g, scale_g = global_int8(rows_bf16)
    entry = {
        "dense_topk_stride4": entry_call(
            "pallas_dense_topk(packed=False, stride=4)", "group_max_scores",
            lambda: dense_topk.pallas_dense_topk(q_emb, rows_bf16, k=TOP_K, packed=False,
                                                 stride=4), N_DOCS),
        "int8_global": entry_call(
            "pallas_dense_topk_int8_global", "group_max_packed_int8_global",
            lambda: dense_topk.pallas_dense_topk_int8_global(q_emb, rows_g, scale_g, k=TOP_K),
            N_DOCS),
        "streaming": entry_call(
            "streaming_dense_topk", "streaming_group_max",
            lambda: streaming_topk.streaming_dense_topk(q_emb, rows_bf16, k=TOP_K), N_DOCS),
    }
    del rows_g
    phase_s["[11] entry points"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    log(f"[12] flagship cross-check of {CROSS_Q} queries on CPU copies")
    flagship_cross_check(rows_bf16, idx.corpus_rows, idx.d_scale, fbatches[0], view_proj, cmax)
    log("  cross-check ok")
    phase_s["[12] flagship cross-check"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    log("[13] training and the fusion models")
    train_res = training_and_models(rows_bf16, idx.corpus_rows, idx.d_scale, fbatches,
                                    view_proj, smi, dev)
    phase_s["[13] training and the fusion models"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    log(f"[14] offline research path: the five ensemble views of the {len(batches)} batches "
        f"as runs, stage files, QPP stage, fusion, evaluation, stage 04")
    offline = offline_research_path(idx, batches, smi, DEVICE)
    phase_s["[14] offline research path"] = time.perf_counter() - t0

    src = "qpp_fusion_rag_tpu_torch/csrc/"
    tpu = "qpp_fusion_rag_tpu/ops/pallas/"
    # kernel -> (source, TPU kernel it replaces, its main path)
    meta = {"group_max_packed_int8": (src + "dense_topk_int8.cu", tpu + "dense_topk.py:184", "q8r"),
            "bitonic_segsum_rows": (src + "bitonic_segsum.cu", tpu + "bitonic.py:275", "q8r"),
            "gather_windows": (src + "window_gather.cu", tpu + "window_gather.py:101", "q8r"),
            "bitonic_topp_rows": (src + "bitonic_topp.cu", tpu + "bitonic.py:166", "q8r"),
            "bitonic_sort_rows": (src + "bitonic_sort.cu", tpu + "bitonic.py:93", "q8r_fallback"),
            "rescore_match": (src + "rescore_match.cu", tpu + "row_gather.py:122", "q8r"),
            "group_max_packed": (src + "group_max_packed.cu", tpu + "dense_topk.py:378",
                                 "flagship_bf16"),
            "group_max_scores": (src + "group_max_scores.cu", tpu + "dense_topk.py:423",
                                 "dense_topk_stride4"),
            "group_max_packed_int8_global": (src + "group_max_int8_global.cu",
                                             tpu + "dense_topk.py:258", "int8_global"),
            "streaming_group_max": (src + "group_max_scores.cu", tpu + "streaming_topk.py:91",
                                    "streaming"),
            "row_topk": (src + "row_topk.cu", "none (lax.top_k: XLA's merge)", "flagship_int8"),
            "run_sums_topk": (src + "run_sums_topk.cu",
                              "none (the \"sort\" engine: XLA's cumsum and lax.top_k)", "sort"),
            "q8_topk": (src + "q8_topk.cu", "none (q8's lax.top_k / approx_max_k: XLA's)", "q8")}
    paths = {"q8": q8_launches, "q8r": q8r_launches, "q8c": q8c_launches,
             "sort": sort_launches, "window_rescore": win_launches, "q8r_fallback": fb_launches,
             "splade_q8_tq32": long_launches["q8"], "splade_q8r_tq32": long_launches["q8r"],
             **flag_launches, "learned_trained": train_res["serve_trained"]["launches"],
             **entry, **ix_res["launches"]}
    kernels = []
    for name, (source, replaces, main_path) in meta.items():
        ptxas = {k: v for k, v in kernel_ptxas.items() if source.endswith(v["source"])}
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": paths[main_path].get(name, 0),
                        "path": main_path,
                        "launches_by_path": {p: c.get(name, 0) for p, c in paths.items()},
                        **res[name], **({"ptxas": ptxas} if ptxas else {})})
    for name, sec in phase_s.items():
        log(f"  {name}: {sec:.1f} s")
    log(f"  total {time.perf_counter() - t_all:.1f} s; "
        f"q8c certified_frac {certified_frac}; fallback call {fb_ms:.1f} ms; SPLADE Tq {LONG_TQ} calls ms {long_ms}; host build "
        f"{host_s:.1f} s; kernel build {build_s:.1f} s; {smi}")
    log(f"  index layer ({smi}): call ms {ix_res['ms']}; lazy device arrays s "
        f"{ix_res['lazy_s']}; search_certified {ix_res['certified']}; autotune_sparse "
        f"{ix_res['autotune']}")
    log(f"  training and the fusion models ({smi}): {json.dumps(train_res)}")
    log(f"  offline research path ({smi}): {json.dumps(offline)}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
