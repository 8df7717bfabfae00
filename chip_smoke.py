#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (qpp_fusion_rag_tpu_torch) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It builds the port's CUDA kernels from csrc/ (one nvcc per source, in
parallel, into build/torch_kernels/), builds the bench-scale synthetic index
on the host (2,621,440 docs, BM25 and SPLADE presorted postings at p_cap
2048, their doc-major term vectors at imp_bits 14 and doc_cap 128) and the
768-wide dense corpus on the card from a seed (int8 rows for the kernels,
bf16 rows of the same draws for the rank-safe rerank and the dense
flagship), holds each kernel against its plain PyTorch version at the main
paths' shapes (with its bound from those shapes and, where one PyTorch call
computes the same function, that call's time), then drives the ensemble
step for 12 steps (4 passes over three batches of 1024 queries) in q8 mode
and 12 in rank-safe q8r mode (256 sparse candidates, a 128-doc dense pool),
one q8r BM25 call at 8192 candidates (the pool's full-sort branch), and one
q8 and one q8r SPLADE call of 32-term queries (rows of 65,536 keys: K2 on
four-CTA clusters), with K2 and K4 then timed alone at those rows. The
registers and spill bytes that ptxas reported for the bitonic kernels (K2,
K4, K5) are printed after the build. The dense flagship follows (R = 5 views, 5,120
scoring rows per batch): K7-K10 against their plain versions on the full
corpus (K7 in both layouts; K1 again at the 5,120 rows), fused_retrieval_step for 12 steps on the int8
route (K1) and 12 on the bf16 route (K7), learned-fusion calls, one
full-size call of each dense entry point (K8 at stride 4, K9, K10), and a
torch.profiler window of 3 steps per main path (device busy share, top
kernels). Each path checks that every kernel it runs launched, with the
counts set to 0 just before it. Last, the kernel-bearing views and the
flagship's runs and fused outputs are cross-checked against the plain
versions on CPU copies. Every phase raises on failure and prints its
seconds. The line before the last is a JSON summary of the ten kernels;
the last line is

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
ROUNDS = 4                        # passes over the batches: 12 steps per path, 1 warm-up
PROFILE_STEPS = 3
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
HBM_BPS = 3.35e12                 # H100 SXM device memory, bytes/s
PEAK_OPS = {"int8": 1979e12, "bf16": 989e12}   # H100 SXM dense tensor-core peaks


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
    tb, to = nbytes / HBM_BPS * 1e3, ops / PEAK_OPS[kind] * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def ptxas_summary(build_log: str):
    """Registers and spill bytes that ptxas reported (-Xptxas -v) for each
    kernel of the bitonic sources (K2, K4, K5). -> {kernel<template args>:
    {"source", "registers", "stack", "spill_stores", "spill_loads"}}."""
    sources = ("bitonic_segsum.cu", "bitonic_topp.cu", "bitonic_sort.cu")
    out, src, fn = {}, None, None
    for line in build_log.splitlines():
        if line.startswith("== "):
            src, fn = line[3:].strip(), None
        elif m := re.search(r"(?:Compiling entry function '|Function properties for )(\w+)", line):
            fn = m.group(1)
        if src not in sources or fn is None:
            continue
        name = re.search(r"([a-z_]+_kernel)((?:ILi\d+E(?:Li\d+E)*E)?)", fn)
        if name is None:
            continue
        args = re.findall(r"Li(\d+)E", name.group(2))
        key = name.group(1) + (f"<{', '.join(args)}>" if args else "")
        entry = out.setdefault(key, {"source": src})
        if m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line):
            entry.update(stack=int(m[1]), spill_stores=int(m[2]), spill_loads=int(m[3]))
        elif m := re.search(r"Used (\d+) registers", line):
            entry["registers"] = int(m[1])
    return out


def long_row_kernels(res, keys, start_block, pkeys, tq):
    """K2 and K4 alone at rows of 65,536 keys (the SPLADE Tq 32 call's keys
    and pool keys), against their plain versions, bit for bit; their times,
    bounds and (K4) torch.topk's time go into their entries of `res` as
    *_65536."""
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
    log(f"  K2 alone at {tuple(keys.shape)} start_block={start_block}: equal to plain; kernel "
        f"{r['ms_65536']:.3f} ms, plain {r['plain_ms_65536']:.3f} ms, bound "
        f"{r['bound_ms_65536']:.4f} ms (bytes)")
    log(f"  K4 alone at {tuple(pkeys.shape)} bs=1024: equal to plain "
        f"({int((pkeys >= 0).sum())} run keys); kernel {r4['ms_65536']:.3f} ms, plain "
        f"{r4['plain_ms_65536']:.3f} ms, torch.topk {r4['library_ms_65536']:.3f} ms, bound "
        f"{r4['bound_ms_65536']:.4f} ms (bytes)")


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


def drive(name, step_fn, batches, smi, expect, n_docs, rounds=ROUNDS):
    """Run step_fn over the batches `rounds` times with the launch counts
    set to 0 just before; check the first round's outputs and that every
    kernel in `expect` launched. -> (launch counts, per-step ms: the first
    step is the warm-up, the rest steady)."""
    from qpp_fusion_rag_tpu_torch.ops.kernels import LAUNCHES

    LAUNCHES.clear()
    outs, step_ms = [], []
    for r in range(rounds):
        for batch in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step_fn(batch)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if r == 0:
                outs.append(out)
    launches = dict(LAUNCHES)
    steady = step_ms[1:] or step_ms
    med = statistics.median(steady)
    log(f"  {name}: {len(step_ms)} steps; first {step_ms[0]:.1f} ms, steady median {med:.3f} ms "
        f"(min {min(steady):.3f}, max {max(steady):.3f}) -> {BATCH / med * 1e3:.0f} q/s ({smi})")
    log(f"  launches during the {name} path: {launches}")
    missing = [k for k in expect if launches.get(k, 0) < 1]
    if missing:
        raise AssertionError(f"kernels of the {name} path never launched: {missing}")
    for out in outs:
        check_step_output(out, n_docs)
    log("  outputs: shapes, finite QPP, non-increasing fused scores, unique ids < N: ok")
    return launches, step_ms


def run_path(name, idx, batches, smi, expect, **kw):
    """The ensemble step over the batches (drive)."""
    from qpp_fusion_rag_tpu_torch.pipeline.ensemble import ensemble_retrieval_step

    return drive(name, lambda b: ensemble_retrieval_step(
        idx, *b, k=TOP_K, k_out=TOP_K, p_cap=P_CAP, sparse_presorted=True, **kw),
        batches, smi, expect, idx.corpus_rows.shape[0])


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
    q5, _ = DK.quantize_rows(qf)          # what dense_topk_int8 gives K1 on the flagship
    args = (q5, rows_i8, d_scale)
    got = DK.group_max_packed_int8(*args)
    ref = DK.group_max_packed_int8_plain(*args, n)
    if not torch.equal(got.view(torch.int32), ref.view(torch.int32)):
        raise AssertionError("K1 group_max_packed_int8 at the flagship's rows != plain "
                             "(int32 bit patterns)")
    k1["max_abs_err"] = max(k1["max_abs_err"], float((got - ref).abs().max()))
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
    res = {}

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
    timed("group_max_scores", lambda: DK.group_max_scores(qb, rows_bf16, stride=4),
          lambda: DK.group_max_scores_plain(qb, rows_bf16, n, 4), err, qb,
          8 * qb.shape[0] * (-(-n // 2048) * 2048 // 512),
          ms_stride1=median_ms(lambda: DK.group_max_scores(qb, rows_bf16), 5))

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
    return res, cmax


def run_flagship(name, step, corpus, batches, view_proj, smi, expect, rounds=ROUNDS, **kw):
    """A flagship step over the batches (drive)."""
    return drive(name, lambda b: step(b[0], view_proj, corpus, b[1], k=TOP_K, k_out=TOP_K, **kw),
                 batches, smi, expect, corpus.shape[0], rounds)


def profile_steps(name, fn, steps=None):
    """Device time of `steps` calls of fn under torch.profiler: the busy
    share of the window (union of the kernels' intervals over the window
    from the first event to the last), and the five kernels that took most
    of the device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    steps = steps or PROFILE_STEPS
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    events = list(prof.events())
    kern = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                  if e.device_type == DeviceType.CUDA)
    if not kern:
        raise AssertionError(f"profile of {name}: no device events")
    t0 = min(e.time_range.start for e in events)
    t1 = max(e.time_range.end for e in events)
    busy, end = 0.0, t0
    by_name = {}
    for a, b, n in kern:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
        by_name[n] = by_name.get(n, 0.0) + (b - a)
    total = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda x: -x[1])[:5]
    log(f"  {name}: device busy {busy / 1e3:.3f} ms of a {(t1 - t0) / 1e3:.3f} ms window over "
        f"{steps} steps (idle share {1 - busy / (t1 - t0):.3f}); kernel time {total / 1e3:.3f} ms")
    for n, us in top:
        log(f"    {us / 1e3 / steps:8.3f} ms/step  {us / total * 100:5.1f} %  {n[:90]}")


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
    g = DK.dense_topk_int8(qv, rows_i8, scale, k=TOP_K)
    c = DK.dense_topk_int8(qv.cpu(), c_i8, c_sc, k=TOP_K)
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
    bitonic_ptxas = ptxas_summary(build_log)
    log("    ptxas, bitonic kernels (registers, spill stores / loads, stack bytes): " + "; ".join(
        f"{k} [{v['source']}] {v.get('registers')} regs, {v.get('spill_stores')} / "
        f"{v.get('spill_loads')} spill, {v.get('stack')} stack"
        for k, v in bitonic_ptxas.items()))

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
    from qpp_fusion_rag_tpu_torch.data.synthetic import zipf_queries
    long_q = [torch.as_tensor(x, device=dev) for x in zipf_queries(
        h["splade_csr_offsets"], BATCH, n_terms=LONG_TQ, seed=8)]
    del h

    log("[4] kernels vs plain versions on the card, main-path shapes")
    res = kernels_vs_plain(idx_rs, batches[0], imp_bits)

    q8_kernels = ("group_max_packed_int8", "bitonic_segsum_rows", "gather_windows")
    log(f"[5] q8 path: ensemble_retrieval_step (q8, presorted), {ROUNDS} passes over "
        f"{len(batches)} batches of {BATCH} queries, {N_DOCS} docs")
    q8_launches, q8_ms = run_path("q8", idx, batches, smi, q8_kernels, sparse_mode="q8")

    q8r_kernels = q8_kernels + ("bitonic_topp_rows", "rescore_match")
    log(f"[6] q8r path: ensemble_retrieval_step (q8r, {Q8R_CANDIDATES} candidates, dense "
        f"pool {DENSE_POOL}, bf16 rerank rows, doc_imp_bits {imp_bits}), {ROUNDS} passes over "
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
            ("q8", ("bitonic_segsum_rows",), lambda: S.sparse_score_topk_q8(
                *splade_rs[:3], lt, lw, k=TOP_K, p_cap=P_CAP, presorted=True)),
            ("q8r", ("bitonic_segsum_rows", "bitonic_topp_rows", "rescore_match"),
             lambda: S.sparse_score_topk_q8_rescored(*splade_rs, lt, lw, **rs_kw))):
        LAUNCHES.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        long_out[mode] = call()
        torch.cuda.synchronize()
        long_ms[mode] = (time.perf_counter() - t0) * 1e3
        long_launches[mode] = dict(LAUNCHES)
        log(f"  {mode}: {long_ms[mode]:.1f} ms; launches {long_launches[mode]}")
        missing = [k for k in expect if long_launches[mode].get(k, 0) < 1]
        if missing:
            raise AssertionError(f"the long-row {mode} call never launched {missing}")
        if int((long_out[mode][1] >= 0).sum()) == 0:
            raise AssertionError(f"the long-row {mode} call found no documents")
    packed, offsets, scales = view_args(idx_rs, "splade")
    long_keys, _, long_sb = S._q8_keys(packed, offsets, scales, lt, lw, P_CAP, presorted=True)
    long_sums, _, _ = S._q8_row_sums(packed, offsets, scales, lt, lw, P_CAP, presorted=True)
    long_row_kernels(res, long_keys, long_sb, S._pool_keys(long_sums), LONG_TQ)
    del long_keys, long_sums

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
    log(f"  q8 views (SPLADE at Tq {LONG_TQ} too) and dense view equal; q8r views (SPLADE "
        f"at Tq {LONG_TQ} too), the K5 fallback and the rescored dense view within rtol "
        f"{RTOL} (ids up to near-tie swaps)")
    log("  cross-check ok")

    phase_s["[1-8] ensemble paths and cross-check"] = time.perf_counter() - t_all

    from qpp_fusion_rag_tpu_torch.ops.kernels import streaming_topk
    from qpp_fusion_rag_tpu_torch.pipeline.engine import (
        fused_retrieval_step,
        learned_fused_retrieval_step,
    )
    from qpp_fusion_rag_tpu_torch.pipeline.ensemble import ensemble_retrieval_step
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
    log(f"[10] dense flagship: fused_retrieval_step, {VIEWS_R} views, {ROUNDS} passes over "
        f"{len(batches)} batches of {BATCH} queries, {N_DOCS} docs, on each route")
    flag_launches, flag_ms = {}, {}
    for name, corpus, kernel, kw in (
            ("flagship_int8", idx.corpus_rows, "group_max_packed_int8",
             dict(corpus_scale=idx.d_scale)),
            ("flagship_bf16", rows_bf16, "group_max_packed", dict(use_pallas=True))):
        flag_launches[name], flag_ms[name] = run_flagship(
            name, fused_retrieval_step, corpus, fbatches, view_proj, smi, (kernel,), **kw)
    params = mlp_params_from_numpy(mlp, dev)
    flag_launches["flagship_learned"], flag_ms["flagship_learned"] = run_flagship(
        "flagship_learned", lambda *a, **kw: learned_fused_retrieval_step(params, *a, **kw),
        rows_bf16, fbatches[:1], view_proj, smi, ("group_max_packed",), use_pallas=True)
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
    log(f"[11b] device time: torch.profiler over {PROFILE_STEPS} steps of each main path")
    for name, fn in (
            ("q8", lambda: ensemble_retrieval_step(
                idx, *batches[1], k=TOP_K, k_out=TOP_K, p_cap=P_CAP, sparse_presorted=True,
                sparse_mode="q8")),
            ("q8r", lambda: ensemble_retrieval_step(
                idx_rs, *batches[1], k=TOP_K, k_out=TOP_K, p_cap=P_CAP, sparse_presorted=True,
                sparse_mode="q8r", sparse_candidates=Q8R_CANDIDATES,
                dense_rescore_pool=DENSE_POOL, doc_imp_bits=imp_bits)),
            ("flagship_int8", lambda: fused_retrieval_step(
                *fbatches[1][:1], view_proj, idx.corpus_rows, fbatches[1][1], k=TOP_K,
                k_out=TOP_K, corpus_scale=idx.d_scale)),
            ("flagship_bf16", lambda: fused_retrieval_step(
                *fbatches[1][:1], view_proj, rows_bf16, fbatches[1][1], k=TOP_K, k_out=TOP_K,
                use_pallas=True))):
        profile_steps(name, fn)
    phase_s["[11b] profile"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    log(f"[12] flagship cross-check of {CROSS_Q} queries on CPU copies")
    flagship_cross_check(rows_bf16, idx.corpus_rows, idx.d_scale, fbatches[0], view_proj, cmax)
    log("  cross-check ok")
    phase_s["[12] flagship cross-check"] = time.perf_counter() - t0

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
            "streaming_group_max": (src + "streaming_group_max.cu", tpu + "streaming_topk.py:91",
                                    "streaming")}
    paths = {"q8": q8_launches, "q8r": q8r_launches, "q8r_fallback": fb_launches,
             "splade_q8_tq32": long_launches["q8"], "splade_q8r_tq32": long_launches["q8r"],
             **flag_launches, **entry}
    kernels = []
    for name, (source, replaces, main_path) in meta.items():
        ptxas = {k: v for k, v in bitonic_ptxas.items() if source.endswith(v["source"])}
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": paths[main_path].get(name, 0),
                        "path": main_path,
                        "launches_by_path": {p: c.get(name, 0) for p, c in paths.items()},
                        **res[name], **({"ptxas": ptxas} if ptxas else {})})
    for name, sec in phase_s.items():
        log(f"  {name}: {sec:.1f} s")
    steady = {"q8": q8_ms, "q8r": q8r_ms, **flag_ms}
    steady = {k: round(statistics.median(v[1:] or v), 3) for k, v in steady.items()}
    log(f"  total {time.perf_counter() - t_all:.1f} s; steady median step ms {steady}; "
        f"fallback call {fb_ms:.1f} ms; SPLADE Tq {LONG_TQ} calls ms {long_ms}; host build "
        f"{host_s:.1f} s; kernel build {build_s:.1f} s; {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
