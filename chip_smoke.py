#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (qpp_fusion_rag_tpu_torch) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It builds the port's CUDA kernels from csrc/ (into build/torch_kernels/),
builds the bench-scale synthetic index on the host (2,621,440 docs, BM25 and
SPLADE presorted postings at p_cap 2048, an int8 768-wide dense corpus made
on the card from a seed), holds each kernel against its plain PyTorch
version at the main path's shapes, drives the q8 ensemble step over three
batches of 1024 queries, checks that every kernel of the path launched,
and cross-checks the kernel-bearing views against the plain versions on
CPU copies. Every phase raises on failure. The line before the last is a
JSON summary of the kernels; the last line is

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
QUERY_SEEDS = ((1, 2), (3, 4), (5, 6))
CROSS_Q = 8
CORPUS_CHUNK = 262_144


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
    """Bench-scale synthetic BM25 + SPLADE indexes in the presorted layout
    (the parameters of the JAX package's bench)."""
    from qpp_fusion_rag_tpu_torch.data import synthetic as S
    from qpp_fusion_rag_tpu_torch.ops.sparse import (
        pack_postings_presorted,
        term_scales_from_csr,
    )

    out = {}
    for name, vocab, avg_len, seed, zipf_a, max_post in (
            ("bm25", 100_000, 30.0, 0, S.CALIBRATED_ZIPF_A_BM25, 80_000_000),
            ("splade", 30_000, 40.0, 7, S.CALIBRATED_ZIPF_A_SPLADE, 60_000_000)):
        off, docs, w, _ = S.zipf_bm25_csr(
            n_docs, vocab_size=vocab, avg_doc_len=avg_len, seed=seed, zipf_a=zipf_a,
            lognormal_sigma=S.CALIBRATED_LOGNORMAL_SIGMA, max_postings=max_post)
        scales = term_scales_from_csr(w, off)
        packed, off2, _ = pack_postings_presorted(docs, w, off, cap=P_CAP, scales=scales)
        log(f"  {name}: {len(docs)} postings -> {len(packed)} packed")
        out.update({f"{name}_packed": packed, f"{name}_scales": scales,
                    f"{name}_offsets": off2, f"{name}_csr_offsets": off})
    return out


def dense_corpus(n_docs: int, dev):
    """int8 [N, D] rows + per-doc scales from a seeded generator on the card."""
    from qpp_fusion_rag_tpu_torch.ops.kernels.dense_topk import quantize_rows

    gen = torch.Generator(device=dev).manual_seed(0)
    rows = torch.empty((n_docs, DIM), dtype=torch.int8, device=dev)
    scale = torch.empty(n_docs, dtype=torch.float32, device=dev)
    for n0 in range(0, n_docs, CORPUS_CHUNK):
        n1 = min(n_docs, n0 + CORPUS_CHUNK)
        q, s = quantize_rows(torch.randn((n1 - n0, DIM), generator=gen, device=dev))
        rows[n0:n1] = q
        scale[n0:n1] = s[:, 0]
    return rows, scale


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


def kernels_vs_plain(idx, batch):
    """Each kernel against its plain version on the card, at the shapes the
    main path gives it (batch 0's real windows and keys). -> per-kernel
    {max_abs_err, ms, plain_ms}, both shapes summed per step."""
    from qpp_fusion_rag_tpu_torch.ops import sparse as S
    from qpp_fusion_rag_tpu_torch.ops.kernels import bitonic, dense_topk, window_gather

    bt, bq, st, sq, q_emb, _, _ = batch
    res = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0}
           for k in ("group_max_packed_int8", "bitonic_segsum_rows", "gather_windows")}
    for view, terms, qw in (("bm25", bt, bq), ("splade", st, sq)):
        packed = getattr(idx, f"{view}_packed")
        offsets = getattr(idx, f"{view}_offsets")
        starts = S.q8_windows(offsets, terms, P_CAP, packed.shape[0],
                              presorted=True)[0].reshape(-1).contiguous()
        got = window_gather.gather_windows(packed, starts, P_CAP)
        ref = window_gather.gather_windows_plain(packed, starts, P_CAP)
        if not torch.equal(got, ref):
            raise AssertionError(f"K3 gather_windows != plain ({view}, G={starts.numel()})")
        r = res["gather_windows"]
        r["ms"] += median_ms(lambda: window_gather.gather_windows(packed, starts, P_CAP), 10)
        r["plain_ms"] += median_ms(
            lambda: window_gather.gather_windows_plain(packed, starts, P_CAP), 10)
        log(f"  K3 gather_windows {view} [G={starts.numel()}, cap={P_CAP}]: equal")

        keys, _, start_block = S._q8_keys(packed, offsets, getattr(idx, f"{view}_scales"),
                                          terms, qw, P_CAP, presorted=True)
        tq = terms.shape[1]
        sums, sids = bitonic.bitonic_segsum_rows(keys, start_block=start_block, max_run=tq)
        r_sums, r_sids = bitonic.bitonic_segsum_rows_plain(keys)
        real = r_sids < S.SID_INVALID
        if not torch.equal(sids, r_sids) or not torch.equal(sums[real], r_sums[real]):
            raise AssertionError(f"K2 bitonic_segsum_rows != plain ({view}, {tuple(keys.shape)})")
        r = res["bitonic_segsum_rows"]
        r["max_abs_err"] = max(r["max_abs_err"],
                               float((sums - r_sums)[real].abs().max()),
                               float((sids - r_sids).abs().max()))
        r["ms"] += median_ms(lambda: bitonic.bitonic_segsum_rows(
            keys, start_block=start_block, max_run=tq), 10)
        r["plain_ms"] += median_ms(lambda: bitonic.bitonic_segsum_rows_plain(keys), 10)
        log(f"  K2 bitonic_segsum_rows {view} {tuple(keys.shape)} start_block="
            f"{start_block} max_run={tq}: sids equal, sums equal on real positions "
            f"({int(real.sum())} of {real.numel()}; pads equal too: "
            f"{torch.equal(sums, r_sums)})")

    q_int, _ = dense_topk.quantize_rows(q_emb)
    args = (q_int, idx.corpus_rows, idx.d_scale)
    got = dense_topk.group_max_packed_int8(*args)
    ref = dense_topk.group_max_packed_int8_plain(*args, idx.corpus_rows.shape[0])
    if not torch.equal(got.view(torch.int32), ref.view(torch.int32)):
        raise AssertionError("K1 group_max_packed_int8 != plain (int32 bit patterns)")
    r = res["group_max_packed_int8"]
    r["max_abs_err"] = float((got - ref).abs().max())
    r["ms"] = median_ms(lambda: dense_topk.group_max_packed_int8(*args), 5)
    r["plain_ms"] = median_ms(lambda: dense_topk.group_max_packed_int8_plain(
        *args, idx.corpus_rows.shape[0]), 3)
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


def main() -> None:
    if not (ROOT / "qpp_fusion_rag_tpu_torch" / "__init__.py").is_file():
        raise SystemExit("chip_smoke.py: no qpp_fusion_rag_tpu_torch package beside "
                         "this script; run it from the root of a checkout")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch.cuda.is_available() is False; "
                         "this check runs only on an NVIDIA GPU")
    sys.path.insert(0, str(ROOT))
    from qpp_fusion_rag_tpu_torch.ops.kernels import _build, bitonic, dense_topk, window_gather
    from qpp_fusion_rag_tpu_torch.ops.sparse import sparse_score_topk_q8
    from qpp_fusion_rag_tpu_torch.pipeline.ensemble import ensemble_retrieval_step
    from qpp_fusion_rag_tpu_torch.pipeline.interop import indexes_from_numpy

    t_all = time.perf_counter()
    dev = torch.device("cuda")
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
    log(f"[2] kernels built in {build_s:.1f} s -> {path.relative_to(ROOT)}")
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"    ptxas: {line.strip()}")

    t0 = time.perf_counter()
    h = host_build(N_DOCS)
    host_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows, scale = dense_corpus(N_DOCS, dev)
    idx = indexes_from_numpy({k: v for k, v in h.items() if "csr" not in k}
                             | {"corpus_rows": rows, "d_scale": scale}, dev)
    torch.cuda.synchronize()
    log(f"[3] host build {host_s:.1f} s (n_docs {N_DOCS}, no cut); dense corpus "
        f"{tuple(rows.shape)} int8 + index upload {time.perf_counter() - t0:.1f} s")
    batches = make_batches(h, dev)

    log("[4] kernels vs plain versions on the card, main-path shapes")
    res = kernels_vs_plain(idx, batches[0])

    log(f"[5] main path: ensemble_retrieval_step (q8, presorted) over "
        f"{len(batches)} batches of {BATCH} queries, {N_DOCS} docs")
    modules = {"group_max_packed_int8": dense_topk, "bitonic_segsum_rows": bitonic,
               "gather_windows": window_gather}
    for m in modules.values():
        m.LAUNCHES = 0
    outs, step_ms = [], []
    for i, batch in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = ensemble_retrieval_step(idx, *batch, k=TOP_K, k_out=TOP_K, p_cap=P_CAP,
                                      sparse_mode="q8", sparse_presorted=True)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        outs.append(out)
        log(f"  batch {i}: {step_ms[-1]:.1f} ms -> {BATCH / step_ms[-1] * 1e3:.0f} q/s "
            f"({smi})")
    launches = {name: m.LAUNCHES for name, m in modules.items()}
    log(f"  launches during the main path: {launches}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    for out in outs:
        check_step_output(out, N_DOCS)
    log("  outputs: shapes, finite QPP, non-increasing fused scores, unique ids < N: ok")

    log(f"[6] cross-check of the kernel views for {CROSS_Q} queries on CPU copies")
    cpu_idx = indexes_from_numpy({k: getattr(idx, k).cpu() for k in idx._fields}, "cpu")
    bt, bq, st, sq, q_emb, _, _ = batches[0]
    for view, terms, qw in (("bm25", bt, bq), ("splade", st, sq)):
        g_s, g_i = sparse_score_topk_q8(
            *(getattr(idx, f"{view}_{f}") for f in ("packed", "offsets", "scales")),
            terms, qw, k=TOP_K, p_cap=P_CAP, presorted=True)
        c_s, c_i = sparse_score_topk_q8(
            *(getattr(cpu_idx, f"{view}_{f}") for f in ("packed", "offsets", "scales")),
            terms[:CROSS_Q].cpu(), qw[:CROSS_Q].cpu(), k=TOP_K, p_cap=P_CAP, presorted=True)
        if not (torch.equal(g_i[:CROSS_Q].cpu(), c_i) and torch.equal(g_s[:CROSS_Q].cpu(), c_s)):
            raise AssertionError(f"{view} view: card and CPU disagree")
    g_s, g_i = dense_topk.dense_topk_int8(q_emb, idx.corpus_rows, idx.d_scale, k=TOP_K)
    c_s, c_i = dense_topk.dense_topk_int8(q_emb[:CROSS_Q].cpu(), cpu_idx.corpus_rows,
                                          cpu_idx.d_scale, k=TOP_K)
    if not (torch.equal(g_i[:CROSS_Q].cpu(), c_i) and torch.equal(g_s[:CROSS_Q].cpu(), c_s)):
        raise AssertionError("dense view: card and CPU disagree")
    log("  cross-check ok")

    src = "qpp_fusion_rag_tpu_torch/csrc/"
    tpu = "qpp_fusion_rag_tpu/ops/pallas/"
    meta = {"group_max_packed_int8": (src + "dense_topk_int8.cu", tpu + "dense_topk.py:184"),
            "bitonic_segsum_rows": (src + "bitonic_segsum.cu", tpu + "bitonic.py:275"),
            "gather_windows": (src + "window_gather.cu", tpu + "window_gather.py:101")}
    kernels = [{"name": name, "route": "cuda", "source": meta[name][0],
                "replaces": meta[name][1], "launches": launches[name],
                "max_abs_err": res[name]["max_abs_err"], "ms": res[name]["ms"],
                "plain_ms": res[name]["plain_ms"]} for name in modules]
    log(f"  total {time.perf_counter() - t_all:.1f} s; step ms {step_ms}; host build "
        f"{host_s:.1f} s; kernel build {build_s:.1f} s; {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
