"""The HotpotQA ensemble cell (hotpotqa-ensemble.q8-longq-b1024): its files
and declaration, the derived sizes of its configuration against the
formulas its `assumed` lines state, the plain reference's q8 keys at
5,233,329 docs and 32 query terms, and a tiny HotpotQA-shaped cell (the
ensemble kind at 16 / 32 query terms) end to end through run.run_cell with
the program's plain kernel versions: correct, and failed by the control.
The tier-1 suite collects these tests too (tests/test_bench_hotpotqa.py)."""

from __future__ import annotations

import json
import math
import shutil
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import benchmark_torch.control as CONTROL  # noqa: E402
import benchmark_torch.run as RUN  # noqa: E402
from benchmark_torch.harness.bench import Bench  # noqa: E402
from benchmark_torch.reference import ensemble as REF  # noqa: E402

CPU = torch.device("cpu")
CELL = "hotpotqa-ensemble.q8-longq-b1024"
DOCS = 5_233_329              # BEIR HotpotQA's passages (arXiv:2104.08663, Table 1)
WORDS, QUERY_WORDS = 46.30, 17.61
NQ_WORDS, NQ_QUERY_WORDS, NQ_DOCS = 78.88, 9.16, 2_681_468
TOKENS_PER_WORD = 143.8956 / 213.63   # SciFact: Terrier tokens a doc / BEIR words a doc
HEAPS_K = 25_508 / (5_183 * 143.8956) ** 0.49   # SciFact's 25,508 terms, b 0.49
PER_LAYER = {"kernels_per_step", "sparse_views_ms", "dense_view_ms", "qpp_fusion_ms",
             "k1_roofline", "k2_roofline", "merge_roofline", "device_idle_share",
             "host_syncs_per_step", "host_blocked_ms", "qpp_fusion_idle_ms"}

TINY_CONFIG = {
    "kind": "ensemble", "source": "a CPU-sized copy of hotpotqa-ensemble",
    "docs": 6000, "dim": 64,
    "bm25": {"vocab": 3000, "zipf_a": 0.9874, "lognormal_sigma": 0.3957, "avg_doc_len": 20.0,
             "k1": 0.9, "b": 0.4},
    "splade": {"vocab": 1500, "zipf_a": 0.675, "lognormal_sigma": 0.3957, "avg_doc_len": 40.0,
               "k1": 0.9, "b": 0.4},
    "p_cap": 64, "presorted": True, "k": 20, "k_out": 20, "qpp_index": 5,
    "rerank_proj_scale": 0.05, "text_feats": [6, 6, 9, 5]}
TINY_TRAFFIC = {"mode": "q8", "batch": 24, "bm25_terms": 16, "splade_terms": 32, "pool": 2,
                "skip_top": 30, "min_df": 5}
TINY = "tiny-hotpotqa.q8-longq-tiny"
SEED = 2**31 + 23


def _dump(path: Path, obj) -> None:
    path.write_text(json.dumps(obj, indent=1))


@pytest.fixture(scope="module")
def hotpot_root(tmp_path_factory) -> Path:
    """BENCHMARK.json and benchmark_torch/ copied under a root of its own,
    with the tiny HotpotQA-shaped cell added as new files and a workload
    (limits and metric lists those of the full-size cell)."""
    base = tmp_path_factory.mktemp("bench_hotpotqa")
    bench = base / "benchmark_torch"
    shutil.copytree(ROOT / "benchmark_torch", bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    _dump(bench / "configs" / "tiny-hotpotqa.json", TINY_CONFIG)
    _dump(bench / "traffic" / "q8-longq-tiny.json", TINY_TRAFFIC)
    spec["workloads"].append({"name": TINY, "config": "tiny-hotpotqa",
                              "traffic": "q8-longq-tiny", "chips": 1, "why": "CPU-sized"})
    shutil.copy(bench / "limits" / f"{CELL}.json", bench / "limits" / f"{TINY}.json")
    for m in spec["per_layer"]:
        if CELL in m.get("workloads", ()):
            m["workloads"].append(TINY)
    _dump(base / "BENCHMARK.json", spec)
    return base


def test_cell_is_declared_with_its_files():
    """The cell resolves to its configuration, traffic and limits; nothing is
    cut (reduced is [] in the file and in BENCHMARK.json); every size not
    derived from HotpotQA is nq-ensemble's; the traffic is q8-b1024's at
    16 / 32 terms; the cell reports the eleven per-layer metrics of its
    layers, and the limits are the q8 cell's."""
    bench = Bench(ROOT)
    cell = bench.cell(CELL)
    cfg, nq = cell["config"], bench.config("nq-ensemble")
    assert cell["kind"] == "ensemble" and cell["workload"]["chips"] == 1
    entry = next(c for c in bench.spec["configs"] if c["name"] == "hotpotqa-ensemble")
    assert entry["file"] == "benchmark_torch/configs/hotpotqa-ensemble.json"
    assert cfg["reduced"] == entry["reduced"] == []
    assert cfg["docs"] == cfg["published_docs"] == DOCS
    own = ("source", "deployment", "docs", "published_docs", "reduced", "assumed", "bm25")
    assert {k: v for k, v in cfg.items() if k not in own} == {
        k: v for k, v in nq.items() if k not in own}
    assert cfg["splade"] == nq["splade"]
    derived = ("avg_doc_len", "vocab")
    assert {k: v for k, v in cfg["bm25"].items() if k not in derived} == {
        k: v for k, v in nq["bm25"].items() if k not in derived}
    tr = dict(cell["traffic"])
    assert tr.pop("assumed")
    assert tr == dict(bench.traffic("q8-b1024"), bm25_terms=16, splade_terms=32)
    assert {m["name"] for m in bench.metrics_of(CELL, "per_layer")} == PER_LAYER
    assert cell["limits"] == bench.limits("nq-ensemble.q8-b1024")
    assert len([w for w in bench.spec["workloads"] if w["config"] == "hotpotqa-ensemble"]) == 1


def test_derived_sizes_equal_their_formulas():
    """avg_doc_len and vocab as the `assumed` lines derive them, to the
    digits printed: HotpotQA's words a passage times SciFact's Terrier
    tokens per word, and Heaps' law with nq-ensemble's fit (which gives
    NQ's 334,513 the same way); the query terms are NQ's scaled by the
    ratio of query lengths, rounded up to a power of two."""
    bench = Bench(ROOT)
    cfg, nq = bench.config("hotpotqa-ensemble"), bench.config("nq-ensemble")
    tokens = WORDS * TOKENS_PER_WORD
    assert cfg["bm25"]["avg_doc_len"] == round(tokens, 2) == 31.19
    assert cfg["bm25"]["vocab"] == round(HEAPS_K * (DOCS * tokens) ** 0.49) == 357_547
    assert nq["bm25"]["avg_doc_len"] == round(NQ_WORDS * TOKENS_PER_WORD, 2)
    assert nq["bm25"]["vocab"] == round(HEAPS_K * (NQ_DOCS * NQ_WORDS * TOKENS_PER_WORD)
                                        ** 0.49)
    text = " ".join(cfg["assumed"])
    for printed in ("46.30", "143.8956 / 213.63", "31.1865", "357,547", "25,508", "0.49",
                    "5,233,329"):
        assert printed in text
    tr, nq_tr = bench.traffic("q8-longq-b1024"), bench.traffic("q8-b1024")
    scale = QUERY_WORDS / NQ_QUERY_WORDS
    for key in ("bm25_terms", "splade_terms"):
        assert tr[key] == 2 ** math.ceil(math.log2(nq_tr[key] * scale))
    assert "17.61 / 9.16" in " ".join(tr["assumed"])


def test_reference_keys_hold_hotpotqa_ids_and_sums():
    """The reference's q8 key, sum << 23 | (2^23 - 1 - doc), at the cell's
    extremes: every doc id fits its 23-bit field and 32 terms x 255 fit
    above it in an int64. Over 5,233,329 docs, 32 query terms whose every
    posting quantizes to 255: the last doc sits in every list, the doc
    2^22 in 31, and one further doc a list from 2^22 + 1 on; the top 10
    come back by sum, ties lowest id first, with their exact sums."""
    assert DOCS - 1 <= REF.DOC_MASK
    assert ((32 * 255) << REF.SUM_SHIFT | REF.DOC_MASK) < 2**63
    tq = 32
    lists = [[DOCS - 1] + ([1 << 22] if t < tq - 1 else []) + [(1 << 22) + 1 + t]
             for t in range(tq)]
    counts = torch.tensor([len(x) for x in lists])
    csr = {"offsets": torch.cat([torch.zeros(1, dtype=torch.int64), counts.cumsum(0)]),
           "docs": torch.tensor([d for x in lists for d in x], dtype=torch.int32),
           "weights": torch.ones(int(counts.sum()), dtype=torch.float32)}
    terms = torch.arange(tq, dtype=torch.int32).repeat(2, 1)
    grid = REF.term_grid(csr)
    assert bool((grid[1] == 255).all())
    scores, ids = REF.sparse_view(csr, grid, terms, torch.ones(2, tq), DOCS, 10, torch.float32)
    want = [DOCS - 1, 1 << 22] + [(1 << 22) + 1 + t for t in range(8)]
    sums = [tq * 255, (tq - 1) * 255] + [255] * 8
    assert ids.tolist() == [want, want]
    step = grid[0][0]
    assert torch.equal(scores, (torch.tensor(sums, dtype=torch.float32) * step).repeat(2, 1))


def _run(root, trace=False, seed=SEED):
    """One whole run of the tiny cell; its window of 2 s samples every pool
    batch even on a loaded CPU."""
    bench = Bench(root)
    return RUN.run_cell(bench, bench.cell(TINY), seed, 2.0, trace, CPU, time.perf_counter())


@pytest.mark.parametrize("trace", [False, True])
def test_tiny_hotpotqa_run_is_correct(hotpot_root, trace):
    r = _run(hotpot_root, trace=trace)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert all(v["value"] <= v["limit"] for v in r["check"].values())
    if not trace:
        assert set(r["metrics"]) == {"qps", "batch_p95_ms", "setup_s"}
    else:
        assert r["metrics"] == {}                  # no device events on the CPU


def test_control_fails_the_check(hotpot_root):
    bench = Bench(hotpot_root)
    for seed in (23, 24):
        r = CONTROL.readings(bench, bench.cell(TINY), seed, CPU)
        assert r["program_correct"] is True
        assert r["control_correct"] is False
