"""The rank-safe ensemble cell (nq-ensemble-rs.q8r-b1024) at a size the CPU
holds: a root of its own with the benchmark copied and a tiny rank-safe
cell added as new files and a new workload; the whole run through
run.run_cell with the program's plain kernel versions, the control, a
broken answer and a reference pool that breaks edge ties the wrong way on
inputs built to tie there; and the cell's three metric readers on
synthetic trace summaries."""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

import pytest
import torch

import benchmark_torch.control as CONTROL
import benchmark_torch.run as RUN
from benchmark_torch.harness.bench import Bench

ROOT = Path(__file__).resolve().parents[2]
CPU = torch.device("cpu")
CELL = "nq-ensemble-rs.q8r-b1024"
TINY_CONFIG = {
    "kind": "ensemble_rs", "source": "a CPU-sized copy of nq-ensemble-rs",
    "docs": 6000, "dim": 64,
    "bm25": {"vocab": 3000, "zipf_a": 0.9874, "lognormal_sigma": 0.3957, "avg_doc_len": 30.0,
             "k1": 0.9, "b": 0.4},
    "splade": {"vocab": 1500, "zipf_a": 0.675, "lognormal_sigma": 0.3957, "avg_doc_len": 40.0,
               "k1": 0.9, "b": 0.4},
    "p_cap": 64, "presorted": True, "k": 20, "k_out": 20, "qpp_index": 5,
    "rerank_proj_scale": 0.05, "text_feats": [6, 6, 9, 5], "doc_cap": 16, "imp_bits": 12}
TINY_TRAFFIC = {
    # the cell's mix at a CPU's size
    "q8r-tiny": {"mode": "q8r", "batch": 24, "bm25_terms": 8, "splade_terms": 16,
                 "sparse_candidates": 48, "dense_rescore_pool": 32, "pool": 2,
                 "skip_top": 30, "min_df": 5},
    # two terms a query: q8 sums tie in runs of many docs, so the pool's
    # edge falls inside a tie
    "q8r-ties": {"mode": "q8r", "batch": 24, "bm25_terms": 2, "splade_terms": 2,
                 "sparse_candidates": 20, "dense_rescore_pool": 32, "pool": 2,
                 "skip_top": 30, "min_df": 5},
}
TINY = "tiny-ensemble-rs.q8r-tiny"
TIES = "tiny-ensemble-rs.q8r-ties"


def _dump(path: Path, obj) -> None:
    path.write_text(json.dumps(obj, indent=1))


def _root(base: Path) -> Path:
    """BENCHMARK.json and benchmark_torch/ copied under base, with the tiny
    rank-safe cells added as new files and workloads (limits and metric
    lists those of the full-size cell)."""
    bench = base / "benchmark_torch"
    shutil.copytree(ROOT / "benchmark_torch", bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    _dump(bench / "configs" / "tiny-ensemble-rs.json", TINY_CONFIG)
    for name, tr in TINY_TRAFFIC.items():
        _dump(bench / "traffic" / f"{name}.json", tr)
        cell = f"tiny-ensemble-rs.{name}"
        spec["workloads"].append({"name": cell, "config": "tiny-ensemble-rs", "traffic": name,
                                  "chips": 1, "why": "CPU-sized"})
        shutil.copy(bench / "limits" / f"{CELL}.json", bench / "limits" / f"{cell}.json")
        for m in spec["per_layer"]:
            if CELL in m.get("workloads", ()):
                m["workloads"].append(cell)
    _dump(base / "BENCHMARK.json", spec)
    return base


@pytest.fixture(scope="module")
def rs_root(tmp_path_factory) -> Path:
    return _root(tmp_path_factory.mktemp("bench_rs"))


def _run(root, cell=TINY, trace=False, seed=2**31 + 7):
    """One whole run; its window of 2 s samples every pool batch even on a
    loaded CPU (a window of one batch would leave a batch unchecked)."""
    bench = Bench(root)
    return RUN.run_cell(bench, bench.cell(cell), seed, 2.0, trace, CPU, time.perf_counter())


def test_cell_is_declared_with_its_files():
    bench = Bench(ROOT)
    cell = bench.cell(CELL)
    assert cell["kind"] == "ensemble_rs" and cell["workload"]["chips"] == 1
    assert cell["config"]["reduced"] == ["docs"]
    assert [m["name"] for m in bench.metrics_of(CELL, "per_layer")] == [
        "kernels_per_step", "sparse_views_ms", "dense_view_ms", "qpp_fusion_ms", "k1_roofline",
        "k2_roofline", "device_idle_share", "host_syncs_per_step", "host_blocked_ms",
        "qpp_fusion_idle_ms", "rescore_ms", "k4_roofline", "k6_roofline"]
    names = [e["name"] for e in bench.spans("ensemble_rs")["spans"]]
    assert names[:6] == [e["name"] for e in bench.spans("ensemble")["spans"]]
    assert names[6:] == ["sparse_rescore", "dense_rescore"]


@pytest.mark.parametrize("trace", [False, True])
def test_tiny_rank_safe_run_is_correct(rs_root, trace):
    r = _run(rs_root, trace=trace)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert all(v["value"] <= v["limit"] for v in r["check"].values())
    if not trace:
        assert set(r["metrics"]) == {"qps", "batch_p95_ms", "setup_s"}
    else:
        assert r["metrics"] == {}                  # no device events on the CPU


def test_control_fails_the_check(rs_root):
    bench = Bench(rs_root)
    for seed in (11, 12):
        r = CONTROL.readings(bench, bench.cell(TINY), seed, CPU)
        assert r["program_correct"] is True
        assert r["control_correct"] is False


@pytest.mark.parametrize("fault", ["altered_id", "one_qpp_column"])
def test_a_broken_answer_is_not_correct(rs_root, monkeypatch, fault):
    """Fusion hands back one query's best doc replaced by another, or the
    step hands back WIG (not snqc) 0.1 off for every query."""
    if fault == "altered_id":
        from qpp_fusion_rag_tpu_torch.ops import fusion as F

        orig = F.fuse_kernel

        def altered(*a, **kw):
            ids, scores = orig(*a, **kw)
            ids = ids.clone()
            ids[0, 0] = ids[0, 0] + 1
            return ids, scores
        monkeypatch.setattr(F, "fuse_kernel", altered)
    else:
        from qpp_fusion_rag_tpu_torch.pipeline import ensemble as E

        orig = E.ensemble_retrieval_step

        def shifted(*a, **kw):
            ids, scores, qpp = orig(*a, **kw)[:3]
            qpp = qpp.clone()
            qpp[..., 2] += 0.1
            return ids, scores, qpp
        monkeypatch.setattr(E, "ensemble_retrieval_step", shifted)
    r = _run(rs_root)
    assert r["correct"] is False and r["failed"] > 0


def test_pool_ties_taken_the_other_way_are_not_correct(tmp_path):
    """On the tie-dense mix the program agrees with the reference's pool
    order (tied q8 sums, the higher doc id first), and a reference that
    takes tied sums the lower doc id first disagrees with the program."""
    root = _root(tmp_path)
    assert _run(root, TIES)["correct"] is True
    ref = root / "benchmark_torch" / "reference" / "ensemble_rs.py"
    text = ref.read_text()
    assert "POOL_TIES_HIGH_DOC_FIRST = True" in text
    ref.write_text(text.replace("POOL_TIES_HIGH_DOC_FIRST = True",
                                "POOL_TIES_HIGH_DOC_FIRST = False"))
    r = _run(root, TIES)
    assert r["correct"] is False and r["failed"] > 0


# ------------------------------------------------- the metric readers ------

def _summary(kernels=None, spans=None, steps=4):
    bench = Bench(ROOT)
    return {"steps": steps, "window_s": 1.0, "busy_s": 0.5, "kernel_count": 0,
            "kernels": kernels or {}, "spans": spans or {}, "idle_gaps": {},
            "cell": bench.cell(CELL)}


def test_rescore_ms_reads_both_rescore_spans():
    m = Bench(ROOT).metric("rescore_ms")
    s = _summary(spans={"sparse_rescore": {"device_s": 0.004, "kernels": 8},
                        "dense_rescore": {"device_s": 0.002, "kernels": 4},
                        "rerank": {"device_s": 0.1, "kernels": 4}})
    assert m.read(s) == pytest.approx(1.5)
    assert m.read(_summary(spans={"rerank": {"device_s": 0.1, "kernels": 4}})) is None


@pytest.mark.parametrize("metric,kernel,bound_ms", [
    ("k4_roofline", "void topp_warps_kernel<32>(int const*, int, int, int*)", 0.0626),
    ("k4_roofline", "void bitonic_topp_kernel(int const*, int, int, int, int, int, int*)",
     0.0626),
    ("k6_roofline", "void rescore_match_kernel<16, true, false>(int const*, long long, int)",
     0.0814)])
def test_rooflines_read_their_kernel_against_its_bytes(metric, kernel, bound_ms):
    """Four steps whose kernel took twice its bound a step: 50 %; other
    kernels, and a summary without the kernel, read nothing."""
    m = Bench(ROOT).metric(metric)
    assert m.work_s(Bench(ROOT).cell(CELL)) * 1e3 == pytest.approx(bound_ms, rel=2e-3)
    secs = 4 * 2 * m.work_s(Bench(ROOT).cell(CELL))
    other = {"void bitonic_segsum_kernel<32>()": {"calls": 8, "device_s": 1.0}}
    s = _summary(kernels={kernel: {"calls": 8, "device_s": secs}, **other})
    assert m.read(s) == pytest.approx(50.0)
    assert m.read(_summary(kernels=other)) is None
