"""Cells, configurations, traffic, spans, limits and metrics are found by
name, and a cell added as new files and a new entry needs no edit."""

import json
import shutil

import pytest

from benchmark_torch.harness.bench import Bench

from conftest import ROOT


def test_every_cell_resolves():
    bench = Bench(ROOT)
    for w in bench.spec["workloads"]:
        cell = bench.cell(w["name"])
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        assert cell["kind"] in ("ensemble", "flagship")
        assert set(cell["limits"]) == {"fused_score_gap", "fused_id_gap", "qpp_gap"}
        assert callable(bench.step(cell["kind"]).build)
        assert callable(bench.reference(cell["kind"]).run)
        for e in bench.spans(cell["kind"])["spans"]:
            assert ":" in e["target"]
        names = {m["name"] for m in bench.metrics_of(w["name"], "per_layer")}
        assert {"kernels_per_step", "qpp_fusion_ms", "device_idle_share"} <= names


def test_configs_and_files_of_the_spec():
    bench = Bench(ROOT)
    for c in bench.spec["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
        assert cfg == bench.config(c["name"])


def test_an_added_traffic_file_makes_a_cell(tmp_path):
    root = tmp_path
    shutil.copytree(ROOT / "benchmark_torch", root / "benchmark_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    (root / "benchmark_torch" / "traffic" / "q8-b256.json").write_text(json.dumps(
        {"mode": "q8", "batch": 256, "bm25_terms": 8, "splade_terms": 16, "pool": 4,
         "skip_top": 30, "min_df": 5}))
    (root / "benchmark_torch" / "limits" / "nq-ensemble.q8-b256.json").write_text(
        json.dumps({"fused_score_gap": 1, "fused_id_gap": 1, "qpp_gap": 1}))
    spec["workloads"].append({"name": "nq-ensemble.q8-b256", "config": "nq-ensemble",
                              "traffic": "q8-b256", "chips": 1, "why": "added"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = Bench(root).cell("nq-ensemble.q8-b256")
    assert cell["traffic"]["batch"] == 256 and cell["config"]["docs"] == 2_621_440
    with pytest.raises(LookupError):
        Bench(root).cell("nq-ensemble.q8-b512")
    with pytest.raises(LookupError):
        Bench(root).metric("no_such_metric")


def test_nothing_imports_jax_or_the_jax_package():
    for path in (ROOT / "benchmark_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.replace(",", " ").split()
            if words[:1] in (["import"], ["from"]):
                mods = [w.split(".")[0] for w in words[1:2]]
                assert "jax" not in mods and "qpp_fusion_rag_tpu" not in mods, (path, line)


def test_the_reference_imports_nothing_of_the_program():
    for path in (ROOT / "benchmark_torch" / "reference").glob("*.py"):
        assert "qpp_fusion_rag_tpu" not in path.read_text(), path
