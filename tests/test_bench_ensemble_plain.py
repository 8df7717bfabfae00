"""The benchmark's tests of its plain "sort" ensemble cell
(benchmark_torch/tests/test_ensemble_plain.py), collected here as well: the
port's sort-mode step against the cell's plain reference at a CPU size, the
tiny cell end to end through the harness (sound, under the control, with an
altered id, with a sort engine that sums directly, with picks below the tie
band, without the band), the tie band's readings, and the cell's two metric
readers. The cell's declaration is checked with program_idle_ms, the idle
the program owns, in its set of per-layer metrics."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

pytest.register_assert_rewrite("benchmark_torch.tests.test_ensemble_plain")

from benchmark_torch.tests.test_ensemble_plain import *  # noqa: E402,F401,F403

from benchmark_torch.tests.test_ensemble_plain import CELL  # noqa: E402


def test_cell_is_declared_with_its_files():
    """The benchmark's declaration test, the cell's per-layer metrics being
    its twelve and program_idle_ms, the idle the program owns."""
    bench = Bench(ROOT)
    cell = bench.cell(CELL)
    assert cell["kind"] == "ensemble_plain" and cell["workload"]["chips"] == 1
    cfg, q8 = cell["config"], bench.config("nq-ensemble")
    assert cfg["reduced"] == ["docs"] and cfg["presorted"] is False and "layout" in cfg
    assert {k: v for k, v in cfg.items() if k not in ("kind", "deployment", "presorted",
                                                      "layout", "precision", "assumed")} == {
        k: v for k, v in q8.items() if k not in ("kind", "deployment", "presorted",
                                                  "precision", "assumed")}
    assert cfg["assumed"][:-1] == q8["assumed"]
    assert cell["traffic"] == dict(bench.traffic("q8-b1024"), mode="sort")
    assert {"kernels_per_step", "sparse_views_ms", "dense_view_ms", "qpp_fusion_ms",
            "k1_roofline", "merge_roofline", "device_idle_share", "host_syncs_per_step",
            "host_blocked_ms", "qpp_fusion_idle_ms", "pair_sums_ms", "pair_sums_roofline",
            "program_idle_ms"} == {
        m["name"] for m in bench.metrics_of(CELL, "per_layer")}
    names = [e["name"] for e in bench.spans("ensemble_plain")["spans"]]
    assert names[:6] == [e["name"] for e in bench.spans("ensemble")["spans"]]
    assert names[6:] == ["pair_sums"]
