"""The roofline formulas reproduce the bounds the port recorded for K1, K2
and K7 at the cells' shapes."""

import pytest

from benchmark_torch.harness.bench import Bench

from conftest import ROOT


@pytest.fixture(scope="module")
def bench():
    return Bench(ROOT)


def _cell(bench, name, batch=None):
    config, traffic = name.split(".")
    cfg = bench.config(config)
    tr = dict(bench.traffic(traffic))
    if batch is not None:
        tr["batch"] = batch
    return {"name": name, "kind": cfg["kind"], "config": cfg, "traffic": tr}


@pytest.mark.parametrize("metric,cell,batch,ms", [
    ("k1_roofline", "nq-ensemble.q8-b1024", None, 2.083),
    ("k1_roofline", "nq-dense5.int8-b1024", None, 10.417),
    ("k1_roofline", "nq-ensemble.q8-b1024", 32, 0.605),
    ("k2_roofline", "nq-ensemble.q8-b1024", None, 0.180),
    ("k7_roofline", "nq-dense5.bf16-b1024", None, 20.845),
])
def test_bounds(bench, metric, cell, batch, ms):
    work = bench.metric(metric).work_s(_cell(bench, cell, batch))
    assert work * 1e3 == pytest.approx(ms, abs=6e-4)


def test_roofline_reads_the_kernel_time(bench):
    m = bench.metric("k1_roofline")
    cell = _cell(bench, "nq-ensemble.q8-b1024")
    name = "void group_max_kernel<S8, 0, PackedMax>(CUtensorMap, CUtensorMap, PackedMax)"
    summary = {"steps": 2, "cell": cell,
               "kernels": {name: {"calls": 2, "device_s": 2 * 3.14e-3},
                           "void group_max_kernel<S8Unscaled, 0, PackedIMax>()": {
                               "calls": 5, "device_s": 1.0}}}
    assert m.read(summary) == pytest.approx(100 * 2.0834 / 3.14, rel=1e-3)
    summary["kernels"] = {}
    assert m.read(summary) is None
