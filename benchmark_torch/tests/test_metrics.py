"""The trace summary from canned profiler events, and each per-layer
metric reader on a canned summary."""

import pytest

from benchmark_torch.harness import trace as T
from benchmark_torch.harness.bench import Bench

from conftest import ROOT

K1 = "void group_max_kernel<S8, 0, PackedMax>(CUtensorMap, CUtensorMap, PackedMax)"
K2 = "void (anonymous namespace)::bitonic_segsum_kernel<256>(int const*)"
US = 1000  # ns


def _events():
    """Two steps on thread 1. Step 1 launches K2 inside the sparse span and
    K1 inside the dense span (through a runtime call), then a sort kernel
    whose link is only to its CPU op; step 2 launches K1 alone."""
    E = T.Ev
    ev = [
        E("step", "user_annotation", False, 0, 1000 * US, tid=1, corr=1),
        E("sparse_view", "user_annotation", False, 10 * US, 300 * US, tid=1, corr=2),
        E("cudaLaunchKernel", "cuda_runtime", False, 20 * US, 30 * US, tid=1, corr=900),
        E(K2, "kernel", True, 40 * US, 140 * US, corr=900, linked=2),
        E("dense_view", "user_annotation", False, 300 * US, 700 * US, tid=1, corr=3),
        E("cuLaunchKernelEx", "cuda_driver", False, 310 * US, 320 * US, tid=1, corr=901),
        E(K1, "kernel", True, 330 * US, 630 * US, corr=901, linked=3),
        E("aten::sort", "cpu_op", False, 640 * US, 690 * US, tid=1, corr=4),
        E("void radix_sort(int)", "kernel", True, 660 * US, 680 * US, corr=0, linked=4),
        E("cudaStreamSynchronize", "cuda_runtime", False, 700 * US, 990 * US, tid=1, corr=902),
        E("Memcpy DtoH", "gpu_memcpy", True, 700 * US, 710 * US, corr=903),
        E("step", "user_annotation", False, 1000 * US, 2000 * US, tid=1, corr=5),
        E("dense_view", "user_annotation", False, 1100 * US, 1500 * US, tid=1, corr=6),
        E("cudaLaunchKernel", "cuda_runtime", False, 1110 * US, 1120 * US, tid=1, corr=904),
        E(K1, "kernel", True, 1200 * US, 1500 * US, corr=904, linked=6),
        E("gpu annotation", "gpu_user_annotation", True, 0, 2000 * US),
    ]
    return ev


@pytest.fixture(scope="module")
def summary():
    cell = Bench(ROOT).cell("nq-ensemble.q8-b1024")
    info = {"name": cell["name"], "kind": cell["kind"], "config": cell["config"],
            "traffic": cell["traffic"]}
    return T.summarize(_events(), ["sparse_view", "dense_view"], info)


def test_summary(summary):
    assert summary["steps"] == 2
    assert summary["kernel_count"] == 4
    assert summary["window_s"] == pytest.approx(2000e-6)
    assert summary["busy_s"] == pytest.approx((100 + 300 + 20 + 10 + 300) * 1e-6)
    assert summary["spans"]["sparse_view"] == {"device_s": pytest.approx(100e-6), "kernels": 1}
    assert summary["spans"]["dense_view"]["kernels"] == 3        # K1 twice, the sort once
    assert summary["kernels"][K1]["calls"] == 2
    gaps = summary["idle_gaps"]
    assert gaps["cudaStreamSynchronize"] == pytest.approx(490e-6)       # 710-1200 us
    assert gaps["sparse_view > cudaLaunchKernel"] == pytest.approx(40e-6)
    assert gaps["step"] == pytest.approx(500e-6)                        # 1500-2000 us
    assert sum(gaps.values()) == pytest.approx(2000e-6 - summary["busy_s"])
    b = T.breakdown(summary)
    assert b["device_ops"][0] == [K1, pytest.approx(600e-6)]
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


@pytest.mark.parametrize("name,value", [
    ("kernels_per_step", 2.0),
    ("sparse_views_ms", 0.05),
    ("dense_view_ms", (300 + 20 + 300) * 1e-3 / 2),
    ("device_idle_share", 100 * (1 - 730 / 2000)),
    ("k2_roofline", 100 * 2 * 0.18029 / 0.1),
])
def test_reader(summary, name, value):
    assert Bench(ROOT).metric(name).read(summary) == pytest.approx(value, rel=1e-3)


@pytest.mark.parametrize("name", ["flagship_retrieval_ms", "qpp_fusion_ms", "k7_roofline"])
def test_reader_without_its_layer_returns_nothing(summary, name):
    assert Bench(ROOT).metric(name).read(summary) is None


def test_every_declared_metric_has_a_reader():
    bench = Bench(ROOT)
    for m in bench.spec["per_layer"]:
        assert callable(bench.metric(m["name"]).read)
