"""The readers of the program's own spans (host_syncs_per_step,
host_blocked_ms) on synthetic span lists, and qpp_fusion_idle_ms on
synthetic summaries."""

import sys

import pytest

from benchmark_torch.harness.bench import Bench

from conftest import ROOT

MS = 1_000_000  # ns


def _span(name, parent, start_ms, end_ms):
    from qpp_fusion_rag_tpu_torch.tracing import Span

    return Span(name, parent, int(start_ms * MS), int(end_ms * MS))


def _summary(steps=2, busy_s=0.01, idle_gaps=None):
    return {"steps": steps, "busy_s": busy_s, "window_s": 0.05, "kernel_count": 10,
            "idle_gaps": idle_gaps or {}}


def _reader(name):
    return Bench(ROOT).metric(name).read


@pytest.fixture
def kept(monkeypatch):
    """Sets what the program's tracing.spans() returns."""
    from qpp_fusion_rag_tpu_torch import tracing

    box = []
    monkeypatch.setattr(tracing, "spans", lambda: tuple(box))
    return box


def _two_ensemble_steps():
    """Step 1 waits 2 ms at entry and 5 ms on text_feats; step 2 once, 1 ms."""
    return [_span("sync.bm25_terms", "ensemble_step", 0.5, 2.5),
            _span("sparse_view", "ensemble_step", 2.5, 6.0),
            _span("sync.text_feats", "ensemble_step", 6.0, 11.0),
            _span("qpp", "ensemble_step", 11.0, 13.0),
            _span("ensemble_step", None, 0.0, 14.0),
            _span("sync.text_feats", "ensemble_step", 20.0, 21.0),
            _span("ensemble_step", None, 15.0, 25.0)]


def test_syncs_and_blocked_time_per_step(kept):
    kept.extend(_two_ensemble_steps())
    assert _reader("host_syncs_per_step")(_summary()) == 1.5
    assert _reader("host_blocked_ms")(_summary()) == pytest.approx((2 + 5 + 1) / 2)


def test_no_sync_is_a_reading_of_zero(kept):
    kept.extend([_span("flagship_retrieval", "flagship_step", 0.0, 3.0),
                 _span("flagship_step", None, 0.0, 4.0)])
    assert _reader("host_syncs_per_step")(_summary(steps=1)) == 0.0
    assert _reader("host_blocked_ms")(_summary(steps=1)) == 0.0


@pytest.mark.parametrize("case", ["steps differ", "no step kept", "no device work"])
def test_unreadable_traces_give_nothing(kept, case):
    kept.extend(_two_ensemble_steps())
    summary = _summary()
    if case == "steps differ":
        summary["steps"] = 3                   # one step span fell out of the buffer
    elif case == "no step kept":
        kept[:] = [s for s in kept if s.name != "ensemble_step"]
    else:
        summary["busy_s"] = 0.0                # a CPU run
    assert _reader("host_syncs_per_step")(summary) is None
    assert _reader("host_blocked_ms")(summary) is None


def test_a_program_without_tracing_gives_nothing(monkeypatch):
    monkeypatch.setitem(sys.modules, "qpp_fusion_rag_tpu_torch.tracing", None)
    assert _reader("host_syncs_per_step")(_summary()) is None
    assert _reader("host_blocked_ms")(_summary()) is None


@pytest.mark.parametrize("label,counted", [
    ("qpp > aten::add", True),
    ("qpp", True),
    ("qpp_norm > aten::amin", True),
    ("minmax > aten::where", True),
    ("fusion > aten::sort", True),
    ("qpp.prefix > aten::add", True),
    ("fusion.combine > aten::cumsum", True),
    ("aten::add", False),
    ("sparse_view", False),
    ("sparse_view > aten::where", False),
    ("sync.text_feats > aten::copy_", False),
    ("qppx > aten::add", False),
    ("fusionist", False),
    ("step", False),
    ("between steps", False),
])
def test_idle_labels_of_qpp_and_fusion(label, counted):
    summary = _summary(idle_gaps={label: 0.004, "dense_view > aten::sort": 0.002})
    assert _reader("qpp_fusion_idle_ms")(summary) == pytest.approx(2.0 if counted else 0.0)


def test_idle_reader_without_device_work_gives_nothing():
    summary = _summary(busy_s=0.0, idle_gaps={"qpp > aten::add": 0.004})
    assert _reader("qpp_fusion_idle_ms")(summary) is None
