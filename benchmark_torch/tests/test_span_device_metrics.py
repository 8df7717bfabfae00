"""The reader of the idle the program owns (program_idle_ms), on synthetic
kept spans and summaries."""

import sys
from collections import namedtuple
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark_torch.harness.bench import Bench  # noqa: E402

MS = 1_000_000  # ns


def _span(name, parent, start_ms, end_ms, dev_start_ms=None, dev_end_ms=None):
    from qpp_fusion_rag_tpu_torch.tracing import Span

    dev = [None if t is None else int(t * MS) for t in (dev_start_ms, dev_end_ms)]
    return Span(name, parent, int(start_ms * MS), int(end_ms * MS), *dev)


def _summary(steps=2, busy_s=0.01, idle_gaps=None, kind="ensemble"):
    return {"steps": steps, "busy_s": busy_s, "window_s": 0.05, "kernel_count": 10,
            "idle_gaps": idle_gaps or {}, "cell": {"kind": kind}}


def _reader(name):
    return Bench(ROOT).metric(name).read


@pytest.fixture
def kept(monkeypatch):
    """Sets what the program's tracing.spans() returns."""
    from qpp_fusion_rag_tpu_torch import tracing

    box = []
    monkeypatch.setattr(tracing, "spans", lambda: tuple(box))
    return box


def _two_steps(leaf):
    """Two ensemble steps; each runs `leaf` once with a device interval of
    3 ms (step 1) and 2 ms (step 2) that starts 0.5 ms after the host
    opened it."""
    return [_span(leaf, "sparse_view", 1.0, 4.0, 1.5, 4.5),
            _span("sparse_view", "ensemble_step", 0.5, 5.0, 1.0, 5.5),
            _span("ensemble_step", None, 0.0, 6.0, 0.5, 6.5),
            _span(leaf, "sparse_view", 11.0, 12.5, 11.5, 13.5),
            _span("sparse_view", "ensemble_step", 10.5, 13.0, 11.0, 14.0),
            _span("ensemble_step", None, 10.0, 14.0, 10.5, 14.5)]


@pytest.mark.parametrize("metric", ["program_idle_ms"])
def test_a_program_without_tracing_gives_nothing(monkeypatch, metric):
    monkeypatch.setitem(sys.modules, "qpp_fusion_rag_tpu_torch.tracing", None)
    assert _reader(metric)(_summary()) is None


IDLE = {"sparse.keys": 0.0040, "sparse.keys > aten::empty": 0.0020,
        "ensemble_step > aten::is_pinned": 0.0010, "sync.text_feats > aten::copy_": 0.0005,
        "rerank": 0.0003, "pair_sums > cudaLaunchKernel": 0.0002,
        "sparse_rescore": 0.0001, "cudaMemcpyAsync": 0.0030, "aten::copy_": 0.0004,
        "step": 0.0011, "between steps": 0.0006}
HARNESS = ("cudaMemcpyAsync", "aten::copy_", "step", "between steps")


def _steps_with_sync():
    return [*_two_steps("sparse.keys"), _span("sync.text_feats", "ensemble_step", 5.0, 5.5)]


@pytest.mark.parametrize("kind,wrappers", [("ensemble", 0.0), ("ensemble_plain", 0.0002),
                                           ("ensemble_rs", 0.0001)])
def test_program_idle_and_the_harness_s_make_the_whole_idle(kept, kind, wrappers):
    """Gaps labelled with a kept span or one of the cell's wrappers are the
    program's; the rest, labels with no span part, the harness's; the two
    add up to all the idle. The plain cell's wrapper pair_sums and the
    rank-safe cell's sparse_rescore are the program's only in their cells."""
    kept.extend(_steps_with_sync())
    summary = _summary(idle_gaps=IDLE, kind=kind)
    program = _reader("program_idle_ms")(summary)
    assert program == pytest.approx((0.0040 + 0.0020 + 0.0010 + 0.0005 + 0.0003 + wrappers)
                                    * 1e3 / 2)
    others = sum(v for k, v in IDLE.items() if k in HARNESS) * 1e3 / 2
    unnamed_wrappers = (0.0003 - wrappers) * 1e3 / 2     # another cell's wrapper names
    assert program + others + unnamed_wrappers == pytest.approx(sum(IDLE.values()) * 1e3 / 2)


def test_program_idle_is_at_most_the_idle_share_s(kept):
    """program_idle_ms never passes the idle ms a step device_idle_share
    gives."""
    kept.extend(_steps_with_sync())
    summary = _summary(idle_gaps=IDLE)
    summary["window_s"] = summary["busy_s"] + sum(IDLE.values())
    share = _reader("device_idle_share")(summary)
    idle_ms = share / 100 * summary["window_s"] * 1e3 / summary["steps"]
    assert _reader("program_idle_ms")(summary) <= idle_ms + 1e-12
    assert idle_ms == pytest.approx(sum(IDLE.values()) * 1e3 / 2)


@pytest.mark.parametrize("case", ["steps differ", "no device work", "no step kept"])
def test_program_idle_of_unreadable_traces_gives_nothing(kept, case):
    kept.extend(_steps_with_sync())
    summary = _summary(idle_gaps=IDLE)
    if case == "steps differ":
        summary["steps"] = 1
    elif case == "no device work":
        summary["busy_s"] = 0.0
    else:
        kept[:] = [s for s in kept if s.name != "ensemble_step"]
    assert _reader("program_idle_ms")(summary) is None


@pytest.mark.parametrize("steps", [1, 2, 4])
def test_program_idle_is_per_step(kept, steps):
    """The same gaps over more kept and traced steps read less a step."""
    for j in range(steps):
        kept.append(_span("sparse.keys", "sparse_view", 10.0 * j + 1.0, 10.0 * j + 2.0))
        kept.append(_span("ensemble_step", None, 10.0 * j, 10.0 * j + 6.0))
    summary = _summary(steps=steps, idle_gaps={"sparse.keys": 0.004, "step": 0.001})
    assert _reader("program_idle_ms")(summary) == pytest.approx(4.0 / steps)


LABELS = [("sparse.keys", "ensemble", True), ("sparse.keys > aten::empty", "ensemble", True),
          ("sparse.keysx > aten::add", "ensemble", False), ("aten::sparse.keys", "ensemble", False),
          ("sparse_view > aten::empty", "ensemble", True), ("dense_view", "ensemble", True),
          ("pair_sums", "ensemble", False), ("pair_sums", "ensemble_plain", True),
          ("cudaMemcpyAsync", "ensemble", False), ("step", "ensemble", False),
          ("between steps", "ensemble", False), ("flagship_retrieval", "flagship", True),
          ("minmax > aten::min", "flagship", True), ("rerank", "flagship", False)]


@pytest.mark.parametrize("label,kind,owned", LABELS)
def test_program_idle_owns_a_label_by_its_span_part(kept, label, kind, owned):
    """A gap is the program's where the part of its label before " > "
    names a kept span or one of the cell's wrappers, and the whole label,
    not a prefix of it, is compared."""
    kept.extend(_span(n, None, 10.0 * j, 10.0 * j + 6.0)
                for j, n in enumerate(["ensemble_step", "sparse.keys", "ensemble_step"]))
    summary = _summary(idle_gaps={label: 0.002}, kind=kind)
    assert _reader("program_idle_ms")(summary) == pytest.approx(1.0 if owned else 0.0)


def test_program_idle_reads_the_host_times_only(kept):
    """program_idle_ms needs no device interval: a program whose spans keep
    host times only still gives it."""
    Old = namedtuple("Span", "name parent start_ns end_ns")
    kept.extend(Old(*s[:4]) for s in _steps_with_sync())
    assert _reader("program_idle_ms")(_summary(idle_gaps=IDLE)) == pytest.approx(
        (0.0040 + 0.0020 + 0.0010 + 0.0005 + 0.0003) * 1e3 / 2)
