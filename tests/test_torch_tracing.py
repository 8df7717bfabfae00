"""The port's tracing module (qpp_fusion_rag_tpu_torch/tracing.py): spans
only while torch.profiler records or inside recording(), their names and
nesting in the two served steps as kept and as the profiler saw them, the
spans' device intervals (on a fake device whose clock is the host's), the
counted moves, and the one launch counter. CPU tensors, except in the
tests marked cuda at the end, which skip without a card: there a host ->
CUDA move is staged through pinned memory without a wait, the steps'
outputs are the same bits from host and from card inputs, and every kept
span's device interval holds its work. The file imports no JAX."""

import contextlib
import time
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from qpp_fusion_rag_tpu_torch import tracing as T
from qpp_fusion_rag_tpu_torch.data.synthetic import zipf_bm25_csr, zipf_queries
from qpp_fusion_rag_tpu_torch.ops import sparse as SP
from qpp_fusion_rag_tpu_torch.ops.kernels.dense_topk import quantize_rows
from qpp_fusion_rag_tpu_torch.pipeline import engine as EN
from qpp_fusion_rag_tpu_torch.pipeline import ensemble as EM

N, D, R, B, K, CAP = 4096, 32, 5, 8, 16, 64
STEP_SPANS = {"ensemble": "ensemble_step", "ensemble.sort": "ensemble_step",
              "flagship": "flagship_step"}
SORT_SPANS = ["sparse.pairs", "sparse.pair_sort", "sparse.run_sums"]


def _kit(device, routes=("int8",), cap=CAP, terms=(8, 16)):
    """-> {kind: (step, inputs)}, step(*inputs) one served step with its
    indexes and corpus on `device`: "ensemble", the q8 ensemble step over
    presorted BM25 / SPLADE postings (as the benchmark serves it),
    "ensemble.sort", the step in its default sparse mode over the same
    postings in the plain layout, and "flagship" on the int8 route
    ("flagship.<route>" for each other route of `routes`: bf16, plain).
    Query terms, weights and text features are host tensors, as the
    benchmark hands them over; embeddings and projections lie on `device`.
    The sparse views take windows of `cap` postings and `terms` (BM25,
    SPLADE) query terms."""
    arrays, plain, inputs = {}, {}, []
    for (name, vocab, avg, seed), tq in zip((("bm25", 1500, 30.0, 0),
                                             ("splade", 1000, 40.0, 7)), terms):
        off, docs, w, _ = zipf_bm25_csr(N, vocab_size=vocab, avg_doc_len=avg, seed=seed)
        scales = SP.term_scales_from_csr(w, off)
        packed, off2, sc = SP.pack_postings_presorted(docs, w, off, cap=cap, scales=scales)
        arrays.update({f"{name}_packed": torch.from_numpy(packed).to(device),
                       f"{name}_offsets": torch.from_numpy(off2.astype(np.int32)).to(device),
                       f"{name}_scales": torch.from_numpy(sc).to(device)})
        packed, sc = SP.pack_postings(docs, w, off, scales=scales)
        plain.update({f"{name}_packed": torch.from_numpy(packed).to(device),
                      f"{name}_offsets": torch.from_numpy(off.astype(np.int32)).to(device),
                      f"{name}_scales": torch.from_numpy(sc).to(device)})
        qt, qw = zipf_queries(off, B, n_terms=tq, seed=seed + 1)
        inputs += [torch.from_numpy(qt), torch.from_numpy(qw)]
    rng = np.random.default_rng(0)
    corpus = torch.from_numpy(rng.standard_normal((N, D), np.float32))
    rows, d_scale = quantize_rows(corpus)
    rows, d_scale = rows.to(device), d_scale.reshape(-1).to(device)
    idx = EM.EnsembleIndexes(corpus_rows=rows, d_scale=d_scale, **arrays)
    idx_plain = EM.EnsembleIndexes(corpus_rows=rows, d_scale=d_scale, **plain)
    q = torch.from_numpy(rng.standard_normal((B, D), np.float32)).to(device)
    rerank_proj = torch.from_numpy(rng.standard_normal((2, D, D), np.float32) * 0.05)
    view_proj = torch.from_numpy(rng.standard_normal((R, D, D), np.float32) * 0.05)
    view_proj = view_proj.to(device)
    tf = torch.tensor([[6.0, 6.0, 9.0, 5.0]]).repeat(B, 1)
    kit = {"ensemble": (lambda *a: EM.ensemble_retrieval_step(
        idx, *a, k=K, k_out=K, p_cap=cap, sparse_mode="q8", sparse_presorted=True),
        (*inputs, q, rerank_proj.to(device), tf)),
        "ensemble.sort": (lambda *a: EM.ensemble_retrieval_step(
            idx_plain, *a, k=K, k_out=K, p_cap=cap), (*inputs, q, rerank_proj.to(device), tf))}
    corpora = {"int8": (rows, {"corpus_scale": d_scale}),
               "bf16": (corpus.to(torch.bfloat16).to(device), {"use_pallas": True}),
               "plain": (corpus.to(device), {})}
    for route in routes:
        corpus_r, kw = corpora[route]
        kit["flagship" if route == "int8" else f"flagship.{route}"] = (
            lambda qe, text, corpus_r=corpus_r, kw=kw: EN.fused_retrieval_step(
                qe, view_proj, corpus_r, text, k=K, k_out=K, **kw), (q, tf))
    return kit


@pytest.fixture(scope="module")
def steps():
    """-> {"ensemble": step(), "ensemble.sort": step(), "flagship": step()}
    on the CPU (_kit)."""
    return {kind: (lambda fn=fn, inputs=inputs: fn(*inputs))
            for kind, (fn, inputs) in _kit("cpu").items()}


def _traced(step):
    """-> (the step's outputs, kept spans, kineto user annotations) of one
    step run under torch.profiler (CPU activity)."""
    T.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = step()
    notes = [e for e in prof.profiler.kineto_results.events() if e.is_user_annotation()]
    return out, T.spans(), notes


def _children(kept, parent):
    return [s.name for s in sorted(kept, key=lambda s: s.start_ns) if s.parent == parent]


def _nesting(notes):
    """(name, innermost enclosing annotation's name) of each annotation, from
    the profiler's own start and end times."""
    order = sorted(notes, key=lambda e: (e.start_ns(), -e.end_ns()))
    stack, out = [], []
    for e in order:
        while stack and stack[-1].end_ns() < e.start_ns():
            stack.pop()
        out.append((e.name(), stack[-1].name() if stack else None))
        stack.append(e)
    return Counter(out)


def test_no_spans_and_no_annotations_without_profiler(steps, monkeypatch):
    calls = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: calls.append(name) or real(name))
    T.clear()
    for step in steps.values():
        step()
    assert T.spans() == () and calls == []
    assert T.span("a") is T.span("b")          # the one shared no-op context


@pytest.mark.parametrize("kind", ["ensemble", "ensemble.sort", "flagship"])
def test_spans_under_profiler_match_the_trace(steps, kind):
    """The kept spans are exactly the profiler's user annotations, name for
    name and parent for parent; one step span at the top, none named
    "step" (the benchmark counts steps by that name)."""
    _, kept, notes = _traced(steps[kind])
    assert Counter((s.name, s.parent) for s in kept) == _nesting(notes)
    assert [s.name for s in kept if s.parent is None] == [STEP_SPANS[kind]]
    assert "step" not in {s.name for s in kept}
    assert all(s.start_ns <= s.end_ns for s in kept)


def test_ensemble_step_layers(steps):
    _, kept, _ = _traced(steps["ensemble"])
    assert _children(kept, "ensemble_step") == [
        "sparse_view", "sparse_view", "dense_view", "rerank", "qpp", "qpp_norm", "fusion"]
    assert _children(kept, "sparse_view") == ["sparse.keys", "sparse.row_sums",
                                              "sparse.topk"] * 2
    assert _children(kept, "dense_view") == ["dense.group_max", "dense.merge"]
    assert _children(kept, "qpp") == ["qpp.mean", "qpp.moments", "qpp.prefix", "qpp.columns"]
    assert _children(kept, "fusion") == ["fusion.minmax", "fusion.combine"]
    assert not [s for s in kept if s.name.startswith(T.SYNC)]   # no card, no waits


def test_sort_step_layers(steps):
    """The default sparse mode's three phases open under each sparse view and
    nowhere else: fusion's own segmented top-k carries no sparse label."""
    _, kept, _ = _traced(steps["ensemble.sort"])
    assert _children(kept, "ensemble_step") == [
        "sparse_view", "sparse_view", "dense_view", "rerank", "qpp", "qpp_norm", "fusion"]
    assert _children(kept, "sparse_view") == SORT_SPANS * 2
    assert {s.parent for s in kept if s.name.startswith("sparse.")} == {"sparse_view"}
    assert _children(kept, "fusion") == ["fusion.minmax", "fusion.combine"]
    assert _children(kept, "fusion.combine") == []


def _parent_route(docs, vals, k):
    """The pair sums as they ran before their spans: one segmented_topk."""
    from qpp_fusion_rag_tpu_torch.ops.segment import segmented_topk

    ids, scores, _ = segmented_topk(docs, vals, k)
    return scores, ids


@pytest.mark.parametrize("k", [1, 16, 5000])
def test_pair_sums_equal_segmented_topk(k):
    """_segmented_scores gives segmented_topk's bits on rows with repeated
    ids, SENTINEL pads and tied sums, k past the row's runs included."""
    from qpp_fusion_rag_tpu_torch.ops.segment import SENTINEL

    g = torch.Generator().manual_seed(3)
    docs = torch.randint(0, 300, (6, 1024), generator=g, dtype=torch.int32)
    docs[:, -100:] = SENTINEL
    vals = torch.randint(0, 4, (6, 1024), generator=g).float() * 0.37
    got, want = SP._segmented_scores(docs, vals, k), _parent_route(docs, vals, k)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_sort_step_equals_the_segmented_topk_route(steps, monkeypatch):
    got = steps["ensemble.sort"]()
    monkeypatch.setattr(SP, "_segmented_scores", _parent_route)
    want = steps["ensemble.sort"]()
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_flagship_step_layers(steps):
    _, kept, _ = _traced(steps["flagship"])
    assert _children(kept, "flagship_step") == ["flagship_retrieval", "qpp", "minmax",
                                                "fusion"]
    assert _children(kept, "flagship_retrieval") == [
        "retrieve.project", "retrieve.group_max", "retrieve.merge"]
    assert _children(kept, "qpp") == ["qpp.mean", "qpp.moments", "qpp.prefix",
                                      "qpp.columns", "qpp_norm"]
    assert _children(kept, "fusion") == ["fusion.combine"]


@pytest.mark.parametrize("kind", ["ensemble", "ensemble.sort", "flagship"])
def test_outputs_bit_equal_with_tracing_on_and_off(steps, kind):
    off = steps[kind]()
    on, _, _ = _traced(steps[kind])
    assert len(on) == len(off)
    for a, b in zip(on, off):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_blocking_move_is_host_memory_to_a_cuda_device():
    """Host memory to a CUDA device is a staged move, not a blocking one;
    host memory to the CPU is neither."""
    for x in (torch.zeros(3), np.zeros(3, np.float32), 2.5, np.int32(7)):
        for device in ("cuda", torch.device("cuda", 0)):
            assert T.staged_move(x, device) and not T.blocking_move(x, device)
        for device in ("cpu", torch.device("cpu")):
            assert not T.staged_move(x, device) and not T.blocking_move(x, device)


@pytest.mark.parametrize("device", ["cuda", torch.device("cuda", 0), "meta"])
def test_a_device_tensor_is_neither_staged_nor_blocking(device):
    """A tensor already off the host moves device to device: no staging and
    no wait. A meta tensor stands in for a CUDA one: both decisions read
    only the device types."""
    x = torch.zeros(3, device="meta")
    assert not T.staged_move(x, device) and not T.blocking_move(x, device)


def _counts(site):
    return T.STAGED[site], T.SYNCS[site]


@pytest.mark.parametrize("x", [torch.arange(6, dtype=torch.int32),
                               np.arange(6, dtype=np.int32), np.int32(7), 2.5])
def test_a_cpu_target_counts_nothing(x):
    site = "test_cpu_target"
    before = _counts(site)
    T.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        y = T.to_device(x, "cpu", torch.float32, site)
    assert y.dtype == torch.float32 and torch.equal(y, torch.as_tensor(x).float())
    assert _counts(site) == before and T.spans() == ()


def test_to_device_counts_blocking_moves_only(monkeypatch):
    """A blocking move counts one sync and runs in its span; it carries
    nothing host -> device, so STAGED stays."""
    site = "test_site"
    x = torch.arange(6, dtype=torch.int32)
    before = _counts(site)
    y = T.to_device(x, "cpu", torch.float32, site)           # same device: nothing
    assert y.dtype == torch.float32 and torch.equal(y, x.float())
    assert _counts(site) == before

    monkeypatch.setattr(T, "blocking_move", lambda x, device: True)
    T.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        y = T.to_device(x, "cpu", None, site)
    assert y.dtype == torch.int32 and torch.equal(y, x)
    assert _counts(site) == (before[0], before[1] + 1)
    assert [s.name for s in T.spans()] == ["sync." + site]


@pytest.mark.parametrize("pinned", [False, True])
def test_to_device_stages_host_memory_without_a_wait(monkeypatch, pinned):
    """A staged move pins a copy of the host data (unless it is pinned
    already), sends it with non_blocking=True, counts one STAGED move, and
    neither counts a sync nor opens a sync span. The CPU stands in for the
    card: the pinning and the copy are recorded."""
    site = "test_staged"
    x = np.arange(6, dtype=np.int32)
    calls = []
    monkeypatch.setattr(T, "staged_move", lambda x, device: True)
    monkeypatch.setattr(torch.Tensor, "is_pinned", lambda self: pinned)
    monkeypatch.setattr(torch.Tensor, "pin_memory",
                        lambda self: calls.append("pin") or self.clone())
    real_to = torch.Tensor.to

    def to(self, *args, **kwargs):
        calls.append(("to", args, kwargs))
        return real_to(self, *args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "to", to)
    before = _counts(site)
    T.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        y = T.to_device(x, "cpu", torch.float32, site)
    if not pinned:
        x[:] = -1                                 # the caller's buffer is free at once
    assert y.dtype == torch.float32 and torch.equal(y, torch.arange(6).float())
    assert calls == [*([] if pinned else ["pin"]),
                     ("to", ("cpu",), {"non_blocking": True}),
                     ("to", (torch.float32,), {})]
    assert _counts(site) == (before[0] + 1, before[1])
    assert T.spans() == ()


def test_host_sync_counts_and_spans():
    site = "test_read"
    before = T.SYNCS[site]
    T.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        with T.host_sync(site):
            pass
    assert T.SYNCS[site] == before + 1
    assert [s.name for s in T.spans()] == ["sync." + site]


def test_one_launch_counter():
    from qpp_fusion_rag_tpu_torch.ops import kernels
    from qpp_fusion_rag_tpu_torch.ops.kernels import dense_topk

    assert kernels.LAUNCHES is T.LAUNCHES
    assert dense_topk.LAUNCHES is T.LAUNCHES


@pytest.mark.parametrize("M,ctas", [(1, 1), (2048, 1), (16384, 1), (16385, 2), (32768, 2),
                                    (32769, 4), (65536, 4)])
def test_k2_cluster_size_is_the_padded_row_over_16384_keys(M, ctas):
    from qpp_fusion_rag_tpu_torch.ops.kernels import bitonic

    assert bitonic.cluster_ctas(M) == ctas


def test_k2_plain_route_counts_no_cluster():
    """A CPU row takes K2's plain version: no launch, no route counted."""
    from qpp_fusion_rag_tpu_torch.ops.kernels import bitonic

    before, launches = Counter(T.K2_CLUSTERS), T.LAUNCHES["bitonic_segsum_rows"]
    bitonic.bitonic_segsum_rows(torch.zeros((2, 32768), dtype=torch.int32))
    assert T.K2_CLUSTERS == before
    assert T.LAUNCHES["bitonic_segsum_rows"] == launches


def test_kept_spans_are_bounded(monkeypatch):
    monkeypatch.setattr(T, "_KEPT", T.deque(maxlen=3))
    with profile(activities=[ProfilerActivity.CPU]):
        for name in "abcde":
            with T.span(name):
                pass
    assert [s.name for s in T.spans()] == ["c", "d", "e"]


def _recorded(step):
    """-> (the step's outputs, kept spans) of one step inside recording()."""
    T.clear()
    with T.recording():
        out = step()
    return out, T.spans()


def _no_cuda(monkeypatch):
    """Makes every CUDA call the spans could make raise."""
    def refuse(*a, **kw):
        raise AssertionError("a CUDA call")

    for name in ("Event", "Stream", "current_stream", "synchronize",
                 "is_current_stream_capturing"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    monkeypatch.setattr(T, "_current_stream", refuse)


def test_off_spans_keep_nothing_and_make_no_event(steps, monkeypatch):
    """With neither the profiler nor recording(), no span is kept, no
    annotation entered and no CUDA event made: the off path is the one
    shared no-op context."""
    calls = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: calls.append(name) or real(name))
    _no_cuda(monkeypatch)
    pool = list(T._POOL)
    T.clear()
    for step in steps.values():
        step()
    assert T.spans() == () and calls == [] and T._POOL == pool
    assert T.span("a") is T.span("b") is T._OFF


@pytest.mark.parametrize("kind", ["ensemble", "ensemble.sort", "flagship"])
def test_recording_keeps_the_profiler_s_spans_without_annotations(steps, kind,
                                                                  monkeypatch):
    """Inside recording() the kept spans have the names and parents they
    have under the profiler, and record_function is never entered."""
    _, traced, _ = _traced(steps[kind])
    calls = []
    monkeypatch.setattr(torch.profiler, "record_function", lambda name: calls.append(name))
    _, kept = _recorded(steps[kind])
    assert calls == []
    assert [(s.name, s.parent) for s in kept] == [(s.name, s.parent) for s in traced]
    assert all(s.start_ns <= s.end_ns for s in kept)
    assert not T._recording()


@pytest.mark.parametrize("mode", ["profiler", "recording"])
def test_cpu_spans_carry_no_device_interval(steps, mode, monkeypatch):
    """On the CPU no span records an event: dev_start_ns and dev_end_ns
    are None, and no CUDA call is made."""
    _no_cuda(monkeypatch)
    _, kept = (_traced(steps["ensemble"])[:2] if mode == "profiler"
               else _recorded(steps["ensemble"]))
    assert kept and all(s.dev_start_ns is None and s.dev_end_ns is None for s in kept)


def test_recording_keeps_a_bounded_buffer(monkeypatch):
    monkeypatch.setattr(T, "_KEPT", T.deque(maxlen=3))
    with T.recording():
        for name in "abcde":
            with T.span(name):
                pass
    assert [s.name for s in T.spans()] == ["c", "d", "e"]


def test_recording_nests_and_ends():
    assert not T._recording()
    with T.recording():
        with T.recording():
            assert T._recording()
        assert T._recording() and T.span("a") is not T._OFF
    assert not T._recording() and T.span("a") is T._OFF


LAG_NS = 200_000_000    # the fake device runs 200 ms behind the host
TOL_NS = 50_000_000     # the anchor's read, however late the host gets to it


CURRENT = object()      # the fake card's current stream


class _FakeEvent:
    """A CUDA event on a fake device whose clock is the host's: an event on
    the current stream completes LAG_NS after it is recorded, one on any
    other (idle) stream at once."""
    made = 0
    waits: list = []

    def __init__(self, enable_timing=False):
        assert enable_timing
        _FakeEvent.made += 1

    def record(self, stream=None):
        self.idle = stream is not None and stream is not CURRENT
        self.recorded = time.perf_counter_ns()
        self.at = self.recorded + (0 if self.idle else LAG_NS)

    def synchronize(self):
        _FakeEvent.waits.append(self)
        while time.perf_counter_ns() < self.at:
            pass

    def elapsed_time(self, other):
        return (other.at - self.at) / 1e6


@pytest.fixture
def fake_card(monkeypatch):
    """The spans see an initialized CUDA runtime with _FakeEvent events, an
    empty pool and no anchor stream yet."""
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "Stream", object)
    monkeypatch.setattr(T, "_current_stream", lambda: CURRENT)
    monkeypatch.setattr(T, "_POOL", [])
    monkeypatch.setattr(T, "_IDLE", [])
    monkeypatch.setattr(_FakeEvent, "made", 0)
    monkeypatch.setattr(_FakeEvent, "waits", [])
    T.clear()
    yield monkeypatch
    T.clear()


def _nested_spans():
    with T.span("outer"):
        time.sleep(0.002)
        with T.span("inner"):
            time.sleep(0.002)
        time.sleep(0.002)


@pytest.mark.parametrize("mode", ["profiler", "recording"])
def test_device_intervals_land_on_the_host_clock(fake_card, mode):
    """Inside recording(), under the profiler too, each kept span's two
    events are put on the host clock through the anchor: the times are the
    fake device's own, late by no more than the anchor's read, and LAG_NS
    after the host opened the span. The intervals nest as the spans do;
    the one wait is for the last event recorded."""
    ctx = (profile(activities=[ProfilerActivity.CPU]) if mode == "profiler"
           else contextlib.nullcontext())
    with ctx, T.recording():
        _nested_spans()
    inner, outer = T.spans()
    got = sorted(t for s in (inner, outer) for t in (s.dev_start_ns, s.dev_end_ns))
    want = sorted(e.at for e in T._POOL if not e.idle)
    assert len(got) == len(want) == 4
    assert all(isinstance(g, int) and 0 <= g - w < TOL_NS for g, w in zip(got, want))
    assert all(s.dev_start_ns - s.start_ns > LAG_NS // 2 for s in (inner, outer))
    assert outer.dev_start_ns <= inner.dev_start_ns < inner.dev_end_ns <= outer.dev_end_ns
    assert _FakeEvent.waits[0].at == max(w.at for w in _FakeEvent.waits[:4])
    assert T.spans() == (inner, outer)          # read once, kept as read


def test_events_go_back_to_the_pool(fake_card):
    """spans() and clear() return the events to the pool; later spans take
    them from there instead of making new ones."""
    with T.recording():
        _nested_spans()
    made = _FakeEvent.made
    assert made == 4 and len(T._POOL) == 0
    T.spans()
    assert _FakeEvent.made == made + 1 and len(T._POOL) == made + 1   # + the anchor
    with T.recording():
        _nested_spans()
    assert _FakeEvent.made == made + 1 and len(T._POOL) == 1
    T.clear()
    assert len(T._POOL) == made + 1 and T.spans() == ()


def test_a_capture_records_no_event(fake_card):
    """No event while the stream captures a graph: a span opened inside a
    capture, or one a capture began inside, keeps no device interval, and
    its opening event goes back to the pool."""
    capturing = [True]
    fake_card.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing[0])
    with T.recording():
        with T.span("inside"):
            pass
        capturing[0] = False
        with T.span("around"):
            capturing[0] = True
    assert [(s.name, s.dev_start_ns, s.dev_end_ns) for s in T.spans()] == [
        ("inside", None, None), ("around", None, None)]
    assert _FakeEvent.made == 1 and len(T._POOL) == 1


def test_trace_offset_puts_the_trace_on_the_spans_clock():
    """A span's annotation in the trace, less trace_offset_ns(), starts
    where the kept span starts (the span reads the host clock just after
    entering its annotation)."""
    T.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with T.span("offset_probe"):
            pass
    offset = T.trace_offset_ns()
    note, = [e for e in prof.profiler.kineto_results.events() if e.name() == "offset_probe"]
    kept, = T.spans()
    assert abs(note.start_ns() - offset - kept.start_ns) < 1_000_000


@pytest.mark.parametrize("kind", ["ensemble", "ensemble.sort", "flagship"])
def test_the_profiler_alone_records_no_event(fake_card, steps, kind):
    """On an initialized card, a step under the profiler alone keeps its
    spans with no device interval and makes, records and waits for no
    event: the events' host cost stays out of the traced window."""
    _, kept, notes = _traced(steps[kind])
    assert kept and notes
    assert all(s.dev_start_ns is None and s.dev_end_ns is None for s in kept)
    assert _FakeEvent.made == 0 and _FakeEvent.waits == [] and T._POOL == []
    assert not T._pending


@pytest.mark.parametrize("kind", ["ensemble", "ensemble.sort", "flagship"])
def test_recording_under_the_profiler_annotates_and_records(fake_card, steps, kind,
                                                            monkeypatch):
    """recording() inside a profiler session keeps the profiler's spans,
    each entering its annotation and carrying a device interval."""
    _, alone, _ = _traced(steps[kind])
    calls = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: calls.append(name) or real(name))
    T.clear()
    with profile(activities=[ProfilerActivity.CPU]), T.recording():
        steps[kind]()
    kept = T.spans()
    assert [(s.name, s.parent) for s in kept] == [(s.name, s.parent) for s in alone]
    assert sorted(calls) == sorted(s.name for s in kept)
    assert all(isinstance(s.dev_start_ns, int) and s.dev_start_ns <= s.dev_end_ns
               for s in kept)


def test_a_span_reads_the_host_clock_before_its_event(fake_card):
    """A span's host start is read before its opening event is recorded and
    its host end before its closing one, so the host's lead at a span's
    start holds the event's own cost and no more."""
    with T.recording():
        _nested_spans()
    held = list(T._KEPT)
    assert len(held) == 2
    for s in held:
        assert s.start_ns <= s.dev_start_ns.recorded <= s.dev_end_ns.recorded
        assert s.end_ns <= s.dev_end_ns.recorded


@pytest.mark.parametrize("order", ["opened inside", "opened before"])
def test_a_span_across_an_end_of_recording(fake_card, order):
    """A span opened inside recording() keeps both events though the
    context ended before the span closed; a span opened under the profiler
    before recording() began keeps none, while the span opened inside it
    keeps its own."""
    if order == "opened inside":
        rec = T.recording()
        rec.__enter__()
        with T.span("across"):
            rec.__exit__(None, None, None)
        across, = T.spans()
        assert isinstance(across.dev_start_ns, int)
        assert across.dev_start_ns <= across.dev_end_ns
    else:
        with profile(activities=[ProfilerActivity.CPU]):
            with T.span("across"):
                with T.recording(), T.span("inner"):
                    pass
        inner, across = T.spans()
        assert across.name == "across" and across.dev_start_ns is across.dev_end_ns is None
        assert inner.name == "inner" and isinstance(inner.dev_start_ns, int)
    assert _FakeEvent.made == 3         # two of the span's, the anchor
    assert not T._recording()


def test_recording_ends_when_its_block_raises():
    with pytest.raises(KeyError):
        with T.recording():
            with T.span("a"):
                raise KeyError("x")
    assert not T._recording() and T._keeping == 0 and T.span("a") is T._OFF
    assert [s.name for s in T.spans()] == ["a"]
    T.clear()


# ------------------------------------------------------------- on the card
# On the card: python -m pytest --noconftest -m cuda tests/test_torch_tracing.py

CARD_KINDS = {"ensemble": 9, "ensemble.sort": 5, "flagship": 1, "flagship.bf16": 1,
              "flagship.plain": 1}
# moves staged a step: the ensemble's four query term / weight tensors, its
# text features and, in q8, four pad keys (two a view); a flagship's text features


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a staged move is host memory to a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def card_kit(card):
    """_kit on the card with every flagship route, each step run once (the
    kernel build and the presorted cap's one read happen here)."""
    kit = _kit(card, routes=("int8", "bf16", "plain"))
    for fn, inputs in kit.values():
        fn(*inputs)
    torch.cuda.synchronize()
    return kit


def _sync_debug_error(fn, *args):
    """fn(*args) with torch raising at any call that waits for the device."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn(*args)
    finally:
        torch.cuda.set_sync_debug_mode(0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", CARD_KINDS)
def test_steps_on_the_card_never_wait_for_the_device(card_kit, kind):
    """Up to the answers' copy a step makes no call that waits for the
    device: every host input is staged, none blocks."""
    fn, inputs = card_kit[kind]
    staged, syncs = sum(T.STAGED.values()), sum(T.SYNCS.values())
    out = _sync_debug_error(fn, *inputs)
    assert [o.is_cuda for o in out] == [True] * len(out)
    assert sum(T.STAGED.values()) - staged == CARD_KINDS[kind]
    assert sum(T.SYNCS.values()) == syncs
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("host", ["numpy", "tensor"])
def test_a_staged_move_leaves_the_stream_running_and_keeps_the_values(card, host):
    """Behind ~0.5 s of queued device sleep, four moves of one host buffer,
    overwritten between them and after: to_device returns while the stream
    still sleeps, and each device tensor holds the values the buffer had
    when its move was made (no pinned block is reused before its copy)."""
    n = 1 << 16
    x = np.zeros(n, np.float32) if host == "numpy" else torch.zeros(n)
    torch.cuda.synchronize()
    torch.cuda._sleep(1 << 30)
    outs = []
    for i in range(4):
        x[:] = i
        outs.append(_sync_debug_error(T.to_device, x, card, None, "test_sleep"))
    x[:] = -1
    assert not torch.cuda.current_stream().query()
    for i, t in enumerate(outs):
        assert torch.equal(t.cpu(), torch.full((n,), float(i)))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", CARD_KINDS)
def test_outputs_bit_equal_with_host_and_card_inputs(card_kit, card, kind):
    """The step's outputs are the same bits whether its inputs come from host
    memory (staged) or lie on the card already (moved nowhere)."""
    fn, inputs = card_kit[kind]
    from_host = fn(*inputs)
    on_card = [torch.as_tensor(x).to(card) for x in inputs]
    staged = sum(T.STAGED.values())
    from_card = fn(*on_card)
    assert sum(T.STAGED.values()) - staged == (4 if kind == "ensemble" else 0)   # pad keys
    assert len(from_host) == len(from_card)
    for a, b in zip(from_host, from_card):
        assert a.dtype == b.dtype and torch.equal(a, b)


MERGE_ROWS = {"ensemble": B, "ensemble.sort": B, "flagship": R * B, "flagship.bf16": R * B}
# rows a step's one dense merge gives the row top-k kernel


@pytest.mark.cuda
@pytest.mark.parametrize("kind", MERGE_ROWS)
def test_steps_merge_on_the_kernel_with_the_sort_s_outputs(card_kit, kind, monkeypatch):
    """A step's dense merge is one row_topk launch over all its rows, and
    the step's outputs are the bits it gives with the stable sort
    (topk_first) as its merge."""
    from qpp_fusion_rag_tpu_torch.ops.kernels import dense_topk
    from qpp_fusion_rag_tpu_torch.ops.segment import topk_first

    fn, inputs = card_kit[kind]
    launches, real, seen = T.LAUNCHES["row_topk"], dense_topk.row_topk, []

    def spy(x, k):
        seen.append(x.shape[0])
        return real(x, k)

    monkeypatch.setattr(dense_topk, "row_topk", spy)
    got = fn(*inputs)
    assert seen == [MERGE_ROWS[kind]]
    assert T.LAUNCHES["row_topk"] - launches == 1
    monkeypatch.setattr(dense_topk, "row_topk", topk_first)
    ref = fn(*inputs)
    assert T.LAUNCHES["row_topk"] - launches == 1
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and torch.equal(a, b)


GRAPH_SPANS = {"ensemble": ("ensemble_step", ["fusion.minmax", "fusion.combine"]),
               "ensemble.sort": ("ensemble_step", ["fusion.minmax", "fusion.combine"]),
               "flagship": ("flagship_step", ["fusion.combine"])}
# a traced step's top span and the children of its fusion span


@pytest.mark.cuda
@pytest.mark.parametrize("kind", GRAPH_SPANS)
def test_a_traced_step_after_warm_up_replays_the_qpp_and_fusion_graphs(card_kit, kind):
    """After warm-up, a traced step shows qpp.graph under qpp and
    fusion.graph under fusion.combine (ops/graphs.py), in place of the
    eager sub-spans, and its outputs are the untraced step's bits."""
    fn, inputs = card_kit[kind]
    for _ in range(2):
        off = fn(*inputs)
    T.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        on = fn(*inputs)
        torch.cuda.synchronize()
    kept = T.spans()
    top, fusion = GRAPH_SPANS[kind]
    assert _children(kept, None) == [top]
    assert _children(kept, "qpp") == ["qpp.graph"] + (["qpp_norm"] if kind == "flagship"
                                                      else [])
    assert _children(kept, "fusion") == fusion
    assert _children(kept, "fusion.combine") == ["fusion.graph"]
    assert not {s.name for s in kept} & {"qpp.mean", "qpp.moments", "qpp.prefix",
                                         "qpp.columns"}
    assert len(on) == len(off)
    for a, b in zip(on, off):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _traced_on_card(fn, inputs, recording=False):
    """-> (outputs, kept spans) of one step under torch.profiler with CPU
    and CUDA activity, inside recording() as well where asked."""
    T.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        with T.recording() if recording else contextlib.nullcontext():
            out = fn(*inputs)
        torch.cuda.synchronize()
    return out, T.spans()


@pytest.mark.cuda
def test_sort_step_on_the_card_spans_and_bits(card_kit, monkeypatch):
    """On the card a traced sort-mode step opens the three pair-sum phases
    under each sparse view and nowhere else, and gives the untraced step's
    bits, which are the bits of the step with its pair sums on one
    segmented_topk (the route before the spans)."""
    fn, inputs = card_kit["ensemble.sort"]
    for _ in range(2):
        off = fn(*inputs)
    on, kept = _traced_on_card(fn, inputs)
    assert _children(kept, "sparse_view") == SORT_SPANS * 2
    assert {s.parent for s in kept if s.name.startswith("sparse.")} == {"sparse_view"}
    monkeypatch.setattr(SP, "_segmented_scores", _parent_route)
    parent = fn(*inputs)
    for a, b, c in zip(on, off, parent):
        assert a.dtype == b.dtype == c.dtype and torch.equal(a, b) and torch.equal(b, c)


@pytest.mark.cuda
def test_sort_step_on_the_card_launches_the_run_sums_kernel(card_kit, monkeypatch):
    """On the card a traced sort-mode step launches the run sums kernel
    once a sparse view, each call inside that view's sparse.run_sums span,
    and its outputs stay the bits of the step with its pair sums on one
    segmented_topk."""
    fn, inputs = card_kit["ensemble.sort"]
    real, calls = SP.run_sums_topk, []

    def spy(sids, svals, k):
        calls.append(time.perf_counter_ns())
        return real(sids, svals, k)

    monkeypatch.setattr(SP, "run_sums_topk", spy)
    fn(*inputs)
    calls.clear()
    launches = T.LAUNCHES["run_sums_topk"]
    on, kept = _traced_on_card(fn, inputs)
    assert T.LAUNCHES["run_sums_topk"] - launches == 2 == len(calls)
    run_sums = sorted((s for s in kept if s.name == "sparse.run_sums"), key=lambda s: s.start_ns)
    assert len(run_sums) == 2
    assert all(s.start_ns <= t <= s.end_ns for s, t in zip(run_sums, sorted(calls)))
    monkeypatch.setattr(SP, "_segmented_scores", _parent_route)
    parent = fn(*inputs)
    for a, c in zip(on, parent):
        assert a.dtype == c.dtype and torch.equal(a, c)


@pytest.mark.cuda
def test_eager_fusion_on_the_card_carries_no_sparse_span(card_kit, monkeypatch):
    """With the tail eager (no graph), the step's fusion runs segmented_topk
    on the card and opens no sparse.* span."""
    from qpp_fusion_rag_tpu_torch.ops import graphs

    monkeypatch.setattr(graphs, "replay_or_run", lambda site, fn, t, s: fn(*t, **s))
    fn, inputs = card_kit["ensemble.sort"]
    _, kept = _traced_on_card(fn, inputs)
    assert _children(kept, "fusion.combine") == []
    assert {s.parent for s in kept if s.name.startswith("sparse.")} == {"sparse_view"}
    assert "qpp.mean" in {s.name for s in kept}            # the eager tail ran


@pytest.mark.cuda
@pytest.mark.parametrize("terms,ctas", [((8, 16), {1: 1, 2: 1}), ((16, 32), {2: 1, 4: 1})])
def test_q8_step_k2_route_follows_the_query_length(card, terms, ctas):
    """At p_cap 2048 a q8 ensemble step with NQ's 8 / 16 query terms sorts
    its BM25 rows on one CTA and its SPLADE rows on a cluster of two; with
    HotpotQA's 16 / 32 terms on clusters of two and four (65,536 keys):
    one K2 launch a view, counted by the CTAs a row takes."""
    fn, inputs = _kit(card, cap=2048, terms=terms)["ensemble"]
    fn(*inputs)
    torch.cuda.synchronize()
    before = Counter(T.K2_CLUSTERS)
    fn(*inputs)
    torch.cuda.synchronize()
    assert dict(T.K2_CLUSTERS - before) == ctas


def _q8_topk_calls(step, monkeypatch):
    """-> the shapes of the run sums each q8_topk call of step() took."""
    real, calls = SP.q8_topk, []

    def spy(*a, **kw):
        calls.append(tuple(a[0].shape))
        return real(*a, **kw)

    monkeypatch.setattr(SP, "q8_topk", spy)
    step()
    return calls


@pytest.mark.parametrize("kind,calls", [("ensemble", [(B, 8 * CAP), (B, 16 * CAP)]),
                                        ("ensemble.sort", [])])
def test_q8_step_selects_through_q8_topk_once_a_view(steps, kind, calls, monkeypatch):
    """A q8 ensemble step selects each sparse view's top-k with one q8_topk
    call over its run sums; the "sort" step never calls it."""
    assert _q8_topk_calls(steps[kind], monkeypatch) == calls


def test_q8r_step_never_calls_q8_topk(monkeypatch):
    """q8r pools its candidates with the bitonic pool (K4), not M3."""
    from test_torch_rank_safe import _q8r_kit

    step, inputs = _q8r_kit(torch.device("cpu"))
    assert _q8_topk_calls(lambda: step(*inputs), monkeypatch) == []


def _q8_topk_launches(fn, inputs):
    """-> (outputs, q8_topk launches) of one step on the card."""
    before = T.LAUNCHES["q8_topk"]
    out = fn(*inputs)
    torch.cuda.synchronize()
    return out, T.LAUNCHES["q8_topk"] - before


@pytest.mark.cuda
@pytest.mark.parametrize("kind,launches", [("ensemble", 2), ("ensemble.sort", 0)])
def test_steps_on_the_card_launch_q8_topk_once_a_q8_view(card_kit, kind, launches,
                                                          monkeypatch):
    """On the card a q8 step launches M3 once a sparse view (a "sort" step
    never), and its outputs are the bits of the step with the selection on
    q8_topk_plain."""
    from qpp_fusion_rag_tpu_torch.ops.kernels.q8_topk import q8_topk_plain

    fn, inputs = card_kit[kind]
    out, n = _q8_topk_launches(fn, inputs)
    assert n == launches
    monkeypatch.setattr(SP, "q8_topk", lambda s, i, w, k, tq: q8_topk_plain(s, i, w, k))
    plain, n = _q8_topk_launches(fn, inputs)
    assert n == 0
    for a, b in zip(out, plain):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.cuda
def test_q8r_step_on_the_card_launches_no_q8_topk(card):
    from test_torch_rank_safe import _q8r_kit

    step, inputs = _q8r_kit(card)
    _, n = _q8_topk_launches(step, inputs)
    assert n == 0


@pytest.mark.cuda
@pytest.mark.parametrize("terms", [(8, 16), (16, 32)])
def test_q8_step_at_cell_lengths_launches_q8_topk_once_a_view(card, terms):
    """At p_cap 2048 with NQ's 8 / 16 and HotpotQA's 16 / 32 query terms
    (rows of 16,384 to 65,536 sums), a q8 step launches M3 twice."""
    fn, inputs = _kit(card, cap=2048, terms=terms)["ensemble"]
    _q8_topk_launches(fn, inputs)
    _, n = _q8_topk_launches(fn, inputs)
    assert n == 2


def _hotpotqa_kit(card):
    """The q8 ensemble step at HotpotQA's query lengths: 16 / 32 terms at
    p_cap 2048 (65,536-key SPLADE rows)."""
    return _kit(card, cap=2048, terms=(16, 32))["ensemble"]


DEVICE_KINDS = ["ensemble", "ensemble.sort", "hotpotqa"]
US = 1000                 # ns
# A kept span reads the host clock after the profiler has stamped its
# annotation and run its own entry work: 3-88 us on an H100 host, 800 spans
# with and without recording() (a clock error shows in milliseconds).
ANNOTATION_LAG_NS = 150 * US


def _card_step(card_kit, card, kind):
    return _hotpotqa_kit(card) if kind == "hotpotqa" else card_kit[kind]


def _enclosing(kept, s):
    """The kept span that s's parent names and whose host interval holds s's."""
    found = [p for p in kept if p.name == s.parent and p.start_ns <= s.start_ns
             and s.end_ns <= p.end_ns]
    assert len(found) == 1
    return found[0]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", DEVICE_KINDS)
def test_traced_steps_on_the_card_keep_nested_device_intervals(card_kit, card, kind):
    """In a q8, "sort" and HotpotQA-shaped step traced inside recording()
    every kept span has a device interval that starts no earlier than the
    host opened the span, and the intervals of one step nest as the spans
    do."""
    fn, inputs = _card_step(card_kit, card, kind)
    for _ in range(2):
        fn(*inputs)
    _, kept = _traced_on_card(fn, inputs, recording=True)
    assert kept
    for s in kept:
        assert isinstance(s.dev_start_ns, int) and isinstance(s.dev_end_ns, int)
        assert s.dev_start_ns <= s.dev_end_ns
        assert s.dev_start_ns >= s.start_ns - 50 * US
        if s.parent is not None:
            p = _enclosing(kept, s)
            assert p.dev_start_ns <= s.dev_start_ns and s.dev_end_ns <= p.dev_end_ns


@pytest.mark.cuda
@pytest.mark.parametrize("kind", DEVICE_KINDS)
def test_traced_steps_on_the_card_record_no_event(card_kit, card, kind):
    """Under the profiler alone a step's kept spans carry no device
    interval: no event is recorded into the traced window."""
    fn, inputs = _card_step(card_kit, card, kind)
    pool = len(T._POOL)
    _, kept = _traced_on_card(fn, inputs)
    assert kept and all(s.dev_start_ns is s.dev_end_ns is None for s in kept)
    assert len(T._POOL) == pool


@pytest.mark.cuda
def test_row_sums_interval_holds_k2_from_the_same_trace(card_kit):
    """In a step traced inside recording(), each sparse.row_sums span's
    device interval holds its K2 kernel as the trace timed it, within 50
    us, once the trace's times are put on the spans' clock
    (trace_offset_ns); and every kept span, the first included, reads the
    host clock within ANNOTATION_LAG_NS of its annotation's start in the
    trace, on either side."""
    fn, inputs = card_kit["ensemble"]
    for _ in range(2):
        fn(*inputs)
    _recorded(lambda: fn(*inputs))              # the pool holds the step's events
    T.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with T.recording():
            fn(*inputs)
        torch.cuda.synchronize()
    offset = T.trace_offset_ns()
    events = prof.profiler.kineto_results.events()
    k2 = sorted((e.start_ns() - offset, e.start_ns() + e.duration_ns() - offset)
                for e in events if "bitonic_segsum" in e.name())
    kept = T.spans()
    row_sums = sorted(s for s in kept if s.name == "sparse.row_sums")
    assert len(k2) == len(row_sums) == 2
    for s, (a, b) in zip(row_sums, k2):
        assert s.dev_start_ns - 50 * US <= a and b <= s.dev_end_ns + 50 * US
    notes = [e for e in events if not str(e.device_type()).endswith("CUDA")]
    for name in {s.name for s in kept}:
        mine = sorted((s for s in kept if s.name == name), key=lambda s: s.start_ns)
        theirs = sorted((e for e in notes if e.name() == name), key=lambda e: e.start_ns())
        assert len(mine) == len(theirs)
        for s, e in zip(mine, theirs):
            assert abs(e.start_ns() - offset - s.start_ns) <= ANNOTATION_LAG_NS


@pytest.mark.cuda
def test_a_graph_capture_inside_recording_records_no_event(card):
    """A span opened inside a graph capture under recording() records no
    event into the graph: the capture succeeds, its replay gives the eager
    bits, the span keeps no device interval, and a span around the replay
    keeps one."""
    x = torch.arange(1024, dtype=torch.float32, device=card)
    y = x * 2 + 1
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    T.clear()
    with T.recording():
        with torch.cuda.graph(g):
            with T.span("captured"):
                z = x * 2 + 1
        x.add_(1)
        with T.span("replayed"):
            g.replay()
    captured, replayed = T.spans()
    assert captured.name == "captured" and captured.dev_start_ns is None
    assert replayed.name == "replayed" and isinstance(replayed.dev_start_ns, int)
    assert torch.equal(z, y + 2)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", CARD_KINDS)
def test_outputs_bit_equal_off_traced_and_recording(card_kit, kind):
    """A step's outputs are the same bits with tracing off, under the
    profiler, inside recording() (events recorded) and under both."""
    fn, inputs = card_kit[kind]
    off = fn(*inputs)
    traced, _ = _traced_on_card(fn, inputs)
    recorded, kept = _recorded(lambda: fn(*inputs))
    both, _ = _traced_on_card(fn, inputs, recording=True)
    assert kept and all(isinstance(s.dev_end_ns, int) for s in kept)
    for a, b, c, d in zip(off, traced, recorded, both):
        assert a.dtype == b.dtype == c.dtype == d.dtype
        assert torch.equal(a, b) and torch.equal(a, c) and torch.equal(a, d)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", CARD_KINDS)
def test_steps_inside_recording_never_wait_for_the_device(card_kit, kind):
    """Inside recording() a step still makes no call that waits for the
    device: the spans' events are recorded, not waited for, until spans()
    is read after the step."""
    fn, inputs = card_kit[kind]
    staged, syncs = sum(T.STAGED.values()), sum(T.SYNCS.values())
    T.clear()
    with T.recording():
        _sync_debug_error(fn, *inputs)
    assert sum(T.STAGED.values()) - staged == CARD_KINDS[kind]
    assert sum(T.SYNCS.values()) == syncs
    assert T.spans() and all(isinstance(s.dev_end_ns, int) for s in T.spans())
