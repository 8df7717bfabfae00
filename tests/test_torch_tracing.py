"""The port's tracing module (qpp_fusion_rag_tpu_torch/tracing.py): spans
only while torch.profiler records, their names and nesting in the two
served steps as kept and as the profiler saw them, the counted moves, and
the one launch counter. CPU tensors throughout: the moves' device decision
is tested on its own, since a host -> CUDA move needs a card."""

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
STEP_SPANS = {"ensemble": "ensemble_step", "flagship": "flagship_step"}


@pytest.fixture(scope="module")
def steps():
    """-> {"ensemble": step(), "flagship": step()}: the q8 ensemble step over
    presorted BM25 / SPLADE postings (as the benchmark serves it) and the
    flagship on its int8 route, each over host-tensor query inputs."""
    arrays, inputs = {}, []
    for name, vocab, avg, seed, tq in (("bm25", 1500, 30.0, 0, 8),
                                       ("splade", 1000, 40.0, 7, 16)):
        off, docs, w, _ = zipf_bm25_csr(N, vocab_size=vocab, avg_doc_len=avg, seed=seed)
        scales = SP.term_scales_from_csr(w, off)
        packed, off2, sc = SP.pack_postings_presorted(docs, w, off, cap=CAP, scales=scales)
        arrays.update({f"{name}_packed": torch.from_numpy(packed),
                       f"{name}_offsets": torch.from_numpy(off2.astype(np.int32)),
                       f"{name}_scales": torch.from_numpy(sc)})
        qt, qw = zipf_queries(off, B, n_terms=tq, seed=seed + 1)
        inputs += [torch.from_numpy(qt), torch.from_numpy(qw)]
    rng = np.random.default_rng(0)
    rows, d_scale = quantize_rows(torch.from_numpy(rng.standard_normal((N, D), np.float32)))
    idx = EM.EnsembleIndexes(corpus_rows=rows, d_scale=d_scale.reshape(-1), **arrays)
    q = torch.from_numpy(rng.standard_normal((B, D), np.float32))
    rerank_proj = torch.from_numpy(rng.standard_normal((2, D, D), np.float32) * 0.05)
    view_proj = torch.from_numpy(rng.standard_normal((R, D, D), np.float32) * 0.05)
    tf = torch.tensor([[6.0, 6.0, 9.0, 5.0]]).repeat(B, 1)
    return {
        "ensemble": lambda: EM.ensemble_retrieval_step(
            idx, *inputs, q, rerank_proj, tf, k=K, k_out=K, p_cap=CAP, sparse_mode="q8",
            sparse_presorted=True),
        "flagship": lambda: EN.fused_retrieval_step(
            q, view_proj, rows, tf, k=K, k_out=K, corpus_scale=d_scale.reshape(-1)),
    }


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


@pytest.mark.parametrize("kind", ["ensemble", "flagship"])
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


def test_flagship_step_layers(steps):
    _, kept, _ = _traced(steps["flagship"])
    assert _children(kept, "flagship_step") == ["flagship_retrieval", "qpp", "minmax",
                                                "fusion"]
    assert _children(kept, "flagship_retrieval") == [
        "retrieve.project", "retrieve.group_max", "retrieve.merge"]
    assert _children(kept, "qpp") == ["qpp.mean", "qpp.moments", "qpp.prefix",
                                      "qpp.columns", "qpp_norm"]
    assert _children(kept, "fusion") == ["fusion.combine"]


@pytest.mark.parametrize("kind", ["ensemble", "flagship"])
def test_outputs_bit_equal_with_tracing_on_and_off(steps, kind):
    off = steps[kind]()
    on, _, _ = _traced(steps[kind])
    assert len(on) == len(off)
    for a, b in zip(on, off):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_blocking_move_is_host_memory_to_a_cuda_device():
    for x in (torch.zeros(3), np.zeros(3, np.float32), 2.5, np.int32(7)):
        assert T.blocking_move(x, "cuda")
        assert T.blocking_move(x, torch.device("cuda", 0))
        assert not T.blocking_move(x, "cpu")
        assert not T.blocking_move(x, torch.device("cpu"))


def test_to_device_counts_blocking_moves_only(monkeypatch):
    site = "test_site"
    x = torch.arange(6, dtype=torch.int32)
    before, nbytes = T.SYNCS[site], T.H2D_BYTES[site]
    y = T.to_device(x, "cpu", torch.float32, site)           # same device: nothing
    assert y.dtype == torch.float32 and torch.equal(y, x.float())
    assert (T.SYNCS[site], T.H2D_BYTES[site]) == (before, nbytes)

    monkeypatch.setattr(T, "blocking_move", lambda x, device: True)
    T.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        y = T.to_device(x, "cpu", None, site)
    assert y.dtype == torch.int32 and torch.equal(y, x)
    assert (T.SYNCS[site], T.H2D_BYTES[site]) == (before + 1, nbytes + 24)
    assert [s.name for s in T.spans()] == ["sync." + site]


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


def test_kept_spans_are_bounded(monkeypatch):
    monkeypatch.setattr(T, "_KEPT", T.deque(maxlen=3))
    with profile(activities=[ProfilerActivity.CPU]):
        for name in "abcde":
            with T.span(name):
                pass
    assert [s.name for s in T.spans()] == ["c", "d", "e"]
