"""The CUDA graphs of the QPP and fusion tail (qpp_fusion_rag_tpu_torch/
ops/graphs.py): which calls engage them, their keys and bound, the
capture-then-replay order, and on the card that a replay gives the eager
route's bits. CPU tensors never reach a capture; the CPU tests that follow
the cache's states stand a host replay in for the card's graph. The tests
marked cuda skip without a card:

    python -m pytest --noconftest -m cuda tests/test_torch_graphs.py

The file imports no JAX."""

from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from qpp_fusion_rag_tpu_torch import tracing as T
from qpp_fusion_rag_tpu_torch.ops import fusion as F
from qpp_fusion_rag_tpu_torch.ops import graphs as G
from qpp_fusion_rag_tpu_torch.ops import qpp as Q

METHODS = [F.COMBSUM, F.COMBMNZ, F.RRF]


def _runs(seed, R=5, B=24, K=32, device="cpu"):
    """Desc-sorted runs with tied scores, short rows and padding, ids from a
    small pool so docs repeat across runs -> (scores, n_valid, text_feats,
    ids, weights) as the tail takes them."""
    rng = np.random.default_rng(seed)
    vals = np.sort(rng.integers(0, 30, (R, B, K)).astype(np.float32)
                   * np.float32(0.37), axis=-1)[..., ::-1].copy()
    n_valid = rng.integers(4, K + 1, (R, B))
    n_valid[0, :4] = [0, 1, 2, 3]
    ids = np.stack([np.stack([rng.permutation(4 * K)[:K] for _ in range(B)])
                    for _ in range(R)]).astype(np.int32)
    pad = np.arange(K) >= n_valid[..., None]
    ids[pad] = -1
    vals[pad] = -np.inf
    tf = np.column_stack([rng.integers(1, 9, B), rng.integers(1, 9, B),
                          rng.integers(1, 12, B), rng.uniform(1, 8, B)]).astype(np.float32)
    w = rng.uniform(0.1, 1.0, (R, B)).astype(np.float32)
    clean = np.where(ids >= 0, vals, 0.0).astype(np.float32)
    out = (clean, n_valid.astype(np.int32), tf, ids, vals, w)
    return tuple(torch.from_numpy(a).to(device) for a in out)


def _qpp(run, cutoff=50):
    clean, n_valid, tf = run[:3]
    return Q.qpp_kernel(clean, n_valid, tf, cutoff=cutoff)


def _fuse(run, method=F.COMBSUM, minmax_norm=True, k_out=40):
    ids, vals, w = run[3:]
    return F.fuse_kernel(ids, vals, w, method=method, minmax_norm=minmax_norm, k_out=k_out)


def _eager_qpp(run, cutoff=50):
    clean, n_valid, tf = run[:3]
    return Q.qpp_statistics(clean, n_valid, tf, cutoff=cutoff)


def _eager_fuse(run, method=F.COMBSUM, minmax_norm=True, k_out=40):
    ids, vals, w = run[3:]
    return F.fuse_eager(ids, vals, w, method=method, minmax_norm=minmax_norm, k_out=k_out)


def _equal(a, b):
    a = (a,) if isinstance(a, torch.Tensor) else tuple(a)
    b = (b,) if isinstance(b, torch.Tensor) else tuple(b)
    return len(a) == len(b) and all(x.dtype == y.dtype and torch.equal(x, y)
                                    for x, y in zip(a, b))


@pytest.fixture
def fresh(monkeypatch):
    """An empty cache and zeroed counters for the test, the process's own
    left as they were."""
    monkeypatch.setattr(G, "_SITES", {})
    monkeypatch.setattr(T, "REPLAYS", Counter())
    monkeypatch.setattr(T, "CAPTURES", Counter())


# ---------------------------------------------------------------- on the CPU

def test_cpu_calls_never_reach_capture(monkeypatch):
    """CPU tensors run the eager route every time: no capture is tried, no
    signature is kept, and REPLAYS / CAPTURES stay at zero."""
    def refuse(*args):
        raise AssertionError("a CPU call reached capture")

    monkeypatch.setattr(G, "capture", refuse)
    run = _runs(0)
    for _ in range(3):
        assert _equal(_qpp(run), _eager_qpp(run))
        for method in METHODS:
            assert _equal(_fuse(run, method), _eager_fuse(run, method))
    assert not any(G._SITES.get(site) for site in ("qpp", "fusion"))
    assert T.REPLAYS["qpp"] == T.REPLAYS["fusion"] == 0
    assert T.CAPTURES["qpp"] == T.CAPTURES["fusion"] == 0


def test_engages_only_cuda_tensors():
    cpu = torch.zeros(3)
    assert not G.engages((cpu, cpu))
    assert not G.engages((torch.zeros(3, device="meta"),))
    assert not G.engages(())
    assert not G.engages((cpu, 3))


def _key(site="qpp", shape=(5, 8, 16), dtype=torch.float32, static=None, t=False,
         device="cpu"):
    x = torch.zeros(shape, dtype=dtype, device=device)
    if t:
        x = x.transpose(-1, -2)
    n = torch.zeros(shape[:-1], dtype=torch.int32, device=device)
    return G.signature(site, (x, n), {"cutoff": 50} if static is None else static)


@pytest.mark.parametrize("change", [
    {"shape": (5, 8, 17)}, {"shape": (4, 8, 16)}, {"dtype": torch.float64},
    {"static": {"cutoff": 10}}, {"static": {"cutoff": 50, "k_out": 100}},
    {"site": "fusion"}, {"t": True}, {"device": "meta"}])
def test_keys_differ_with_each_shape_dtype_layout_and_static_argument(change):
    assert _key(**change) != _key()
    assert _key(**change) == _key(**change)       # equal calls, equal keys


def test_keys_are_equal_for_equal_calls():
    assert _key() == _key()
    assert hash(_key()) == hash(_key())
    assert (G.signature("fusion", (torch.ones(2, 3),), {"method": 0, "k_out": 4})
            == G.signature("fusion", (torch.zeros(2, 3),), {"k_out": 4, "method": 0}))


class _HostGraph:
    """Stands in for torch.cuda.CUDAGraph on the CPU: replay() runs the
    captured function again on the static inputs and writes its results
    into the static outputs, as a graph does."""

    def __init__(self, fn, inputs, static, outputs):
        self.fn, self.inputs, self.static, self.outputs = fn, inputs, static, outputs

    def replay(self):
        out = self.fn(*self.inputs, **self.static)
        for o, n in zip(self.outputs, (out,) if isinstance(out, torch.Tensor) else out):
            o.copy_(n)


def _host_capture(fn, tensors, static):
    g = G.Graph()
    g.inputs = tuple(t.clone() for t in tensors)
    out = fn(*g.inputs, **static)
    g.single = isinstance(out, torch.Tensor)
    g.outputs = (out,) if g.single else tuple(out)
    g.graph = _HostGraph(fn, g.inputs, static, g.outputs)
    return g


@pytest.fixture
def host_graphs(fresh, monkeypatch):
    """CPU calls engage the cache, and a capture makes a _HostGraph. ->
    the list of (site's function name) each capture was asked for."""
    asked = []

    def capture(fn, tensors, static):
        asked.append(fn.__name__)
        return _host_capture(fn, tensors, static)

    monkeypatch.setattr(G, "engages", lambda tensors: True)
    monkeypatch.setattr(G, "capture", capture)
    return asked


def test_first_sighting_runs_eagerly_the_second_captures_then_replays(host_graphs):
    run = _runs(1)
    want_q, want_f = _eager_qpp(run), _eager_fuse(run)
    counts = []
    for _ in range(4):
        assert _equal(_qpp(run), want_q) and _equal(_fuse(run), want_f)
        counts.append((T.CAPTURES["qpp"], T.REPLAYS["qpp"],
                       T.CAPTURES["fusion"], T.REPLAYS["fusion"]))
    assert counts == [(0, 0, 0, 0), (1, 1, 1, 1), (1, 2, 1, 2), (1, 3, 1, 3)]
    assert host_graphs == ["qpp_statistics", "fuse_eager"]


def test_replay_reads_new_inputs_and_returns_unaliased_outputs(host_graphs):
    a, b = _runs(2), _runs(3)
    for _ in range(2):
        _qpp(a), _fuse(a)
    held_q, held_f = _qpp(a), _fuse(a)
    copies = held_q.clone(), tuple(t.clone() for t in held_f)
    assert _equal(_qpp(b), _eager_qpp(b)) and _equal(_fuse(b), _eager_fuse(b))
    assert _equal(held_q, copies[0]) and _equal(held_f, copies[1])
    assert not _equal(held_q, _eager_qpp(b))
    assert T.CAPTURES["qpp"] == 1 and T.REPLAYS["qpp"] == 3


def test_no_capture_while_the_profiler_records(host_graphs):
    """A sighting while torch.profiler records is counted but captures
    nothing; the next call outside it captures. A replay under the
    profiler runs in span <site>.graph (the host stand-in runs the eager
    sub-spans inside it; the card's graph opens none)."""
    run = _runs(4)
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            assert _equal(_qpp(run), _eager_qpp(run))
    assert host_graphs == [] and T.CAPTURES["qpp"] == 0
    _qpp(run)
    assert host_graphs == ["qpp_statistics"]
    want = _eager_qpp(run)
    T.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        got = _qpp(run)
    assert _equal(got, want)
    assert [s.name for s in T.spans() if s.parent is None] == ["qpp.graph"]


def test_a_failed_capture_leaves_its_signature_eager_for_good(fresh, monkeypatch):
    def fail(fn, tensors, static):
        raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setattr(G, "engages", lambda tensors: True)
    monkeypatch.setattr(G, "capture", fail)
    run = _runs(5)
    for _ in range(4):
        assert _equal(_qpp(run), _eager_qpp(run))
    assert T.CAPTURES["qpp"] == 1 and T.REPLAYS["qpp"] == 0
    assert list(G._SITES["qpp"].values()) == [G.EAGER]


def test_the_cache_evicts_beyond_its_bound(host_graphs):
    """Each site keeps MAX_KEYS signatures, the least recently used leaving
    first: an evicted signature is a first sighting again."""
    runs = [_runs(6, B=4 + i) for i in range(G.MAX_KEYS + 1)]
    for run in runs[:G.MAX_KEYS]:
        _qpp(run), _qpp(run)                       # seen, then captured
    assert len(G._SITES["qpp"]) == G.MAX_KEYS and T.CAPTURES["qpp"] == G.MAX_KEYS
    _qpp(runs[0])                                   # used: now the most recent
    _qpp(runs[-1])                                  # a new key evicts runs[1]'s
    assert len(G._SITES["qpp"]) == G.MAX_KEYS
    replays = T.REPLAYS["qpp"]
    _qpp(runs[0])
    assert T.REPLAYS["qpp"] == replays + 1          # kept
    _qpp(runs[1])
    assert T.REPLAYS["qpp"] == replays + 1          # evicted: seen again, eager
    assert T.CAPTURES["qpp"] == G.MAX_KEYS
    assert len(G._SITES["qpp"]) == G.MAX_KEYS and "fusion" not in G._SITES


# -------------------------------------------------------------- on the card
# On the card: python -m pytest --noconftest -m cuda tests/test_torch_graphs.py

SHAPES = {"small": dict(R=5, B=24, K=32), "cells": dict(R=5, B=1024, K=100)}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs capture on a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("cutoff", [50, 10])
def test_qpp_replay_equals_the_eager_route(card, fresh, shape, cutoff):
    """First sighting, capture, replay: each call gives the eager bits."""
    run = _runs(10, device=card, **SHAPES[shape])
    want = _eager_qpp(run, cutoff)
    for _ in range(3):
        assert _equal(_qpp(run, cutoff), want)
    assert (T.CAPTURES["qpp"], T.REPLAYS["qpp"]) == (1, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("minmax_norm", [True, False])
def test_fusion_replay_equals_the_eager_route(card, fresh, shape, method, minmax_norm):
    run = _runs(11, device=card, **SHAPES[shape])
    k_out = min(100, run[3].shape[0] * run[3].shape[2])
    want = _eager_fuse(run, method, minmax_norm, k_out)
    for _ in range(3):
        assert _equal(_fuse(run, method, minmax_norm, k_out), want)
    assert (T.CAPTURES["fusion"], T.REPLAYS["fusion"]) == (1, 2)


@pytest.mark.cuda
def test_replays_read_changed_inputs_and_keep_held_outputs(card, fresh):
    """Two input sets of one shape in turns: every replay gives the eager
    bits of its own inputs (a stale static input would not), and an output
    held from one call is the same after the next (no aliasing)."""
    a, b = _runs(12, device=card), _runs(13, device=card)
    want = {id(a): (_eager_qpp(a), _eager_fuse(a)), id(b): (_eager_qpp(b), _eager_fuse(b))}
    assert not _equal(want[id(a)][0], want[id(b)][0])
    held = []
    for run in (a, b, a, b, a, b):
        q, f = _qpp(run), _fuse(run)
        assert _equal(q, want[id(run)][0]) and _equal(f, want[id(run)][1])
        held.append((run, q, f))
    torch.cuda.synchronize()
    for run, q, f in held:
        assert _equal(q, want[id(run)][0]) and _equal(f, want[id(run)][1])
    assert T.CAPTURES == Counter({"qpp": 1, "fusion": 1})
    assert T.REPLAYS == Counter({"qpp": 5, "fusion": 5})


@pytest.mark.cuda
def test_inputs_that_require_grad_stay_eager(card, fresh):
    run = list(_runs(14, device=card))
    run[0] = run[0].clone().requires_grad_(True)
    run[5] = run[5].clone().requires_grad_(True)
    for _ in range(3):
        q, f = _qpp(run), _fuse(run)
        assert q.requires_grad and f[1].requires_grad
    assert not G._SITES and sum(T.CAPTURES.values()) == sum(T.REPLAYS.values()) == 0


@pytest.mark.cuda
def test_no_capture_under_a_recording_profiler(card, fresh):
    run = _runs(15, device=card)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for _ in range(3):
            assert _equal(_qpp(run), _eager_qpp(run))
            assert _equal(_fuse(run), _eager_fuse(run))
        torch.cuda.synchronize()
    assert sum(T.CAPTURES.values()) == sum(T.REPLAYS.values()) == 0
    assert _equal(_qpp(run), _eager_qpp(run)) and _equal(_fuse(run), _eager_fuse(run))
    assert T.CAPTURES == Counter({"qpp": 1, "fusion": 1})
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        assert _equal(_qpp(run), _eager_qpp(run)) and _equal(_fuse(run), _eager_fuse(run))
        torch.cuda.synchronize()
    assert T.CAPTURES == Counter({"qpp": 1, "fusion": 1})
    assert T.REPLAYS == Counter({"qpp": 2, "fusion": 2})


@pytest.mark.cuda
def test_no_capture_inside_recording(card, fresh):
    """recording() keeps spans as the profiler does, so no signature is
    captured inside it either; after it, the second sighting captures."""
    run = _runs(15, device=card)
    with T.recording():
        for _ in range(3):
            assert _equal(_qpp(run), _eager_qpp(run))
            assert _equal(_fuse(run), _eager_fuse(run))
    assert sum(T.CAPTURES.values()) == sum(T.REPLAYS.values()) == 0
    assert _equal(_qpp(run), _eager_qpp(run)) and _equal(_fuse(run), _eager_fuse(run))
    assert T.CAPTURES == Counter({"qpp": 1, "fusion": 1})
    T.spans()
    T.clear()


@pytest.fixture(scope="module")
def step_kit(card):
    """The served steps of test_torch_tracing on the card: the q8
    ensemble and the flagship on every route."""
    from test_torch_tracing import _kit

    return _kit(card, routes=("int8", "bf16", "plain"))


STEP_KINDS = ["ensemble", "flagship", "flagship.bf16", "flagship.plain"]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", STEP_KINDS)
def test_served_steps_replay_once_a_step_with_the_eager_bits(step_kit, fresh, kind,
                                                              monkeypatch):
    """After warm-up a served step replays each of the two graphs once and
    captures nothing, and its outputs are the bits of the step with the
    cache bypassed."""
    fn, inputs = step_kit[kind]
    for _ in range(2):
        fn(*inputs)
    assert T.CAPTURES == Counter({"qpp": 1, "fusion": 1})
    for n in range(1, 4):
        got = fn(*inputs)
        assert T.REPLAYS == Counter({"qpp": 1 + n, "fusion": 1 + n})
    assert T.CAPTURES == Counter({"qpp": 1, "fusion": 1})
    monkeypatch.setattr(G, "replay_or_run", lambda site, fn, tensors, static:
                        fn(*tensors, **static))
    want = fn(*inputs)
    assert T.REPLAYS == Counter({"qpp": 4, "fusion": 4})
    assert _equal(got, want)


@pytest.mark.cuda
def test_a_capture_that_raises_runs_eagerly_and_the_card_goes_on(card, fresh):
    """A function that waits for the device cannot be captured: the capture
    raises, the call runs eagerly, the signature stays eager, and the card
    keeps working."""
    x = torch.arange(6.0, device=card)

    def waits(t):
        return t * float(t.sum().item())

    for _ in range(3):
        assert torch.equal(G.replay_or_run("waits", waits, (x,), {}), x * 15.0)
    assert T.CAPTURES["waits"] == 1 and T.REPLAYS["waits"] == 0
    assert list(G._SITES["waits"].values()) == [G.EAGER]
    run = _runs(16, device=card)
    assert _equal(_qpp(run), _eager_qpp(run))
    torch.cuda.synchronize()
