"""Spans and counters of the port's served steps.

Spans. ``span(name)`` marks one layer of a step (``ensemble_step``,
``sparse_view``, ``qpp``, ``fusion.combine``, ...). Spans are kept while a
``torch.profiler`` session records, and inside ``recording()``: a kept span
(name, enclosing span, host start and end from ``time.perf_counter_ns``)
goes into a bounded buffer that ``spans()`` reads and ``clear()`` empties.
Under the profiler a span also enters ``torch.profiler.record_function``
(name), so it lands in the trace; inside ``recording()`` alone it enters
none, and costs no profiler. With neither, ``span`` costs one flag check
and returns one shared no-op context: the port has no other switch for
tracing.

Device intervals. Inside ``recording()``, where the CUDA runtime is
initialized and the current stream is not capturing a graph, a kept span
records one CUDA event on the current stream as it opens and one as it
closes (inside its ``record_function`` where the profiler records too).
The kernels and graph replays of the span run on that stream, so the two
events bracket the span's device work in stream order. ``spans()`` waits
once for the last recorded event and puts every event on the host fields'
clock through one anchor: an event recorded on an idle stream, waited for,
and the host time read as it completes. A span's ``dev_start_ns`` and
``dev_end_ns`` are then the host-clock times at which the device reached
its two events (None on the CPU, before CUDA is initialized, under the
profiler alone, or where a graph capture took the place of an event). Read
``spans()`` between steps: the wait would stall one. The events come from
a pool of this module's own, which grows only while spans are kept;
``spans()`` and ``clear()`` return them to it. One card: the events are
the current device's.

Under the profiler alone a span records no event: the trace holds the
device times already, and two event records a span would add to the
traced host's work, and so to the traced idle, what they cost under the
profiler's CUDA tracing. The trace reads another clock: kineto's
``start_ns`` is the wall clock (``time.time_ns``), not ``perf_counter_ns``.
``trace_offset_ns()``, read once, takes a trace time onto the spans'
clock (subtract it). A span reads the host clock as its annotation has
begun, before its event is recorded.

An operator reads a serving process's layer timeline without the
profiler's launch cost so::

    with tracing.recording():
        for batch in batches:
            serve(batch)
    timeline = tracing.spans()      # between steps, then tracing.clear()

Where the host leads (``dev_start_ns - start_ns`` of a span large), the
card works through queued work; where the lead is near zero, the card waits
for the host. Graphs are not captured while spans are kept, in either mode
(``ops/graphs.py``): warm a signature up first.

Counters, always on (plain integer adds):
  LAUNCHES   kernel launches by kernel name; each wrapper under
             ``ops/kernels`` adds one where it launches its kernel;
  K2_CLUSTERS  K2 (``bitonic_segsum_rows``) launches by the CTAs that
             sort one row: 1 up to 16,384 keys, else the padded row over
             16,384 (a cluster of 2 or 4);
  STAGED     host -> CUDA moves by site that went through pinned
             staging (``to_device``) and did not wait;
  SYNCS      blocking host <-> device moves and reads by site;
  REPLAYS    CUDA-graph replays by site (``ops/graphs.py``: ``qpp``,
             ``fusion``), each in span ``<site>.graph``;
  CAPTURES   CUDA-graph captures by site, failed ones included.

A move from host memory to a CUDA device is copied on the host into a
page-locked block of PyTorch's caching host allocator and sent with
non_blocking=True on the current stream, so the host does not wait for
the work queued before it; stream order keeps each consumer after its
copy, and the allocator does not hand the block out again before the copy
has landed. A blocking move or read runs inside span ``sync.<site>``,
whose host duration is the time the host waited.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import Counter, deque
from typing import NamedTuple, Optional

import torch

LAUNCHES: Counter = Counter()
K2_CLUSTERS: Counter = Counter()
STAGED: Counter = Counter()
SYNCS: Counter = Counter()
REPLAYS: Counter = Counter()
CAPTURES: Counter = Counter()

SYNC = "sync."              # span-name prefix of a blocking move
MAX_SPANS = 1 << 16         # spans kept; the oldest go first

_profiling = torch._C._autograd._profiler_enabled
_recording = _profiling     # true while spans are kept: recording() swaps it
_keeping = 0                # recording() contexts open
_pending = False            # a kept span's events are not on the host clock yet
_OFF = contextlib.nullcontext()
_KEPT: deque = deque(maxlen=MAX_SPANS)
_OPEN = threading.local()
_POOL: list = []            # CUDA events free for the next span
_IDLE: list = []            # the anchor's stream, which nothing else uses
_STREAMS: dict = {}         # torch.cuda.Stream by (stream id, device, type)


class Span(NamedTuple):
    """One finished span: its name, the name of the span open around it
    when it began (None at the top), its host start and end in ns, and the
    host-clock times in ns at which the device reached its opening and
    closing events (None where no event was recorded)."""
    name: str
    parent: Optional[str]
    start_ns: int
    end_ns: int
    dev_start_ns: Optional[int] = None
    dev_end_ns: Optional[int] = None


def _always() -> bool:
    return True


@contextlib.contextmanager
def recording():
    """Keep spans, with their host times and device intervals, inside the
    block, without the profiler: no span enters record_function. Process
    wide; contexts nest. ``_recording()`` is true inside, as it is while a
    torch.profiler session records."""
    global _keeping, _recording
    _keeping += 1
    _recording = _always
    try:
        yield
    finally:
        _keeping -= 1
        if not _keeping:
            _recording = _profiling


def _stack() -> list:
    stack = getattr(_OPEN, "stack", None)
    if stack is None:
        stack = _OPEN.stack = []
    return stack


def _event():
    return _POOL.pop() if _POOL else torch.cuda.Event(enable_timing=True)


def _current_stream():
    """torch.cuda.current_stream(), without building a Stream each call."""
    key = torch._C._cuda_getCurrentStream(torch._C._cuda_getDevice())
    stream = _STREAMS.get(key)
    if stream is None:
        stream = _STREAMS[key] = torch.cuda.Stream(
            stream_id=key[0], device_index=key[1], device_type=key[2])
    return stream


def _mark():
    """-> a pooled CUDA event recorded on the current stream, or None where
    the CUDA runtime is not initialized or the stream is capturing a graph."""
    if not torch.cuda.is_initialized() or torch.cuda.is_current_stream_capturing():
        return None
    ev = _event()
    ev.record(_current_stream())
    return ev


class _Kept:
    """A span while spans are kept: a record_function annotation under the
    profiler, an event at each end inside recording(), and a Span kept
    when it ends."""
    __slots__ = ("name", "annotate", "parent", "start", "annotation", "opened")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        self.annotate = _profiling()
        if self.annotate:
            self.annotation = torch.profiler.record_function(self.name)
            self.annotation.__enter__()
        self.start = time.perf_counter_ns()
        self.opened = _mark() if _keeping else None
        return self

    def __exit__(self, *exc):
        global _pending
        end = time.perf_counter_ns()
        opened, closed = self.opened, None
        if opened is not None:
            closed = _mark()
            if closed is None:              # a graph capture began inside the span
                _POOL.append(opened)
                opened = None
            else:
                _pending = True
        if self.annotate:
            self.annotation.__exit__(*exc)
        _stack().pop()
        _KEPT.append(Span(self.name, self.parent, self.start, end, opened, closed))
        return False


def span(name: str):
    """-> a context that marks `name` while spans are kept (a torch.profiler
    session records, or inside recording()), else the shared no-op
    context."""
    if not _recording():
        return _OFF
    return _Kept(name)


def _unresolved(s: Span) -> bool:
    return s.dev_end_ns is not None and not isinstance(s.dev_end_ns, int)


def _anchor():
    """-> (host ns, event): an event recorded on an idle stream and waited
    for, and the host time read as it completes."""
    if not _IDLE:
        _IDLE.append(torch.cuda.Stream())
    ev = _event()
    ev.record(_IDLE[0])
    ev.synchronize()
    return time.perf_counter_ns(), ev


def _resolve() -> None:
    """Put the kept spans' events on the host clock and return them to the
    pool: wait for the last one, then walk back from the anchor, each event
    by the device time to the one recorded after it."""
    global _pending
    kept = list(_KEPT)
    marks = sorted([(s.start_ns, s.dev_start_ns) for s in kept if _unresolved(s)]
                   + [(s.end_ns, s.dev_end_ns) for s in kept if _unresolved(s)],
                   key=lambda m: m[0])
    events = [ev for _, ev in marks]
    if events:
        for ev in reversed(events):         # one wait: the rest are done by then
            ev.synchronize()
        host_ns, anchor = _anchor()
        at, back_ms, later = {}, 0.0, anchor
        for ev in reversed(events):
            back_ms += ev.elapsed_time(later)
            at[id(ev)] = host_ns - round(back_ms * 1e6)
            later = ev
        _KEPT.clear()
        _KEPT.extend(s._replace(dev_start_ns=at[id(s.dev_start_ns)],
                                dev_end_ns=at[id(s.dev_end_ns)]) if _unresolved(s) else s
                     for s in kept)
        _POOL.extend(events)
        _POOL.append(anchor)
    _pending = False


def spans() -> tuple:
    """The kept spans, oldest first by end time: a tuple of Span, with their
    device intervals on the host clock."""
    if _pending:
        _resolve()
    return tuple(_KEPT)


def clear() -> None:
    """Drop every kept span; their events go back to the pool."""
    global _pending
    for s in _KEPT:
        if _unresolved(s):
            _POOL.extend((s.dev_start_ns, s.dev_end_ns))
    _KEPT.clear()
    _pending = False


def trace_offset_ns() -> int:
    """The profiler trace's clock (kineto's start_ns: the wall clock, as
    time.time_ns) less the spans' clock (time.perf_counter_ns), read now:
    a trace time less this offset is a time on the spans' clock."""
    before = time.perf_counter_ns()
    wall = time.time_ns()
    return wall - (before + time.perf_counter_ns()) // 2


def host_sync(site: str):
    """Count one blocking device read at `site` (the caller's next statement
    waits for the device) -> the span ``sync.<site>`` to run it in."""
    SYNCS[site] += 1
    return span(SYNC + site)


def blocking_move(x, device) -> bool:
    """True where ``torch.as_tensor(x, device=device)`` blocks the host:
    x is a tensor on a CUDA device and device is the CPU, so the copy waits
    for the stream. A move from host memory to a CUDA device is staged
    (staged_move) and does not block."""
    return (isinstance(x, torch.Tensor) and x.device.type == "cuda"
            and torch.device(device).type == "cpu")


def staged_move(x, device) -> bool:
    """True where to_device stages x through pinned memory: x lies in host
    memory (a CPU tensor, a numpy array or a Python number) and device is a
    CUDA device."""
    if torch.device(device).type != "cuda":
        return False
    return not isinstance(x, torch.Tensor) or x.device.type == "cpu"


def to_device(x, device, dtype: Optional[torch.dtype], site: str) -> torch.Tensor:
    """``torch.as_tensor(x, device=device)``, then ``.to(dtype)`` where
    dtype is given. A staged move (staged_move) copies x into pinned host
    memory and from there to the device with non_blocking=True, and adds
    one to STAGED[site]; x may be overwritten as soon as this returns. A
    tensor that is pinned already is sent as it is, and its owner keeps it
    unchanged until the stream has passed the copy. A blocking move (blocking_move) adds one to
    SYNCS[site] and runs inside span ``sync.<site>``; any other move
    counts nothing."""
    if staged_move(x, device):
        t = torch.as_tensor(x)
        if not t.is_pinned():
            t = t.pin_memory()
        t = t.to(device, non_blocking=True)
        STAGED[site] += 1
    elif blocking_move(x, device):
        SYNCS[site] += 1
        with span(SYNC + site):
            t = torch.as_tensor(x, device=device)
    else:
        t = torch.as_tensor(x, device=device)
    return t if dtype is None else t.to(dtype)
