"""Spans and counters of the port's served steps.

Spans. ``span(name)`` marks one layer of a step (``ensemble_step``,
``sparse_view``, ``qpp``, ``fusion.combine``, ...). Tracing is on exactly
while a ``torch.profiler`` session records: then a span enters
``torch.profiler.record_function(name)``, so it lands in the profiler's
trace on the same clock as the device's events, and it is also kept here
(name, enclosing span, host start and end from ``time.perf_counter_ns``)
in a bounded buffer that ``spans()`` reads and ``clear()`` empties. With
no profiler recording, ``span`` costs one flag check and returns one
shared no-op context: the port has no other switch for tracing.

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

_recording = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()
_KEPT: deque = deque(maxlen=MAX_SPANS)
_OPEN = threading.local()


class Span(NamedTuple):
    """One finished span: its name, the name of the span open around it
    when it began (None at the top), and its host start and end in ns."""
    name: str
    parent: Optional[str]
    start_ns: int
    end_ns: int


def _stack() -> list:
    stack = getattr(_OPEN, "stack", None)
    if stack is None:
        stack = _OPEN.stack = []
    return stack


class _Traced:
    """A span while the profiler records: a record_function annotation,
    and a Span kept when it ends."""
    __slots__ = ("name", "parent", "start", "annotation")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        self.annotation = torch.profiler.record_function(self.name)
        self.annotation.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self.annotation.__exit__(*exc)
        _stack().pop()
        _KEPT.append(Span(self.name, self.parent, self.start, end))
        return False


def span(name: str):
    """-> a context that marks `name` while a torch.profiler session
    records, else the shared no-op context."""
    if not _recording():
        return _OFF
    return _Traced(name)


def spans() -> tuple:
    """The kept spans, oldest first by end time: a tuple of Span."""
    return tuple(_KEPT)


def clear() -> None:
    """Drop every kept span."""
    _KEPT.clear()


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
