"""CUDA graphs of the QPP and fusion tail.

``ops/qpp.py:qpp_kernel`` and ``ops/fusion.py:fuse_kernel`` are each a few
hundred small kernels (the QPP mean's dependent adds, the blocked prefix
sums, the fusion's sorts and scans) with about 1 ms of device work between
them a step; launched one by one from eager PyTorch, their dispatch costs
the host several times that. ``replay_or_run`` captures such a function
once per call signature as a CUDA graph and replays it after, one launch
in place of hundreds.

A call engages the cache only where the call itself shows that a graph can
serve it: every tensor on one CUDA device, none requiring grad, and no
stream capture in progress. Anything else, the CPU above all, runs ``fn``
as it is. The first sighting of a signature runs eagerly and is the
capture's warm-up, so a shape seen once never pays a capture. The second
captures into the graph's own memory pool (never while spans are kept,
under a torch.profiler session or ``tracing.recording()``: that call runs
eagerly), then replays. Later sightings
copy the inputs into the graph's static inputs, replay it on the current
stream and return clones of its static outputs, so a result held by the
caller outlives the next replay. A capture that raises marks its signature
eager for good. A replay runs the captured kernels in the eager order on
the same layouts, so its outputs are the eager route's bits. Each site
keeps the MAX_KEYS signatures it used last. The cache assumes one host
thread drives the card, as the served steps do: while a capture runs, CUDA
refuses calls that would wait for a device from every thread.

Counters (``tracing.py``): ``REPLAYS[site]`` counts replays,
``CAPTURES[site]`` captures, failed ones included. A replay runs in span
``<site>.graph``.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, Sequence

import torch

from qpp_fusion_rag_tpu_torch import tracing as T

MAX_KEYS = 8                # signatures kept per site; the least recently used go first
SEEN, EAGER = "seen", "eager"   # a signature's state before a capture, and where none serves

_SITES: Dict[str, OrderedDict] = {}


class Graph:
    """One captured call: the CUDA graph, the static inputs it reads and
    the static outputs it writes."""
    __slots__ = ("graph", "inputs", "outputs", "single")

    def replay(self, tensors: Sequence[torch.Tensor]):
        """Copy `tensors` into the static inputs, replay on the current
        stream -> clones of the outputs, as the captured function returned
        them (one tensor or a tuple)."""
        for static, t in zip(self.inputs, tensors):
            static.copy_(t)
        self.graph.replay()
        out = tuple(o.clone() for o in self.outputs)
        return out[0] if self.single else out


def signature(site: str, tensors: Sequence[torch.Tensor], static: dict) -> tuple:
    """The cache key: the site, each tensor's shape, strides, dtype and
    device, and the static arguments."""
    return (site,
            tuple((tuple(t.shape), t.stride(), t.dtype, t.device) for t in tensors),
            tuple(sorted(static.items())))


def engages(tensors: Sequence) -> bool:
    """True where a graph can serve the call: every argument a tensor on
    one CUDA device, none requiring grad, and no stream capture running."""
    if not tensors or not all(isinstance(t, torch.Tensor) for t in tensors):
        return False
    dev = tensors[0].device
    return (dev.type == "cuda"
            and all(t.device == dev and not t.requires_grad for t in tensors)
            and not torch.cuda.is_current_stream_capturing())


def capture(fn: Callable, tensors: Sequence[torch.Tensor], static: dict) -> Graph:
    """fn(*copies of tensors, **static) captured into a new CUDA graph with
    its own memory pool; nothing runs until a replay."""
    g = Graph()
    g.inputs = tuple(t.clone() for t in tensors)
    g.graph = torch.cuda.CUDAGraph()
    with torch.cuda.device(tensors[0].device), torch.cuda.graph(g.graph):
        out = fn(*g.inputs, **static)
    g.single = isinstance(out, torch.Tensor)
    g.outputs = (out,) if g.single else tuple(out)
    return g


def _remember(cache: OrderedDict, key: tuple, state) -> None:
    cache[key] = state
    cache.move_to_end(key)
    while len(cache) > MAX_KEYS:
        cache.popitem(last=False)


def replay_or_run(site: str, fn: Callable, tensors: Sequence, static: dict):
    """fn(*tensors, **static), from the site's graph for this signature
    where one serves it (see the module's docstring), else eagerly."""
    if not engages(tensors):
        return fn(*tensors, **static)
    cache = _SITES.setdefault(site, OrderedDict())
    key = signature(site, tensors, static)
    state = cache.get(key)
    if state is SEEN and not T._recording():
        T.CAPTURES[site] += 1
        try:
            state = capture(fn, tensors, static)
        except RuntimeError:
            state = EAGER
    if not isinstance(state, Graph):
        _remember(cache, key, state or SEEN)
        return fn(*tensors, **static)
    _remember(cache, key, state)
    T.REPLAYS[site] += 1
    with T.span(site + ".graph"):
        return state.replay(tensors)
