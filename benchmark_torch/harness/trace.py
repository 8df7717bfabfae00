"""The traced run: spans wrapped around the program's layers from the
benchmark's own files, one torch.profiler window over a steady stretch of
steps, and the summary that the per-layer metric readers take.

Spans: spans/<kind>.json lists {"name", "target": "module:attribute"}; the
attribute is replaced, for the traced stretch only, by a wrapper that runs
it inside ``torch.profiler.record_function(name)``. With "wrap": "result",
the attribute is a factory and the function it returns is wrapped instead.
The untraced run imports none of this.

Attribution: a device kernel belongs to the innermost span open on the
launching thread when its launch (the CUDA runtime or driver call with the
kernel's correlation id) began.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import re

DEVICE_ACTIVITY = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_ACTIVITY = ("cuda_runtime", "cuda_driver")
HOST_ACTIVITY = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
STEP = "step"
RUNTIME_NAME = re.compile(r"cu(da)?[A-Z]")
TOP = 10
NAME_CHARS = 160              # a kernel's name in the breakdown, cut to this


def _span(name: str, fn):
    from torch.profiler import record_function

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with record_function(name):
            return fn(*args, **kwargs)
    return wrapper


def _span_result(name: str, factory):
    @functools.wraps(factory)
    def wrapper(*args, **kwargs):
        return _span(name, factory(*args, **kwargs))
    return wrapper


@contextlib.contextmanager
def spans_wrapped(entries: list):
    """Wrap each entry's target for the duration of the block."""
    saved = []
    try:
        for e in entries:
            mod_name, attr = e["target"].split(":")
            mod = importlib.import_module(mod_name)
            orig = getattr(mod, attr)
            wrap = _span_result if e.get("wrap") == "result" else _span
            setattr(mod, attr, wrap(e["name"], orig))
            saved.append((mod, attr, orig))
        yield
    finally:
        for mod, attr, orig in reversed(saved):
            setattr(mod, attr, orig)


class Ev:
    """One profiler event, as the summary needs it (times in ns)."""
    __slots__ = ("name", "kind", "device", "start", "end", "tid", "corr", "linked")

    def __init__(self, name, kind, device, start, end, tid=0, corr=0, linked=0):
        self.name, self.kind, self.device = name, kind, device
        self.start, self.end, self.tid, self.corr, self.linked = start, end, tid, corr, linked


def _kind(e, device: bool, span_names) -> str:
    """The event's activity type, read from its name (kineto's events carry
    no activity type): a device event named like a span mirrors that span,
    "Memcpy" / "Memset" are copies and fills, any other is a kernel; on the
    host, a CUDA runtime or driver call is named cuda<Name> or cu<Name>."""
    name = e.name()
    annotation = getattr(e, "is_user_annotation", lambda: False)() or name in span_names
    if device:
        if annotation:
            return "gpu_user_annotation"
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        return "gpu_memset" if name.startswith("Memset") else "kernel"
    if annotation:
        return "user_annotation"
    return "cuda_runtime" if RUNTIME_NAME.match(name) else "cpu_op"


def events_of(prof, span_names) -> list:
    """-> [Ev] of a finished torch.profiler.profile."""
    names = set(span_names) | {STEP}
    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        device = str(e.device_type()).endswith("CUDA")
        out.append(Ev(e.name(), _kind(e, device, names), device, start,
                      start + e.duration_ns(), e.start_thread_id(), e.correlation_id(),
                      e.linked_correlation_id()))
    return out


def _innermost(nested: list, times: list) -> list:
    """nested: [Ev] on one thread, properly nested; times ascending.
    -> for each time, the stack of events open at it (outermost first)."""
    order = sorted(nested, key=lambda e: (e.start, -e.end))
    stack, out, i = [], [], 0
    for t in times:
        while i < len(order) and order[i].start <= t:
            while stack and stack[-1].end < order[i].start:
                stack.pop()
            stack.append(order[i])
            i += 1
        while stack and stack[-1].end < t:
            stack.pop()
        out.append([e for e in stack if e.end >= t])
    return out


def _union(intervals):
    """Sorted, merged [(start, end)]."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def summarize(events: list, span_names, cell: dict) -> dict:
    """Events of the traced stretch -> the summary the metric readers take:
    {"steps", "window_s", "busy_s", "kernel_count", "kernels": {name:
    {"calls", "device_s"}}, "spans": {name: {"device_s", "kernels"}},
    "idle_gaps": {label: seconds}, "cell"}."""
    steps = sorted((e for e in events if e.kind == "user_annotation" and e.name == STEP),
                   key=lambda e: e.start)
    if not steps:
        raise ValueError("no step spans in the trace")
    t0, t1, tid = steps[0].start, steps[-1].end, steps[0].tid
    ours = set(span_names) | {STEP}
    host = [e for e in events if not e.device and e.tid == tid and e.kind in HOST_ACTIVITY]
    spans = [e for e in host if e.kind == "user_annotation" and e.name in ours]
    launch_at = {e.corr: e for e in events if not e.device and e.kind in LAUNCH_ACTIVITY}
    by_corr = {e.corr: e for e in host if e.kind in ("cpu_op", "user_annotation")}

    device = sorted((e for e in events if e.device and e.kind in DEVICE_ACTIVITY
                     and e.end > t0 and e.start < t1), key=lambda e: e.start)
    kernels = [e for e in device if e.kind == "kernel"]
    launches = []
    for k in kernels:
        src = launch_at.get(k.corr) or by_corr.get(k.linked)
        launches.append(src.start if src is not None else k.start)
    order = sorted(range(len(kernels)), key=lambda j: launches[j])
    stacks = _innermost(spans, [launches[j] for j in order])
    by_kernel, by_span = {}, {}
    for j, stack in zip(order, stacks):
        k = kernels[j]
        dur = (k.end - k.start) * 1e-9
        rec = by_kernel.setdefault(k.name, {"calls": 0, "device_s": 0.0})
        rec["calls"] += 1
        rec["device_s"] += dur
        inner = [e.name for e in stack if e.name != STEP]
        label = inner[-1] if inner else (STEP if stack else None)
        if label is not None:
            srec = by_span.setdefault(label, {"device_s": 0.0, "kernels": 0})
            srec["device_s"] += dur
            srec["kernels"] += 1

    busy = _union((max(e.start, t0), min(e.end, t1)) for e in device)
    busy_ns = sum(b - a for a, b in busy)
    gaps, prev = [], t0
    for a, b in busy + [[t1, t1]]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    mids = [(a + b) / 2 for a, b in gaps]
    idle = {}
    for (a, b), stack in zip(gaps, _innermost(host, mids)):
        named = [e.name for e in stack if e.kind == "user_annotation" and e.name != STEP]
        ops = [e.name for e in stack if e.kind != "user_annotation"]
        label = " > ".join(x for x in (named[-1] if named else "", ops[-1] if ops else "") if x)
        label = label or ("between steps" if not stack else STEP)
        idle[label] = idle.get(label, 0.0) + (b - a) * 1e-9
    return {"steps": len(steps), "window_s": (t1 - t0) * 1e-9, "busy_s": busy_ns * 1e-9,
            "kernel_count": len(kernels), "kernels": by_kernel, "spans": by_span,
            "idle_gaps": idle, "cell": cell}


def breakdown(summary: dict) -> dict:
    """The ledger's view of a traced run: the device operations that took
    most time and the longest idle stretches by what the host was doing
    (seconds over the traced window)."""
    ops = sorted(((n[:NAME_CHARS], r["device_s"]) for n, r in summary["kernels"].items()),
                 key=lambda x: -x[1])[:TOP]
    gaps = sorted(summary["idle_gaps"].items(), key=lambda x: -x[1])[:TOP]
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [[n, s] for n, s in gaps]}


def kernel_time(summary: dict, pattern) -> tuple:
    """-> (calls, device seconds) of the kernels whose name matches the
    compiled regex `pattern`."""
    calls = secs = 0
    for name, r in summary["kernels"].items():
        if pattern.search(name):
            calls += r["calls"]
            secs += r["device_s"]
    return calls, secs


def span_ms_per_step(summary: dict, names) -> float | None:
    """Device ms per step inside the named spans; None if none ran."""
    found = [summary["spans"][n]["device_s"] for n in names if n in summary["spans"]]
    if not found:
        return None
    return sum(found) * 1e3 / summary["steps"]
