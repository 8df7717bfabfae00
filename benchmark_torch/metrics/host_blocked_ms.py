"""host_blocked_ms: host ms per step spent blocked in the program's
blocking host <-> device moves: the summed host durations of its
``sync.<site>`` spans over its step spans, read as host_syncs_per_step
reads them (and None where it is None).

The reading is taken under the profiler, which slows the host's dispatch:
the host reaches each wait later, when less device work is left ahead of
it, so the traced reading is a lower bound on the time an untraced step
waits."""

from benchmark_torch.metrics.host_syncs_per_step import sync_spans


def read(summary: dict):
    found = sync_spans(summary)
    if found is None:
        return None
    syncs, steps = found
    return sum(s.end_ns - s.start_ns for s in syncs) * 1e-6 / steps
