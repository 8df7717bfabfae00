"""host_syncs_per_step: blocking host <-> device moves per step, as the
program counts them: the ``sync.<site>`` spans over the step spans
(``ensemble_step``, ``flagship_step``) that
``qpp_fusion_rag_tpu_torch.tracing`` kept. The program keeps spans only
while a profiler records, and the traced stretch is the only time one does
in a run; the reader runs right after it.

Nothing (None) where the program keeps no spans (no tracing module), where
none of its step spans were kept or their number differs from the trace's
steps, or where the trace holds no device work (a CPU run waits for no
device). A count of 0 is a reading."""

STEP_SPANS = ("ensemble_step", "flagship_step")
SYNC = "sync."


def sync_spans(summary: dict):
    """-> (the kept sync spans, the number of kept step spans), or None
    where the reading would not be the traced stretch's."""
    if summary["busy_s"] <= 0 or not summary["steps"]:
        return None
    try:
        from qpp_fusion_rag_tpu_torch import tracing
    except ImportError:
        return None
    kept = tracing.spans()
    steps = sum(1 for s in kept if s.name in STEP_SPANS)
    if not steps or steps != summary["steps"]:
        return None
    return [s for s in kept if s.name.startswith(SYNC)], steps


def read(summary: dict):
    found = sync_spans(summary)
    if found is None:
        return None
    syncs, steps = found
    return len(syncs) / steps
