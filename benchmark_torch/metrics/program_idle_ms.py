"""program_idle_ms: device-idle ms per step that the program owns: the
trace's idle gaps whose label's span part names a span, either one the
program kept (``qpp_fusion_rag_tpu_torch.tracing``) or one of the cell's
span wrappers (spans/<kind>.json). A label with no span part (an op alone,
``step``, ``between steps``) is the harness's: the answers' copy, the loop.
Nothing (None) where host_syncs_per_step reads nothing (no tracing module,
the kept step spans are not the trace's steps, no device work)."""

from pathlib import Path

from benchmark_torch.harness.bench import Bench
from benchmark_torch.metrics.host_syncs_per_step import sync_spans

ROOT = Path(__file__).resolve().parents[2]


def span_part(label: str) -> str:
    """The span an idle gap's label names (``<span> > <op>``, ``<span>``),
    or the label itself where it names an op alone."""
    return label.split(" > ", 1)[0]


def wrapper_names(summary: dict) -> set:
    """The names of the cell's span wrappers; none where the summary names
    no step kind."""
    kind = summary.get("cell", {}).get("kind")
    if kind is None:
        return set()
    return {e["name"] for e in Bench(ROOT).spans(kind)["spans"]}


def read(summary: dict):
    found = sync_spans(summary)
    if found is None:
        return None
    from qpp_fusion_rag_tpu_torch import tracing

    steps = found[1]
    names = {s.name for s in tracing.spans()} | wrapper_names(summary)
    idle_s = sum(v for label, v in summary["idle_gaps"].items() if span_part(label) in names)
    return idle_s * 1e3 / steps
