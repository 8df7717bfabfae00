"""sparse_views_ms: device ms per step of the kernels launched inside the
two sparse scorers (ops.sparse, both views)."""

from benchmark_torch.harness.trace import span_ms_per_step

SPANS = ("sparse_view",)


def read(summary: dict):
    return span_ms_per_step(summary, SPANS)
