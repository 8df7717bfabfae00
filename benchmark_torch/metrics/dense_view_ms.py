"""dense_view_ms: device ms per step inside the ensemble's dense view
(pipeline.ensemble.dense_view_topk: K1 and the exact merge)."""

from benchmark_torch.harness.trace import span_ms_per_step

SPANS = ("dense_view",)


def read(summary: dict):
    return span_ms_per_step(summary, SPANS)
