"""flagship_retrieval_ms: device ms per step inside the flagship's
retrieval (pipeline.engine._retrieve: projection, K7 or K1, the merge)."""

from benchmark_torch.harness.trace import span_ms_per_step

SPANS = ("flagship_retrieval",)


def read(summary: dict):
    return span_ms_per_step(summary, SPANS)
