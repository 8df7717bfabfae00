"""qpp_fusion_ms: device ms per step inside the QPP statistics, their
normalization, the per-view min-max and the fusion (ops.qpp, ops.fusion)."""

from benchmark_torch.harness.trace import span_ms_per_step

SPANS = ("qpp", "qpp_norm", "minmax", "fusion")


def read(summary: dict):
    return span_ms_per_step(summary, SPANS)
