"""pair_sums_ms: device ms per step of the "sort" engine's pair sums, both
sparse views: the kernels launched inside ops.sparse._segmented_scores (the
stable id sort of the window pairs and the gather of their values, the f32
run totals as differences of one blocked cumsum with their running maxima,
and the full-row top-k of the totals). Span `pair_sums` nests inside
`sparse_view` and attribution is innermost, so where this reads,
sparse_views_ms holds the rest of the sparse views: K3's windows and the
contributions."""

from benchmark_torch.harness.trace import span_ms_per_step

SPANS = ("pair_sums",)


def read(summary: dict):
    return span_ms_per_step(summary, SPANS)
