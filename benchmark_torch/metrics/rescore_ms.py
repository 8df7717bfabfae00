"""rescore_ms: device ms per step of the rank-safe rescore layer: the two
sparse pools rescored against their doc vectors
(ops.sparse.sparse_exact_rescore: K6 and the re-sort) and the dense pool
rescored over the rerank rows (pipeline.ensemble.dense_pool_rescore: the
row gather, the bf16 products and the re-sort)."""

from benchmark_torch.harness.trace import span_ms_per_step

SPANS = ("sparse_rescore", "dense_rescore")


def read(summary: dict):
    return span_ms_per_step(summary, SPANS)
