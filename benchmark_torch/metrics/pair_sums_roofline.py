"""pair_sums_roofline: the "sort" engine's pair-sum layer (span `pair_sums`,
ops.sparse._segmented_scores: id sort, run totals, top-k) against its
roofline, in %, both sparse views summed. Sorting and scanning run on the
CUDA cores, for which no peak rate is cited, so the bound counts bytes,
each once: per view of B queries, Tq terms and p_cap postings a window,
each window pair's int32 doc id and f32 value read (8 B B Tq p_cap), and k
f32 scores and k int32 ids written a query (8 B k). The time is the span's
device time, not a kernel's, so the share reads the same work whatever
implements the layer; a program without the span reads nothing here."""

from benchmark_torch.harness.peaks import bound_s, roofline_pct
from benchmark_torch.harness.trace import span_ms_per_step

SPANS = ("pair_sums",)


def work_s(cell: dict) -> float:
    cfg, tr = cell["config"], cell["traffic"]
    B, cap, k = tr["batch"], cfg["p_cap"], cfg["k"]
    nbytes = sum(8.0 * B * tq * cap + 8.0 * B * k for tq in (tr["bm25_terms"], tr["splade_terms"]))
    return bound_s(nbytes)


def read(summary: dict):
    ms = span_ms_per_step(summary, SPANS)
    if ms is None:
        return None
    return roofline_pct(work_s(summary["cell"]), ms * 1e-3)
