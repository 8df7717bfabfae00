"""k6_roofline: K6 (ops.kernels.row_gather.rescore_match, the doc-vector
rescore of the sparse pools) against its roofline, in %, both sparse views
summed. Its matches and products run on the CUDA cores, so the bound
counts bytes, per view of B queries, C pooled docs and Tq query terms: each
pooled doc's row of Td = doc_cap packed words (4 B C Td, the dominant term),
the pool's ids (4 B C), the query terms and weights (8 B Tq) and the sums
written (4 B C)."""

import re

from benchmark_torch.harness.peaks import bound_s, roofline_pct
from benchmark_torch.harness.trace import kernel_time

KERNEL = re.compile(r"rescore_match_kernel")


def work_s(cell: dict) -> float:
    cfg, tr = cell["config"], cell["traffic"]
    B, C, Td = tr["batch"], tr["sparse_candidates"], cfg["doc_cap"]
    nbytes = sum(4.0 * B * C * Td + 8.0 * B * C + 8.0 * B * tq
                 for tq in (tr["bm25_terms"], tr["splade_terms"]))
    return bound_s(nbytes)


def read(summary: dict):
    calls, secs = kernel_time(summary, KERNEL)
    if not calls:
        return None
    return roofline_pct(summary["steps"] * work_s(summary["cell"]), secs)
