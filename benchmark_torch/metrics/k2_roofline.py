"""k2_roofline: K2 (ops.kernels.bitonic.bitonic_segsum_rows, the q8 keys'
sort and run sums) against its roofline, in %, both sparse views summed.
Its compares and exchanges run on the CUDA cores, for which no peak rate is
cited, so the bound counts bytes: per view 12 B M (the keys read, the sums
and doc ids written) for B rows of M = terms x p_cap keys."""

import re

from benchmark_torch.harness.peaks import bound_s, roofline_pct
from benchmark_torch.harness.trace import kernel_time

KERNEL = re.compile(r"bitonic_segsum_kernel")


def work_s(cell: dict) -> float:
    cfg, tr = cell["config"], cell["traffic"]
    keys = (tr["bm25_terms"] + tr["splade_terms"]) * cfg["p_cap"]
    return bound_s(12.0 * tr["batch"] * keys)


def read(summary: dict):
    calls, secs = kernel_time(summary, KERNEL)
    if not calls:
        return None
    return roofline_pct(summary["steps"] * work_s(summary["cell"]), secs)
