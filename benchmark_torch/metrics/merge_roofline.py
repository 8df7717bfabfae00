"""merge_roofline: the dense merge's row top-k (ops.kernels.row_topk, its
kernel row_topk_kernel) against its roofline, in %. A selection on the
CUDA cores, for which no peak rate is cited, so the bound counts bytes,
each once: the M rows of ceil(docs / 128) f32 group maxima read (4 B
each), and k f32 values and k int64 columns written a row (12 B). M is
the batch, times the views on the flagship; k is the cell's k, or
max(dense_rescore_pool, k) where the rank-safe kind pools the dense view.
A program without the kernel reads nothing here."""

import re

from benchmark_torch.harness.peaks import bound_s, roofline_pct
from benchmark_torch.harness.trace import kernel_time

KERNEL = re.compile(r"row_topk_kernel")


def work_s(cell: dict) -> float:
    cfg, tr = cell["config"], cell["traffic"]
    M = tr["batch"] * (cfg["views"] if cell["kind"] == "flagship" else 1)
    k = cfg["k"]
    if cell["kind"] == "ensemble_rs":
        k = max(tr["dense_rescore_pool"], k)
    return bound_s(4.0 * M * -(-cfg["docs"] // 128) + 12.0 * M * k)


def read(summary: dict):
    calls, secs = kernel_time(summary, KERNEL)
    if not calls:
        return None
    return roofline_pct(calls * work_s(summary["cell"]), secs)
