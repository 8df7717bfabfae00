"""k1_roofline: K1 (ops.kernels.dense_topk.group_max_packed_int8, the int8
group max) against its roofline, in %. Its work at M query rows over N docs
of width D: 2 M N D int8 operations; bytes: the queries M D, the rows and
their scales N (D + 4), and the packed group maxima 4 M ceil(N / 128)
written once. M is the batch, times the views on the flagship."""

import re

from benchmark_torch.harness.peaks import bound_s, roofline_pct
from benchmark_torch.harness.trace import kernel_time

KERNEL = re.compile(r"group_max_kernel<[^<>]*\bS8,[^<>]*\bPackedMax>")


def work_s(cell: dict) -> float:
    cfg, tr = cell["config"], cell["traffic"]
    M = tr["batch"] * (cfg["views"] if cell["kind"] == "flagship" else 1)
    N, D = cfg["docs"], cfg.get("view_dim", cfg["dim"])
    nbytes = M * D + N * (D + 4) + 4 * M * -(-N // 128)
    return bound_s(nbytes, 2.0 * M * N * D, "int8")


def read(summary: dict):
    calls, secs = kernel_time(summary, KERNEL)
    if not calls:
        return None
    return roofline_pct(calls * work_s(summary["cell"]), secs)
