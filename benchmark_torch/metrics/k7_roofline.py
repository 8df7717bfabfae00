"""k7_roofline: K7 (ops.kernels.dense_topk.group_max_packed, the bf16
group max) against its roofline, in %. Its work at M = views x batch rows
over N docs of width D: 2 M N D bf16 operations; bytes: the queries 2 M D,
the rows 2 N D and the packed group maxima 4 M ceil(N / 128)."""

import re

from benchmark_torch.harness.peaks import bound_s, roofline_pct
from benchmark_torch.harness.trace import kernel_time

KERNEL = re.compile(r"group_max_kernel<[^<>]*\bBf16,[^<>]*\bPackedMax>")


def work_s(cell: dict) -> float:
    cfg, tr = cell["config"], cell["traffic"]
    M = tr["batch"] * cfg["views"]
    N, D = cfg["docs"], cfg["view_dim"]
    nbytes = 2 * M * D + 2 * N * D + 4 * M * -(-N // 128)
    return bound_s(nbytes, 2.0 * M * N * D, "bf16")


def read(summary: dict):
    calls, secs = kernel_time(summary, KERNEL)
    if not calls:
        return None
    return roofline_pct(calls * work_s(summary["cell"]), secs)
