"""k4_roofline: K4 (ops.kernels.bitonic.bitonic_topp_rows, the rank-safe
candidate pool's top-bs pass) against its roofline, in %, both sparse
views summed. Its compares and exchanges run on the CUDA cores, for which
no peak rate is cited, so the bound counts bytes: per view the B rows of
M = terms x p_cap keys read once (4 B M) and the top bs of each row written
once (4 B bs), bs the least power of two from 1024 above the pool, as
ops.sparse._bitonic_pool picks it."""

import re

from benchmark_torch.harness.peaks import bound_s, roofline_pct
from benchmark_torch.harness.trace import kernel_time

KERNEL = re.compile(r"topp_warps_kernel|bitonic_topp_kernel")


def block(pool: int) -> int:
    bs = 1024
    while bs <= pool:
        bs *= 2
    return bs


def work_s(cell: dict) -> float:
    cfg, tr = cell["config"], cell["traffic"]
    B, bs = tr["batch"], block(tr["sparse_candidates"])
    nbytes = sum(4.0 * B * (t * cfg["p_cap"] + bs) for t in (tr["bm25_terms"], tr["splade_terms"]))
    return bound_s(nbytes)


def read(summary: dict):
    calls, secs = kernel_time(summary, KERNEL)
    if not calls:
        return None
    return roofline_pct(summary["steps"] * work_s(summary["cell"]), secs)
