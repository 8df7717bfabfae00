#!/usr/bin/env python3
"""A cell's device time a step by span, the program's own sub-spans too.

    python3 benchmark_torch/span_split.py --workload <cell> --seed <n> \
        [--spans <program span> ...]

From the root of a checkout, on the card. The cell's set-up and warm-up as
run.py does them, then run.py's traced stretch (TRACE_PASSES passes over
the pool under torch.profiler, the cell's span wrappers in place), summed
by harness.trace with the named program spans (``tracing.span`` names such
as sparse.pair_sort) counted beside the wrappers, each kernel in the
innermost span open at its launch. Prints one JSON object: busy and window
ms a step, and device ms and kernels a step by span. A diagnostic: the
benchmark's runs never call it, and no metric reads it.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark_torch.harness.bench import Bench  # noqa: E402
from benchmark_torch.run import (  # noqa: E402
    NO_CARD,
    TRACE_PASSES,
    WARM_PASSES,
    answers,
    chips_present,
    log,
)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--spans", nargs="*", default=[])
    args = p.parse_args(argv)
    bench = Bench(ROOT)
    cell = bench.cell(args.workload)
    if not chips_present(cell["workload"]["chips"]):
        log(f"{args.workload} needs a CUDA card")
        return NO_CARD
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark_torch.harness import trace as T
    from qpp_fusion_rag_tpu_torch.ops.kernels import _build

    _build.load_library()
    step = bench.step(cell["kind"]).build(cell, args.seed, torch.device("cuda", 0), log)
    entries = bench.spans(cell["kind"])["spans"]
    names = [e["name"] for e in entries] + list(args.spans)
    pool = len(step.batches)
    with T.spans_wrapped(entries):
        for _ in range(WARM_PASSES):
            for i in range(pool):
                answers(step(i))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            for n in range(TRACE_PASSES * pool):
                with record_function(T.STEP):
                    answers(step(n % pool))
    s = T.summarize(T.events_of(prof, names), names, {"name": cell["name"]})
    per = 1e3 / s["steps"]
    print(json.dumps({
        "cell": cell["name"], "seed": args.seed, "steps": s["steps"],
        "busy_ms_per_step": s["busy_s"] * per, "window_ms_per_step": s["window_s"] * per,
        "device_ms_per_step": {k: v["device_s"] * per for k, v in sorted(s["spans"].items())},
        "kernels_per_step": {k: v["kernels"] / s["steps"] for k, v in sorted(s["spans"].items())},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
