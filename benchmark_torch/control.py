#!/usr/bin/env python3
"""The readings that the check's limits are set from, for one cell.

    python3 benchmark_torch/control.py --workload <cell> --seeds <n> [<n> ...]

For each seed, in one process: the cell's set-up, one pass of the program
over the pool (the answers of the timed path at the cell's own load), then
the plain reference in float32 and the control, the same reference in
bfloat16 (one step below the float32 that the configurations state for
scores, QPP and fusion). It prints one JSON line per seed with both sets of
numbers: the program's against the reference (the lower readings) and the
control's against the reference (the upper readings). The benchmark's own
runs never run the control. Needs the card, as run.py does.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark_torch.harness import check as CHECK  # noqa: E402
from benchmark_torch.harness.bench import Bench  # noqa: E402
from benchmark_torch.run import NO_CARD, answers, chips_present, log  # noqa: E402


def readings(bench: Bench, cell: dict, seed: int, device) -> dict:
    """-> {"seed", "program": numbers, "control": numbers, and each side's
    per-statistic QPP gaps}."""
    import torch

    step = bench.step(cell["kind"]).build(cell, seed, device, log)
    kept = []
    for i in range(len(step.batches)):
        out = step(i)
        ids, scores = answers(out)
        kept.append({"ids": ids, "scores": scores, "qpp": out[2]})
    step.release()
    ref = bench.reference(cell["kind"])
    truth = [ref.run(step.ref, i, cell) for i in range(len(kept))]
    lower = CHECK.judge(list(zip(kept, truth)), cell["limits"])
    control = [ref.run(step.ref, i, cell, ft=torch.bfloat16) for i in range(len(kept))]
    upper = CHECK.judge(list(zip(control, truth)), cell["limits"])
    return {"seed": seed, "program": lower["numbers"], "program_correct": lower["correct"],
            "control": upper["numbers"], "control_correct": upper["correct"],
            "program_qpp": lower["qpp_by_statistic"], "control_qpp": upper["qpp_by_statistic"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    bench = Bench(ROOT)
    cell = bench.cell(args.workload)
    if not chips_present(cell["workload"]["chips"]):
        log(f"{args.workload} needs a CUDA card")
        return NO_CARD
    import torch

    device = torch.device("cuda", 0)
    from qpp_fusion_rag_tpu_torch.ops.kernels import _build
    _build.load_library()
    for seed in args.seeds:
        t = time.perf_counter()
        r = readings(bench, cell, seed, device)
        r["seconds"] = time.perf_counter() - t
        print(json.dumps(r), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
