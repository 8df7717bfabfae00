#!/usr/bin/env python3
"""The readings that a cell's sparse tie band is set from (the limit
"sparse_tie_band" of limits/<cell>.json, which reference/ensemble_plain.py
reads), beside control.py's readings of the same seed.

    python3 benchmark_torch/tie_band.py --workload <cell> --seeds <n> [<n> ...]

For each seed, in one process: control.py's readings (the cell's set-up, one
pass of the program over the pool, the reference in float32 and the
control in bfloat16), then, from the same set-up, each sparse view's
shortfall on every pool batch: how far the lowest doc of a pick scores
below the float32 reference's k-th score, over the query's best score.
The lower reading is the largest shortfall of the program's own picks;
the upper, that of the picks of the same reference summing in bfloat16
(the control's precision). It prints one JSON line per seed: control.py's
object with "tie_band" added ({"program", "control", and "swapped": the
queries whose program pick differs from the reference's ties-lowest-id
pick, of "queries"}). Needs the card, as run.py does.
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

from benchmark_torch import control as CONTROL  # noqa: E402
from benchmark_torch.harness.bench import Bench  # noqa: E402
from benchmark_torch.reference import ensemble as Q8  # noqa: E402
from benchmark_torch.run import NO_CARD, chips_present, log  # noqa: E402


def band_readings(bench: Bench, cell: dict, data: dict) -> dict:
    """-> {"program", "control", "swapped", "queries"} over the pool."""
    import torch

    ref = bench.reference(cell["kind"])
    cfg = cell["config"]
    k, n = cfg["k"], cfg["docs"]
    lower, upper, swapped, queries = 0.0, 0.0, 0, 0
    for i, (bt, bq, st, sq, *_) in enumerate(data["batches"]):
        for name, terms, qw in (("bm25", bt, bq), ("splade", st, sq)):
            grid = Q8.term_grid(data[name])
            picks = data["picks"][i][name]
            _, own, fall = ref.sparse_view(data[name], grid, terms, qw, n, k, torch.float32,
                                           picks=picks, band=-1.0)
            lower = max(lower, float(fall.max()))
            own_set = torch.sort(own.cpu(), dim=1).values
            pick_set = torch.sort(picks.to(torch.int64), dim=1).values
            swapped += int((own_set != pick_set).any(1).sum())
            queries += own.shape[0]
            _, low_ids, _ = ref.sparse_view(data[name], grid, terms, qw, n, k, torch.bfloat16)
            _, _, fall = ref.sparse_view(data[name], grid, terms, qw, n, k, torch.float32,
                                         picks=low_ids)
            upper = max(upper, float(fall.max()))
    return {"program": lower, "control": upper, "swapped": swapped, "queries": queries}


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
    built = []
    step_of = bench.step

    def step(kind):
        """The cell's step module, its build kept for the band readings."""
        mod = step_of(kind)

        class Keep:
            @staticmethod
            def build(*a):
                built.append(mod.build(*a))
                return built[-1]
        return Keep

    bench.step = step
    for seed in args.seeds:
        t = time.perf_counter()
        r = CONTROL.readings(bench, cell, seed, device)
        r["tie_band"] = band_readings(bench, cell, built.pop().ref)
        r["seconds"] = time.perf_counter() - t
        print(json.dumps(r), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
