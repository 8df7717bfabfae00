#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the card it is started on.

    python3 benchmark_torch/run.py --workload <config>.<traffic> --seed <n> \
        --seconds <s> --trace <0|1>

From the root of a checkout. Set-up makes the cell's inputs on the card from
the seed (steps/<kind>.py), loads the program's kernel library (built into
build/torch_kernels/ on the first run of a checkout) and warms every batch
of the pool. Then, with --trace 0, a closed loop with one batch in flight
runs for --seconds, and the cell's end-to-end metrics are printed; with
--trace 1, spans are wrapped around the program's layers (spans/<kind>.json)
and a steady stretch of steps runs under torch.profiler, and the cell's
per-layer metrics (metrics/<name>.py) are printed instead. Either way the
answers of one step per pool batch, drawn from the seed, are held against
the plain reference (reference/<kind>.py) once the window has closed.

The last line of standard output is one JSON object: correct, attempted,
failed, metrics, device (and breakdown with --trace 1), then check, each
compared number beside its limit; the same numbers end standard error.
Without a CUDA card (or with fewer than the cell asks for) it prints no
result and exits with 2; where the program it imports is not this
checkout's, with 3.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import random  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark_torch.harness import check as CHECK  # noqa: E402
from benchmark_torch.harness.bench import Bench  # noqa: E402
from benchmark_torch.harness.gen import sub_seed  # noqa: E402

NO_CARD = 2
NO_PROGRAM = 3
WARM_PASSES = 2               # passes over the pool before the window
TRACE_PASSES = 8              # passes over the pool under the profiler


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def chips_present(n: int) -> bool:
    import torch

    return torch.cuda.is_available() and torch.cuda.device_count() >= n


def card_line() -> str:
    """The card's name, power limit and SM clock as nvidia-smi reads them."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           timeout=30)
        return r.stdout.strip() or r.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"


class Clock:
    """Per-batch latency: CUDA events on a card (the start event is taken
    when the step begins, the end event once its answers are in host
    memory), the host clock on the CPU."""

    def __init__(self, device):
        import torch

        self.cuda = device.type == "cuda"
        if self.cuda:
            self.a = torch.cuda.Event(enable_timing=True)
            self.b = torch.cuda.Event(enable_timing=True)

    def start(self):
        if self.cuda:
            self.a.record()
        else:
            self.t = time.perf_counter()

    def stop_ms(self) -> float:
        if self.cuda:
            self.b.record()
            self.b.synchronize()
            return self.a.elapsed_time(self.b)
        return (time.perf_counter() - self.t) * 1e3


def answers(out):
    """A step's answers in host memory: (fused ids, fused scores); the QPP
    stays where it is."""
    return out[0].to("cpu"), out[1].to("cpu")


class Sampler:
    """Keeps, for each pool batch, the answers of one of its steps, each
    step equally likely (a reservoir of one, drawn from the seed)."""

    def __init__(self, pool: int, seed: int):
        self.rng = random.Random(sub_seed(seed, "sample"))
        self.seen = [0] * pool
        self.kept = [None] * pool

    def offer(self, i: int, ids, scores, qpp) -> None:
        self.seen[i] += 1
        if self.rng.randrange(self.seen[i]) == 0:
            self.kept[i] = {"ids": ids, "scores": scores, "qpp": qpp}


def p95(values) -> float:
    """Nearest-rank 95th percentile."""
    s = sorted(values)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


def timed_window(step, seconds: float, sampler: Sampler, device):
    """The closed loop: one batch in flight, the pool cycled, for `seconds`.
    -> (steps, window seconds, per-batch ms)."""
    pool = len(step.batches)
    clock = Clock(device)
    lat, n = [], 0
    w0 = time.perf_counter()
    while True:
        i = n % pool
        clock.start()
        out = step(i)
        ids, scores = answers(out)
        lat.append(clock.stop_ms())
        sampler.offer(i, ids, scores, out[2])
        n += 1
        if time.perf_counter() - w0 >= seconds:
            break
    return n, time.perf_counter() - w0, lat


def traced_stretch(bench: Bench, cell: dict, step, sampler: Sampler):
    """TRACE_PASSES passes over the pool under torch.profiler with the span
    wrappers in place. -> (steps, summary)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark_torch.harness import trace as T

    entries = bench.spans(cell["kind"])["spans"]
    pool = len(step.batches)
    activities = [ProfilerActivity.CPU]
    if step.ref["device"].type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with T.spans_wrapped(entries):
        for i in range(pool):
            answers(step(i))
        with profile(activities=activities, acc_events=True) as prof:
            for n in range(TRACE_PASSES * pool):
                i = n % pool
                with record_function(T.STEP):
                    out = step(i)
                    ids, scores = answers(out)
                sampler.offer(i, ids, scores, out[2])
    info = {"name": cell["name"], "kind": cell["kind"], "config": cell["config"],
            "traffic": cell["traffic"]}
    names = [e["name"] for e in entries]
    summary = T.summarize(T.events_of(prof, names), names, info)
    return TRACE_PASSES * pool, summary


def per_layer(bench: Bench, cell: dict, summary: dict) -> dict:
    out = {}
    for m in bench.metrics_of(cell["name"], "per_layer"):
        value = bench.metric(m["name"]).read(summary)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(bench: Bench, cell: dict, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> dict:
    """Everything after the look for a card. -> the result object."""
    import torch

    parts = {"imports_s": time.perf_counter() - t_start}
    t = time.perf_counter()
    if device.type == "cuda":
        torch.set_num_threads(1)            # one host thread drives the card
        torch.cuda.init()
        torch.zeros(1, device=device)
        parts["cuda_init_s"] = time.perf_counter() - t
        from qpp_fusion_rag_tpu_torch.ops.kernels import _build

        t = time.perf_counter()
        path, compile_s, _ = _build.build_library()
        _build.load_library()
        parts["kernel_library_s"] = time.perf_counter() - t
        log(f"kernel library {path.name}: compiled in {compile_s:.1f} s" if compile_s
            else f"kernel library {path.name}: already built")
        log(f"card: {card_line()}")

    step = bench.step(cell["kind"]).build(cell, seed, device, log)
    parts.update(step.parts)
    t = time.perf_counter()
    for _ in range(WARM_PASSES):
        for i in range(len(step.batches)):
            answers(step(i))
    parts["warmup_s"] = time.perf_counter() - t
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    sampler = Sampler(len(step.batches), seed)
    B = step.queries_per_batch
    setup_s = time.perf_counter() - t_start
    log("set-up parts (s): " + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()))
    if trace:
        n, summary = traced_stretch(bench, cell, step, sampler)
        metrics = per_layer(bench, cell, summary)
        extra = {"busy_s": summary["busy_s"], "window_s": summary["window_s"]}
        log(f"traced {n} steps: window {summary['window_s']:.6f} s, device busy "
            f"{summary['busy_s']:.6f} s, {summary['kernel_count']} kernels")
    else:
        n, window, lat = timed_window(step, seconds, sampler, device)
        metrics = {"qps": {"value": n * B / window, "unit": "queries/s"},
                   "batch_p95_ms": {"value": p95(lat), "unit": "ms"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
        extra = {}
        log(f"window: {n} batches of {B} in {window:.3f} s; batch ms median "
            f"{statistics.median(lat):.3f}, p95 {p95(lat):.3f}, max {max(lat):.3f}; "
            f"set-up {setup_s:.3f} s")
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    t = time.perf_counter()
    step.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = bench.reference(cell["kind"])
    pairs = [(kept, ref.run(step.ref, i, cell)) for i, kept in enumerate(sampler.kept)]
    verdict = CHECK.judge(pairs, cell["limits"])
    log(f"reference over {verdict['checked']} queries in {time.perf_counter() - t:.3f} s; "
        "QPP gap by statistic: " + " ".join(f"{x:.3g}" for x in verdict["qpp_by_statistic"])
        + f"; snqc_gap {verdict['snqc_gap']!r}, reported, not compared")

    result = {"correct": verdict["correct"], "attempted": n * B, "failed": verdict["failed"],
              "metrics": metrics,
              "device": {"platform": "gpu" if device.type == "cuda" else device.type,
                         "kind": (torch.cuda.get_device_name(device)
                                  if device.type == "cuda" else "cpu"),
                         "count": 1, "memory_peak_bytes": int(peak), **extra}}
    if trace:
        from benchmark_torch.harness.trace import breakdown
        result["breakdown"] = breakdown(summary)
    result["check"] = {k: {"value": verdict["numbers"][k], "limit": verdict["limits"][k]}
                       for k in CHECK.NUMBERS}
    for k, v in result["check"].items():
        log(f"{k} {v['value']!r} limit {v['limit']!r}")
    return result


def program_home() -> Path:
    """The checkout that the imported program comes from."""
    import qpp_fusion_rag_tpu_torch

    return Path(qpp_fusion_rag_tpu_torch.__file__).resolve().parents[1]


def main(argv=None) -> int:
    args = parse(argv)
    bench = Bench(ROOT)
    cell = bench.cell(args.workload)
    if not chips_present(cell["workload"]["chips"]):
        log(f"{args.workload} needs {cell['workload']['chips']} CUDA card(s); none usable "
            "here, and it never runs on the CPU instead")
        return NO_CARD
    if program_home() != ROOT:
        log(f"the program imported from {program_home()}, not from this checkout ({ROOT})")
        return NO_PROGRAM
    import torch

    result = run_cell(bench, cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), T_START)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
