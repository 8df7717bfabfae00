"""Finding a cell's pieces by name.

A cell is one entry of ``workloads`` in ``BENCHMARK.json``, named
``<config>.<traffic>``. Everything that belongs to one configuration, one
traffic mix, one step kind or one per-layer metric sits in a file of its
own under the benchmark's directory, found by that name:

    configs/<config>.json     sizes, source, cuts, and the step kind
    traffic/<traffic>.json    mode, batch, term counts, pool, route
    steps/<kind>.py           builds the inputs, returns the step
    spans/<kind>.json         span name -> "module:attribute" to wrap
    reference/<kind>.py       the plain reference of the step
    metrics/<metric>.py       reads one per-layer metric from a trace summary
    limits/<cell>.json        the limit of each number the check compares

so a later change adds a cell, a mix or a metric as new files and new
entries in ``BENCHMARK.json``, and edits none.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType

BENCH_DIR = Path(__file__).resolve().parents[1]


class Bench:
    """The benchmark under `root` (the checkout): its BENCHMARK.json and
    the files of `bench_dir` (``<root>/benchmark_torch`` by default)."""

    def __init__(self, root: Path, bench_dir: Path | None = None):
        self.root = Path(root)
        self.dir = Path(bench_dir) if bench_dir is not None else self.root / BENCH_DIR.name
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def _json(self, sub: str, name: str) -> dict:
        path = self.dir / sub / f"{name}.json"
        if not path.is_file():
            raise LookupError(f"no {sub[:-1] if sub.endswith('s') else sub} file {path}")
        return json.loads(path.read_text())

    def _module(self, sub: str, name: str) -> ModuleType:
        path = self.dir / sub / f"{name}.py"
        if not path.is_file():
            raise LookupError(f"no {sub} module {path}")
        spec = importlib.util.spec_from_file_location(f"benchmark_{sub}_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def workload(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise LookupError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name)

    def limits(self, cell: str) -> dict:
        return self._json("limits", cell)

    def spans(self, kind: str) -> dict:
        return self._json("spans", kind)

    def step(self, kind: str) -> ModuleType:
        return self._module("steps", kind)

    def reference(self, kind: str) -> ModuleType:
        return self._module("reference", kind)

    def metric(self, name: str) -> ModuleType:
        return self._module("metrics", name)

    def cell(self, name: str) -> dict:
        """-> {"name", "workload", "config", "traffic", "kind", "limits"}."""
        w = self.workload(name)
        cfg = self.config(w["config"])
        return {"name": name, "workload": w, "config": cfg,
                "traffic": self.traffic(w["traffic"]), "kind": cfg["kind"],
                "limits": self.limits(name)}

    def metrics_of(self, cell: str, section: str) -> list:
        """The entries of `section` ("end_to_end" or "per_layer") that the
        cell reports: those without a "workloads" key, and those listing it."""
        return [m for m in self.spec[section]
                if "workloads" not in m or cell in m["workloads"]]
