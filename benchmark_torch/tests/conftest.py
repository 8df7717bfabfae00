"""A copy of the benchmark at a size the CPU holds: the real files under a
temporary root, plus tiny configurations, traffic mixes and cells beside
them (found by name, like any added cell). The program runs its plain
PyTorch versions of the kernels on CPU tensors."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_ENSEMBLE = {
    "kind": "ensemble", "source": "a CPU-sized copy of nq-ensemble",
    "docs": 6000, "dim": 64,
    "bm25": {"vocab": 3000, "zipf_a": 0.9874, "lognormal_sigma": 0.3957, "avg_doc_len": 30.0,
             "k1": 0.9, "b": 0.4},
    "splade": {"vocab": 1500, "zipf_a": 0.675, "lognormal_sigma": 0.3957, "avg_doc_len": 40.0,
               "k1": 0.9, "b": 0.4},
    "p_cap": 64, "presorted": True, "k": 20, "k_out": 20, "qpp_index": 5,
    "rerank_proj_scale": 0.05, "text_feats": [6, 6, 9, 5]}
TINY_FLAGSHIP = {
    "kind": "flagship", "source": "a CPU-sized copy of nq-dense5",
    "docs": 5000, "dim": 64, "view_dim": 64, "views": 5, "k": 20, "k_out": 20,
    "qpp_index": 5, "proj_scale": 0.05, "text_feats": [6, 6, 9, 5]}
TINY_TRAFFIC = {
    "q8-tiny": {"mode": "q8", "batch": 24, "bm25_terms": 8, "splade_terms": 16, "pool": 2,
                "skip_top": 30, "min_df": 5},
    "bf16-tiny": {"route": "bf16", "batch": 24, "pool": 2},
    "int8-tiny": {"route": "int8", "batch": 24, "pool": 2},
}
TINY_CELLS = {"tiny-ensemble.q8-tiny": ("tiny-ensemble", "q8-tiny", "nq-ensemble.q8-b1024"),
              "tiny-dense5.bf16-tiny": ("tiny-dense5", "bf16-tiny", "nq-dense5.bf16-b1024"),
              "tiny-dense5.int8-tiny": ("tiny-dense5", "int8-tiny", "nq-dense5.int8-b1024")}


def _dump(path: Path, obj) -> None:
    path.write_text(json.dumps(obj, indent=1))


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    """A root with BENCHMARK.json and benchmark_torch/ copied, and the tiny
    cells added as new files and new workloads (each tiny cell takes the
    limits of the full-size cell it stands for)."""
    root = tmp_path_factory.mktemp("bench")
    bench = root / "benchmark_torch"
    shutil.copytree(ROOT / "benchmark_torch", bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    _dump(bench / "configs" / "tiny-ensemble.json", TINY_ENSEMBLE)
    _dump(bench / "configs" / "tiny-dense5.json", TINY_FLAGSHIP)
    for name, tr in TINY_TRAFFIC.items():
        _dump(bench / "traffic" / f"{name}.json", tr)
    for cell, (cfg, tr, like) in TINY_CELLS.items():
        spec["workloads"].append({"name": cell, "config": cfg, "traffic": tr, "chips": 1,
                                  "why": "CPU-sized"})
        shutil.copy(bench / "limits" / f"{like}.json", bench / "limits" / f"{cell}.json")
        for m in spec["per_layer"]:
            if like in m.get("workloads", ()):
                m["workloads"].append(cell)
    _dump(root / "BENCHMARK.json", spec)
    return root
