"""The benchmark's tests of its HotpotQA ensemble cell
(benchmark_torch/tests/test_hotpotqa.py), collected here as well: the cell's
files and declaration, its derived sizes against their formulas, the plain
reference's q8 keys at 5,233,329 docs and 32 terms, and a tiny
HotpotQA-shaped cell end to end through the harness (sound, and under the
control). The cell's declaration is checked with program_idle_ms, the idle
the program owns, in its set of per-layer metrics."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

pytest.register_assert_rewrite("benchmark_torch.tests.test_hotpotqa")

from benchmark_torch.tests.test_hotpotqa import *  # noqa: E402,F401,F403

from benchmark_torch.tests import test_hotpotqa as _cell  # noqa: E402

SPAN_METRICS = {"program_idle_ms"}


def test_cell_is_declared_with_its_files(monkeypatch):
    """The benchmark's declaration test, the cell's per-layer metrics being
    its eleven and program_idle_ms, the idle the program owns."""
    monkeypatch.setattr(_cell, "PER_LAYER", _cell.PER_LAYER | SPAN_METRICS)
    _cell.test_cell_is_declared_with_its_files()
