"""The benchmark's tests of its plain "sort" ensemble cell
(benchmark_torch/tests/test_ensemble_plain.py), collected here as well: the
port's sort-mode step against the cell's plain reference at a CPU size, the
tiny cell end to end through the harness (sound, under the control, with an
altered id, with a sort engine that sums directly, with picks below the tie
band, without the band), the tie band's readings, and the cell's two metric
readers."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

pytest.register_assert_rewrite("benchmark_torch.tests.test_ensemble_plain")

from benchmark_torch.tests.test_ensemble_plain import *  # noqa: E402,F401,F403
