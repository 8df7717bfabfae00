"""The benchmark's tests of the reader of the idle the program owns
(benchmark_torch/tests/test_span_device_metrics.py), collected here as
well: program_idle_ms on synthetic kept spans and summaries."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

pytest.register_assert_rewrite("benchmark_torch.tests.test_span_device_metrics")

from benchmark_torch.tests.test_span_device_metrics import *  # noqa: E402,F401,F403
