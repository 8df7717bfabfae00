"""The benchmark's tests of its HotpotQA ensemble cell
(benchmark_torch/tests/test_hotpotqa.py), collected here as well: the cell's
files and declaration, its derived sizes against their formulas, the plain
reference's q8 keys at 5,233,329 docs and 32 terms, and a tiny
HotpotQA-shaped cell end to end through the harness (sound, and under the
control)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

pytest.register_assert_rewrite("benchmark_torch.tests.test_hotpotqa")

from benchmark_torch.tests.test_hotpotqa import *  # noqa: E402,F401,F403
