"""Hand-written Hopper kernels (``csrc/``) behind PyTorch wrappers.

Each wrapper checks its tensors, runs its kernel's plain PyTorch version
for CPU tensors only, and for CUDA tensors launches the kernel or raises.
``LAUNCHES`` counts launches by kernel name: each wrapper adds one where it
launches its kernel, and nowhere else, so a run can show which kernels it
went through (``LAUNCHES.clear()`` before it, read after it).
"""

from collections import Counter

LAUNCHES: Counter = Counter()
