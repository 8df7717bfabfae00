"""Hand-written Hopper kernels (``csrc/``) behind PyTorch wrappers.

Each wrapper checks its tensors, runs its kernel's plain PyTorch version
for CPU tensors only, and for CUDA tensors launches the kernel or raises.
``LAUNCHES`` (``tracing.LAUNCHES``, the same object) counts launches by
kernel name: each wrapper adds one where it launches its kernel, and
nowhere else, so a run can show which kernels it went through
(``LAUNCHES.clear()`` before it, read after it).
"""

from qpp_fusion_rag_tpu_torch.tracing import LAUNCHES

__all__ = ["LAUNCHES"]
