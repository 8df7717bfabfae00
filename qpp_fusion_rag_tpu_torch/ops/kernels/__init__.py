"""Hand-written Hopper kernels (``csrc/``) behind PyTorch wrappers.

Each wrapper checks its tensors, runs its kernel's plain PyTorch version
for CPU tensors only, and for CUDA tensors launches the kernel or raises.
Each keeps a plain-int ``LAUNCHES`` counter that grows by one per launch.
"""
