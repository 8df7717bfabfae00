"""PyTorch + CUDA port of qpp_fusion_rag_tpu for one NVIDIA H100.

The JAX package ``qpp_fusion_rag_tpu`` is the reference; this package
mirrors its layout (``ops``, ``data``, ``pipeline``) and imports neither
jax nor pyyaml nor the JAX package. Hand-written Hopper kernels live in
``csrc/`` and are built on first use by ``ops.kernels._build``; importing
this package compiles and loads nothing.
"""

__version__ = "0.1.0"
