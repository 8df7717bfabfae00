"""Device operators of the port (PyTorch), mirroring qpp_fusion_rag_tpu.ops."""
