"""Fusion-weight models of the port, mirroring qpp_fusion_rag_tpu.models."""
