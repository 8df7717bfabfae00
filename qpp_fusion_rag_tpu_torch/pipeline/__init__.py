"""Serving pipeline of the port, mirroring qpp_fusion_rag_tpu.pipeline."""
