"""Query-performance prediction of the port: the QPP stage (engine); the
same names as qpp_fusion_rag_tpu.qpp. The package's other modules are not
ported yet (ROADMAP Queue 1 item 5)."""

from qpp_fusion_rag_tpu_torch.qpp.engine import (
    compute_qpp,
    compute_qpp_dir,
    compute_qpp_for_res_file,
    compute_qpp_for_runtensor,
    qpp_tensor_to_dict,
)

__all__ = [
    "compute_qpp", "compute_qpp_for_res_file", "compute_qpp_for_runtensor",
    "compute_qpp_dir", "qpp_tensor_to_dict",
]
