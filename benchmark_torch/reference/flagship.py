"""Plain reference of the dense flagship step: R projected query views
(f32 projection) over one corpus by common.group_max_topk, the bf16 route
with the views rounded to bf16 and f32 products, the int8 route with the
views quantized per row and the doc scales applied; then QPP per view,
normalized over the batch, and RSD-weighted CombSUM (common.fuse_views).
"""

from __future__ import annotations

import torch

from benchmark_torch.reference import common as C


def run(data: dict, i: int, cell: dict, ft=torch.float32) -> dict:
    """The reference's answers for pool batch i. -> {"ids", "scores": the
    whole fused ranking, "qpp": [R, B, 13]}."""
    C.exact_float32()
    cfg = cell["config"]
    k = cfg["k"]
    q, text = data["batches"][i]
    qv = torch.einsum("bd,rdv->rbv", q.to(torch.float32), data["view_proj"].to(torch.float32))
    R, B, dv = qv.shape
    flat = qv.reshape(R * B, dv)
    if data["route"] == "bf16":
        vals, ids = C.group_max_topk(flat.to(torch.bfloat16).to(torch.float32), data["corpus"], k)
    else:
        qi, qs = C.quantize_rows(flat)
        vals, ids = C.group_max_topk(qi, data["corpus"], k, row_scale=data["scale"])
        vals = vals * qs
    return C.fuse_views(ids.reshape(R, B, k), vals.to(ft).reshape(R, B, k), text,
                        cfg["qpp_index"])
