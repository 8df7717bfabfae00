"""K3: contiguous posting-window gather (csrc/window_gather.cu).

Counterpart of qpp_fusion_rag_tpu/ops/pallas/window_gather.py
gather_windows_pallas, without the TPU's alignment rules (cap % 1024,
G % 32, 1024-aligned fetches): those exist only for Mosaic's DMA tiling.
"""

from __future__ import annotations

import torch

from qpp_fusion_rag_tpu_torch.ops.kernels import LAUNCHES, _build



def _check(src: torch.Tensor, starts: torch.Tensor, cap: int) -> None:
    if src.dtype != torch.int32 or src.dim() != 1 or not src.is_contiguous():
        raise ValueError(f"src must be a contiguous 1-D int32 tensor, got "
                         f"{src.dtype} {tuple(src.shape)}")
    if starts.dtype != torch.int32 or starts.dim() != 1 or not starts.is_contiguous():
        raise ValueError(f"starts must be a contiguous 1-D int32 tensor, got "
                         f"{starts.dtype} {tuple(starts.shape)}")
    if starts.device != src.device:
        raise ValueError(f"src on {src.device} but starts on {starts.device}")
    if not 1 <= cap <= src.shape[0]:
        raise ValueError(f"cap={cap} must be in [1, {src.shape[0]}]")


def gather_windows_plain(src: torch.Tensor, starts: torch.Tensor,
                         cap: int) -> torch.Tensor:
    """src[starts[:, None] + arange(cap)] -> [G, cap] int32."""
    if starts.numel() and (int(starts.min()) < 0
                           or int(starts.max()) > src.shape[0] - cap):
        raise ValueError(f"window starts must lie in [0, {src.shape[0] - cap}]")
    pos = starts.long()[:, None] + torch.arange(cap, device=src.device)
    return src[pos]


def gather_windows(src: torch.Tensor, starts: torch.Tensor, cap: int) -> torch.Tensor:
    """[G, cap] int32 windows of src at starts (0 <= s <= P - cap).

    CPU tensors take the plain version; CUDA tensors launch K3."""
    _check(src, starts, cap)
    if src.device.type == "cpu":
        return gather_windows_plain(src, starts, cap)
    if src.device.type != "cuda":
        raise ValueError(f"unsupported device {src.device}")
    G = starts.shape[0]
    out = torch.empty((G, cap), dtype=torch.int32, device=src.device)
    if G == 0:
        return out
    vec = int(cap % 4 == 0 and src.shape[0] % 4 == 0
              and src.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    lib = _build.load_library()
    with torch.cuda.device(src.device):
        rc = lib.qfr_gather_windows(src.data_ptr(), src.shape[0], starts.data_ptr(),
                                    G, cap, out.data_ptr(), vec, _build.stream_of(src))
    _build.check(lib, rc, "gather_windows")
    LAUNCHES["gather_windows"] += 1
    return out
