"""K2: fused row sort + exact segmented run-sum (csrc/bitonic_segsum.cu).

Counterpart of qpp_fusion_rag_tpu/ops/pallas/bitonic.py
bitonic_segsum_rows, same contract:
  -> (sums [B, M] int32: each doc run's total of (q8 + plus_one) at the
      run's LAST position, -1 elsewhere;
      sids [B, M] int32: sorted doc ids by LOGICAL shift, so the INT32_MIN
      pad of descending presorted windows reads 0x800000 — callers mask
      sids >= 0x7FFFFF).
Both versions sum exactly over any run length, so they agree everywhere
with the Pallas kernel at max_run=None, and on real positions
(sids < 0x7FFFFF) when max_run bounds its scan.
"""

from __future__ import annotations

import torch

from qpp_fusion_rag_tpu_torch.ops.kernels import _build
from qpp_fusion_rag_tpu_torch.ops.segment import segmented_sums_presorted_i32

LAUNCHES = 0
MAX_ROW = 32768   # a row must fit one CTA's shared memory (128 KB + pad)


def _padded_len(M: int) -> int:
    return 1 << max(1, (M - 1).bit_length())


def _check(keys: torch.Tensor, start_block: int, max_run) -> None:
    if keys.dtype != torch.int32 or keys.dim() != 2 or not keys.is_contiguous():
        raise ValueError(f"keys must be a contiguous [B, M] int32 tensor, got "
                         f"{keys.dtype} {tuple(keys.shape)}")
    M = keys.shape[1]
    if M < 1:
        raise ValueError("rows must be non-empty")
    if start_block & (start_block - 1) or not 2 <= start_block <= _padded_len(M):
        raise ValueError(f"start_block={start_block} must be a power of two in "
                         f"[2, {_padded_len(M)}]")
    if start_block > 2 and M % (start_block // 2):
        raise ValueError(f"M={M} must be a multiple of start_block/2 = "
                         f"{start_block // 2} (presorted blocks)")
    if max_run is not None and max_run < 1:
        raise ValueError(f"max_run={max_run} must be >= 1")


def bitonic_segsum_rows_plain(keys: torch.Tensor, plus_one: bool = False):
    """torch.sort of each row, then exact int32 run sums."""
    skeys = torch.sort(keys, dim=-1).values
    sids = (skeys >> 8) & 0xFFFFFF         # arithmetic shift + mask = logical
    v = (skeys & 0xFF) + int(plus_one)
    return segmented_sums_presorted_i32(sids, v), sids


def bitonic_segsum_rows(keys: torch.Tensor, start_block: int = 2,
                        plus_one: bool = False, max_run: int = None):
    """Sort rows of packed (doc << 8 | q8) keys and sum each doc's run.

    start_block > 2 promises aligned start_block/2 blocks sorted alternately
    ascending/descending (the presorted layout); the kernel then skips the
    rounds a full sort would have spent reaching that state. max_run bounds
    the Pallas kernel's scan span; both versions here sum runs of any
    length exactly, so it is validated and otherwise not needed.
    CPU tensors take the plain version; CUDA tensors launch K2
    (M <= 32768 per row)."""
    global LAUNCHES
    _check(keys, start_block, max_run)
    if keys.device.type == "cpu":
        return bitonic_segsum_rows_plain(keys, plus_one)
    if keys.device.type != "cuda":
        raise ValueError(f"unsupported device {keys.device}")
    B, M = keys.shape
    if _padded_len(M) > MAX_ROW:
        raise ValueError(
            f"row length M={M} exceeds the kernel's one-CTA shared-memory row "
            f"({MAX_ROW} keys); longer rows are ROADMAP work (Queue 2, K2)")
    sums = torch.empty_like(keys)
    sids = torch.empty_like(keys)
    if B == 0:
        return sums, sids
    lib = _build.load_library()
    with torch.cuda.device(keys.device):
        rc = lib.qfr_bitonic_segsum(keys.data_ptr(), B, M, start_block,
                                    int(plus_one), sums.data_ptr(), sids.data_ptr(),
                                    _build.stream_of(keys))
    _build.check(lib, rc, "bitonic_segsum_rows")
    LAUNCHES += 1
    return sums, sids
