"""Row-wise bitonic kernels over int32 keys (one CTA per row, or a cluster
of two CTAs for rows of more than 32,768 keys where the row is held on
chip):

  K2 bitonic_segsum_rows (csrc/bitonic_segsum.cu): sort + exact run sums,
     the row in registers (the network of csrc/bitonic_regs.cuh);
  K4 bitonic_topp_rows   (csrc/bitonic_topp.cu):   exact top-bs block: a
     warp-streaming tournament in registers at bs 1024 and 2048, the
     shared-memory tournament of csrc/bitonic_common.cuh above;
  K5 bitonic_sort_rows   (csrc/bitonic_sort.cu):   ascending sort, on the
     shared-memory network of csrc/bitonic_common.cuh.

Counterparts of the functions of the same names in
qpp_fusion_rag_tpu/ops/pallas/bitonic.py, without the TPU's shape rules (M
a power of two and a multiple of 1024, B a multiple of 8): rows of any
length up to MAX_ROW = 65,536 keys are padded inside shared memory. Longer
rows are refused on the card; ops/sparse.py sorts them with torch.sort, as
the JAX package takes lax.sort for them.

K2 keeps bitonic_segsum_rows' contract:
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

from qpp_fusion_rag_tpu_torch.ops.kernels import LAUNCHES, _build
from qpp_fusion_rag_tpu_torch.ops.segment import segmented_sums_presorted_i32

MAX_ROW = 65536   # a row must fit two CTAs' shared memory (2 x 128 KB + pad)


def _padded_len(M: int) -> int:
    return 1 << max(1, (M - 1).bit_length())


def _check_keys(keys: torch.Tensor, start_block: int) -> None:
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


def _cuda_row_fits(keys: torch.Tensor, kernel: str) -> None:
    """The device rule of every CUDA wrapper here: a CUDA tensor whose
    padded row fits the shared memory of a two-CTA cluster."""
    if keys.device.type != "cuda":
        raise ValueError(f"unsupported device {keys.device}")
    M = keys.shape[1]
    if _padded_len(M) > MAX_ROW:
        raise ValueError(
            f"row length M={M} exceeds {kernel}'s shared-memory row ({MAX_ROW} keys "
            "over a cluster of two CTAs); sort longer rows with torch.sort")


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
    (M <= 65536 per row)."""
    _check_keys(keys, start_block)
    if max_run is not None and max_run < 1:
        raise ValueError(f"max_run={max_run} must be >= 1")
    if keys.device.type == "cpu":
        return bitonic_segsum_rows_plain(keys, plus_one)
    _cuda_row_fits(keys, "K2")
    B, M = keys.shape
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
    LAUNCHES["bitonic_segsum_rows"] += 1
    return sums, sids


def bitonic_sort_rows_plain(keys: torch.Tensor) -> torch.Tensor:
    return torch.sort(keys, dim=-1).values


def bitonic_sort_rows(keys: torch.Tensor, start_block: int = 2) -> torch.Tensor:
    """Sort each row of [B, M] int32 keys ascending -> [B, M] int32.

    start_block > 2 promises aligned start_block/2 blocks sorted alternately
    ascending/descending; the kernel then skips the rounds before it.
    CPU tensors take the plain version (torch.sort); CUDA tensors launch K5
    (M <= 65536 per row)."""
    _check_keys(keys, start_block)
    if keys.device.type == "cpu":
        return bitonic_sort_rows_plain(keys)
    _cuda_row_fits(keys, "K5")
    B, M = keys.shape
    out = torch.empty_like(keys)
    if B == 0:
        return out
    lib = _build.load_library()
    with torch.cuda.device(keys.device):
        rc = lib.qfr_bitonic_sort(keys.data_ptr(), B, M, start_block, out.data_ptr(),
                                  _build.stream_of(keys))
    _build.check(lib, rc, "bitonic_sort_rows")
    LAUNCHES["bitonic_sort_rows"] += 1
    return out


def bitonic_topp_rows_plain(keys: torch.Tensor, bs: int) -> torch.Tensor:
    return torch.sort(keys, dim=-1).values[:, keys.shape[1] - bs:]


def bitonic_topp_rows(keys: torch.Tensor, bs: int = 1024,
                      start_block: int = 2) -> torch.Tensor:
    """The exact top-`bs` values of each row of [B, M] int32 keys as a
    [B, bs] block sorted ascending: element [bs - pool - 1] is the true
    (pool+1)-th value. bs must be a power of two >= 1024 with 2*bs <= M (the
    JAX wrapper's rule); start_block as in bitonic_sort_rows, at most 2*bs.
    CPU tensors take the plain version; CUDA tensors launch K4 (M <= 65536
    per row). Both return the same block bit for bit: it is a function of
    the keys alone."""
    _check_keys(keys, start_block)
    M = keys.shape[1]
    if bs & (bs - 1) or bs < 1024 or 2 * bs > M:
        raise ValueError(f"bs={bs} must be a power of two in [1024, M/2 = {M // 2}]")
    if start_block > 2 * bs:
        raise ValueError(f"start_block={start_block} must be at most 2*bs = {2 * bs}")
    if keys.device.type == "cpu":
        return bitonic_topp_rows_plain(keys, bs)
    _cuda_row_fits(keys, "K4")
    B = keys.shape[0]
    out = torch.empty((B, bs), dtype=torch.int32, device=keys.device)
    if B == 0:
        return out
    lib = _build.load_library()
    with torch.cuda.device(keys.device):
        rc = lib.qfr_bitonic_topp(keys.data_ptr(), B, M, bs, start_block, out.data_ptr(),
                                  _build.stream_of(keys))
    _build.check(lib, rc, "bitonic_topp_rows")
    LAUNCHES["bitonic_topp_rows"] += 1
    return out
