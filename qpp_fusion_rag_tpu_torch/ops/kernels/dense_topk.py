"""The dense group-max kernels and the dense top-k built on them:

  K1 group_max_packed_int8        (csrc/dense_topk_int8.cu): int8, per-doc
                                  scale, packed f32 max per 128 docs;
  K7 group_max_packed             (csrc/group_max_packed.cu): bf16, packed
                                  f32 max, corpus [N, D] or [D, N];
  K8 group_max_scores             (csrc/group_max_scores.cu): bf16,
                                  (max, first argmax) per group, stride;
  K9 group_max_packed_int8_global (csrc/group_max_int8_global.cu): int8,
                                  one global scale, packed int32 max.

K1 and K7 run on the TMA + wgmma main loop of csrc/dense_wgmma.cuh (a
persistent grid, 128 x 256 output tiles); K8, K9 and K10
(streaming_topk.py) on the mma.sync main loop of csrc/dense_common.cuh.
TMA and the 16-byte loads of both loops need rows of a multiple of 16
bytes and 16-byte aligned operands (_check_cuda_rows).

Counterpart of qpp_fusion_rag_tpu/ops/pallas/dense_topk.py. int8 corpora
are row-major [N, D] (the one layout that serves the kernels and the
rerank gather) where the TPU kernels read a [D, N] copy. The TPU wrappers
pad N to a multiple of their tile `tn` with zero docs; here the kernels
mask the ragged edge themselves, so no corpus is copied: the packed
outputs have ceil(N/128) columns (JAX's extra columns are all-pad groups,
which never survive the merge), and K8 keeps JAX's tn-padded grouping
because its stride reduce depends on it. Every merge is exact
(``topk_first``, lax.top_k's tie order) where the TPU path may take
approx_max_k, so these equal the JAX functions with exact_merge=True.
"""

from __future__ import annotations

import torch

from qpp_fusion_rag_tpu_torch.ops.kernels import LAUNCHES, _build
from qpp_fusion_rag_tpu_torch.ops.segment import topk_first

GROUP = 128          # docs per emitted candidate
NEG_FINITE = -3.0e38  # packed pad-doc score: finite, so lane bits never make a NaN
INT8_PAD = -(1 << 24)  # K9 pad score: below any |dot| < 2^24, shifts to INT32_MIN
PLAIN_CHUNK = 131_072  # docs per plain-version matmul (bounds its memory)


def _groups(n: int) -> int:
    return -(-n // GROUP)


def quantize_rows(x: torch.Tensor, axis: int = -1):
    """Symmetric per-row int8 quantization -> (int8 values, f32 scales with
    the reduced axis kept). scale = max|x| / 127, taken as max|x| times the
    f32 reciprocal of 127 — what XLA compiles the reference's division by
    the constant into — so the scales match the jitted reference bit for
    bit. Zero rows get scale 1."""
    amax = x.abs().amax(dim=axis, keepdim=True)
    scale = torch.where(amax > 0, amax * (1.0 / 127.0), 1.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_global(x: torch.Tensor):
    """Symmetric GLOBAL int8 quantization -> (int8 values, f32 0-d scale),
    the scheme of L2-normalized embedding matrices; the scale is taken as
    quantize_rows takes it."""
    amax = x.abs().amax()
    scale = torch.where(amax > 0, amax * (1.0 / 127.0), 1.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def unpack_lane(v: torch.Tensor):
    """Packed f32 -> (clean f32 score, lane int32)."""
    bits = v.view(torch.int32)
    return (bits & ~0x7F).view(torch.float32), bits & 0x7F


# ------------------------------------------------------------ checks -------

def _check_pair(q, corpus, dtype, transposed=False):
    """q [M, D] and the corpus ([N, D], or [D, N] when transposed), both
    contiguous `dtype` on one device. -> (M, N, D)."""
    if q.dtype != dtype or q.dim() != 2 or not q.is_contiguous():
        raise ValueError(f"q must be a contiguous [M, D] {dtype} tensor, got "
                         f"{q.dtype} {tuple(q.shape)}")
    layout = "[D, N]" if transposed else "[N, D]"
    if corpus.dtype != dtype or corpus.dim() != 2 or not corpus.is_contiguous():
        raise ValueError(f"the corpus must be a contiguous {layout} {dtype} tensor, "
                         f"got {corpus.dtype} {tuple(corpus.shape)}")
    D, N = corpus.shape if transposed else corpus.shape[::-1]
    if q.shape[1] != D:
        raise ValueError(f"q has D={q.shape[1]}, the {layout} corpus D={D}")
    if q.device != corpus.device:
        raise ValueError("q and the corpus must share a device")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    return q.shape[0], N, D


def _n_real(n_real, N: int) -> int:
    n_real = N if n_real is None else int(n_real)
    if not 0 <= n_real <= N:
        raise ValueError(f"n_real={n_real} must be in [0, {N}]")
    return n_real


def _check_int8_width(D: int) -> None:
    # |dot| <= D*127^2 must stay below 2^24: the plain versions' f32 products
    # are exact there, and K9's (s << 7) packing cannot overflow
    if D * 127 * 127 >= 1 << 24:
        raise ValueError(f"D={D}: int8 dots need D*127^2 < 2^24 (D <= 1040)")


def _check_cuda_rows(row_bytes: int, *tensors) -> None:
    """The kernels stage 16-byte chunks of each row."""
    if row_bytes % 16 or any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"the kernel loads 16-byte chunks: rows of {row_bytes} bytes "
                         "must be a multiple of 16 and every operand 16-byte aligned")


# ------------------------------------------------------ plain epilogues ----

def _packed_max_plain(M, N, n_real, scores, device):
    """Shared plain epilogue of K1 and K7: scores(n0, n1) -> f32 [M, n1-n0];
    mask docs >= n_real to -3e38, pack the lane, max per 128 docs, chunked
    over docs. -> [M, ceil(N/128)] f32."""
    out = torch.empty((M, _groups(N)), dtype=torch.float32, device=device)
    for n0 in range(0, N, PLAIN_CHUNK):
        n1 = min(N, n0 + PLAIN_CHUNK)
        s = scores(n0, n1)
        col = torch.arange(n0, n1, device=device, dtype=torch.int32)
        s = torch.where(col < n_real, s, NEG_FINITE)
        packed = ((s.view(torch.int32) & ~0x7F) | (col & 0x7F)).view(torch.float32)
        ragged = (-(n1 - n0)) % GROUP   # only in the last chunk
        if ragged:
            packed = torch.nn.functional.pad(packed, (0, ragged), value=float("-inf"))
        out[:, n0 // GROUP:_groups(n1)] = packed.reshape(M, -1, GROUP).amax(-1)
    return out


def group_max_scores_plain(q, corpus, n_real: int, stride: int = 1, tn: int = 2048):
    """K8 with torch ops, and with stride 1 and tn = SUPER the plain version
    of K10 too (streaming_topk): f32 scores of the bf16 operands,
    docs >= n_real (and the zero docs that pad N to a multiple of tn) at
    -inf, (max, first argmax as a global id) per 128 docs, then the stride
    reduce inside each tn tile: group j merges with j + g2, j + 2 g2, ...
    (g2 = tn / (128 stride)) under a strict '>'.
    -> (vals [M, N_pad/(128 stride)] f32, ids int32)."""
    M, N = q.shape[0], corpus.shape[0]
    n_pad = -(-N // tn) * tn
    g2 = tn // (GROUP * stride)
    chunk = max(tn, PLAIN_CHUNK // tn * tn)
    vals = torch.empty((M, n_pad // (GROUP * stride)), dtype=torch.float32, device=q.device)
    ids = torch.empty(vals.shape, dtype=torch.int32, device=q.device)
    qf = q.to(torch.float32)
    for n0 in range(0, n_pad, chunk):
        n1 = min(n_pad, n0 + chunk)
        s = qf @ corpus[n0:min(n1, N)].to(torch.float32).T
        s = torch.nn.functional.pad(s, (0, n1 - n0 - s.shape[1]))
        col = torch.arange(n0, n1, device=q.device, dtype=torch.int32)
        s = torch.where(col < n_real, s, float("-inf")).reshape(M, -1, GROUP)
        v, arg = s.max(-1)           # the first maximum, as jnp.argmax
        i = (col[::GROUP] + arg).to(torch.int32)
        v = v.reshape(M, -1, stride, g2)
        i = i.reshape(M, -1, stride, g2)
        best_v, best_i = v[:, :, 0], i[:, :, 0]
        for t in range(1, stride):
            better = v[:, :, t] > best_v
            best_v = torch.where(better, v[:, :, t], best_v)
            best_i = torch.where(better, i[:, :, t], best_i)
        o0, o1 = n0 // (GROUP * stride), n1 // (GROUP * stride)
        vals[:, o0:o1] = best_v.reshape(M, -1)
        ids[:, o0:o1] = best_i.reshape(M, -1)
    return vals, ids


# ------------------------------------------------------------------ K1 ------

def _check_int8(q_int, corpus_rows, d_scale, n_real):
    _, N, D = _check_pair(q_int, corpus_rows, torch.int8)
    if (d_scale.dtype != torch.float32 or tuple(d_scale.shape) != (N,)
            or not d_scale.is_contiguous()):
        raise ValueError(f"d_scale must be a contiguous [{N}] float32 tensor, "
                         f"got {d_scale.dtype} {tuple(d_scale.shape)}")
    if d_scale.device != q_int.device:
        raise ValueError("q_int, corpus_rows and d_scale must share a device")
    _check_int8_width(D)
    return _n_real(n_real, N)


def group_max_packed_int8_plain(q_int, corpus_rows, d_scale, n_real: int):
    """The same packed group maxima with torch ops: an f32 matmul of the
    int8 values (exact: |dot| <= D*127^2 < 2^24), the same epilogue,
    chunked over docs."""
    qf = q_int.to(torch.float32)
    return _packed_max_plain(
        q_int.shape[0], corpus_rows.shape[0], n_real,
        lambda n0, n1: (qf @ corpus_rows[n0:n1].to(torch.float32).T) * d_scale[n0:n1],
        q_int.device)


def group_max_packed_int8(q_int: torch.Tensor, corpus_rows: torch.Tensor,
                          d_scale: torch.Tensor, n_real: int = None) -> torch.Tensor:
    """-> packed group maxima [M, ceil(N/128)] f32: per 128-doc group, the
    max of float(int8 dot) * d_scale[n] with the doc's lane (n & 127) in the
    low 7 mantissa bits; docs n >= n_real (default N) score -3e38.
    CPU tensors take the plain version; CUDA tensors launch K1."""
    n_real = _check_int8(q_int, corpus_rows, d_scale, n_real)
    if q_int.device.type == "cpu":
        return group_max_packed_int8_plain(q_int, corpus_rows, d_scale, n_real)
    (M, D), N = q_int.shape, corpus_rows.shape[0]
    _check_cuda_rows(D, q_int, corpus_rows)
    out = torch.empty((M, _groups(N)), dtype=torch.float32, device=q_int.device)
    if out.numel() == 0:
        return out
    lib = _build.load_library()
    with torch.cuda.device(q_int.device):
        rc = lib.qfr_group_max_packed_int8(
            q_int.data_ptr(), corpus_rows.data_ptr(), d_scale.data_ptr(),
            M, N, D, n_real, out.data_ptr(), _build.stream_of(q_int))
    _build.check(lib, rc, "group_max_packed_int8")
    LAUNCHES["group_max_packed_int8"] += 1
    return out


# ------------------------------------------------------------------ K7 ------

def group_max_packed_plain(q, corpus, n_real: int, transposed: bool = False):
    """K7 with torch ops: f32 matmul of the bf16 operands (each product is
    exact in f32; only the summation order differs from the kernel), the
    packed epilogue of K1."""
    qf = q.to(torch.float32)
    if transposed:
        def scores(n0, n1):
            return qf @ corpus[:, n0:n1].to(torch.float32)
    else:
        def scores(n0, n1):
            return qf @ corpus[n0:n1].to(torch.float32).T
    N = corpus.shape[1] if transposed else corpus.shape[0]
    return _packed_max_plain(q.shape[0], N, n_real, scores, q.device)


def group_max_packed(q: torch.Tensor, corpus: torch.Tensor, n_real: int = None,
                     transposed: bool = False) -> torch.Tensor:
    """bf16 q [M, D] x corpus [N, D] ([D, N] when transposed) -> packed
    group maxima [M, ceil(N/128)] f32: per 128-doc group, the max f32 score
    with the doc's lane in the low 7 mantissa bits; docs n >= n_real
    (default N) score -3e38. CPU tensors take the plain version; CUDA
    tensors launch K7, which reads the [D, N] layout in place."""
    M, N, D = _check_pair(q, corpus, torch.bfloat16, transposed)
    n_real = _n_real(n_real, N)
    if q.device.type == "cpu":
        return group_max_packed_plain(q, corpus, n_real, transposed)
    _check_cuda_rows(2 * D, q, corpus)
    if transposed and N % 8:
        raise ValueError(f"a [D, N] bf16 corpus needs N % 8 == 0 (16-byte rows), got N={N}")
    out = torch.empty((M, _groups(N)), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    lib = _build.load_library()
    with torch.cuda.device(q.device):
        rc = lib.qfr_group_max_packed(q.data_ptr(), corpus.data_ptr(), M, N, D, n_real,
                                      int(transposed), out.data_ptr(), _build.stream_of(q))
    _build.check(lib, rc, "group_max_packed")
    LAUNCHES["group_max_packed"] += 1
    return out


# ------------------------------------------------------------------ K8 ------

def group_max_scores(q: torch.Tensor, corpus: torch.Tensor, n_real: int = None,
                     stride: int = 1, tn: int = 2048):
    """bf16 q [M, D] x corpus [N, D] -> (vals [M, N_pad/(128 stride)] f32,
    ids int32 global doc ids), N_pad = N rounded up to a multiple of tn:
    per 128-doc group the max score and its first doc; docs n >= n_real
    (default N) and the pad score -inf; stride > 1 merges group j of each
    tn tile with j + g2, j + 2 g2, ... (g2 = tn/(128 stride)), the earlier
    block winning ties. CPU tensors take the plain version; CUDA tensors
    launch K8."""
    M, N, D = _check_pair(q, corpus, torch.bfloat16)
    n_real = _n_real(n_real, N)
    if stride < 1 or tn < GROUP * stride or tn % (GROUP * stride):
        raise ValueError(f"tn={tn} must be a positive multiple of 128*stride "
                         f"(stride={stride})")
    if q.device.type == "cpu":
        return group_max_scores_plain(q, corpus, n_real, stride, tn)
    _check_cuda_rows(2 * D, q, corpus)
    n_out = -(-N // tn) * tn // (GROUP * stride)
    vals = torch.empty((M, n_out), dtype=torch.float32, device=q.device)
    ids = torch.empty((M, n_out), dtype=torch.int32, device=q.device)
    if vals.numel() == 0:
        return vals, ids
    lib = _build.load_library()
    with torch.cuda.device(q.device):
        rc = lib.qfr_group_max_scores(q.data_ptr(), corpus.data_ptr(), M, N, D, n_real,
                                      n_out, tn // GROUP, stride, vals.data_ptr(),
                                      ids.data_ptr(), _build.stream_of(q))
    _build.check(lib, rc, "group_max_scores")
    LAUNCHES["group_max_scores"] += 1
    return vals, ids


# ------------------------------------------------------------------ K9 ------

def group_max_packed_int8_global_plain(q_int, corpus_rows, n_real: int):
    """K9 with torch ops: the exact int32 dots (an f32 matmul, exact below
    2^24), the pad score for docs >= n_real and for the columns that fill
    the last group, (s << 7) | lane as s * 128 | lane, an integer max."""
    M, N = q_int.shape[0], corpus_rows.shape[0]
    out = torch.empty((M, _groups(N)), dtype=torch.int32, device=q_int.device)
    qf = q_int.to(torch.float32)
    for n0 in range(0, N, PLAIN_CHUNK):
        n1 = min(N, n0 + PLAIN_CHUNK)
        s = (qf @ corpus_rows[n0:n1].to(torch.float32).T).to(torch.int32)
        s = torch.nn.functional.pad(s, (0, (-(n1 - n0)) % GROUP), value=INT8_PAD)
        col = torch.arange(n0, n0 + s.shape[1], device=q_int.device, dtype=torch.int32)
        s = torch.where(col < n_real, s, INT8_PAD)
        packed = (s * 128) | (col & 0x7F)
        out[:, n0 // GROUP:_groups(n1)] = packed.reshape(M, -1, GROUP).amax(-1)
    return out


def group_max_packed_int8_global(q_int: torch.Tensor, corpus_rows: torch.Tensor,
                                 n_real: int = None) -> torch.Tensor:
    """int8 q [M, D] x int8 corpus rows [N, D] under one global scale ->
    packed int32 group maxima [M, ceil(N/128)]: (dot << 7) | lane; docs
    n >= n_real (default N) score -(1 << 24), which packs to INT32_MIN | lane.
    CPU tensors take the plain version; CUDA tensors launch K9."""
    M, N, D = _check_pair(q_int, corpus_rows, torch.int8)
    n_real = _n_real(n_real, N)
    _check_int8_width(D)
    if q_int.device.type == "cpu":
        return group_max_packed_int8_global_plain(q_int, corpus_rows, n_real)
    _check_cuda_rows(D, q_int, corpus_rows)
    out = torch.empty((M, _groups(N)), dtype=torch.int32, device=q_int.device)
    if out.numel() == 0:
        return out
    lib = _build.load_library()
    with torch.cuda.device(q_int.device):
        rc = lib.qfr_group_max_int8_global(q_int.data_ptr(), corpus_rows.data_ptr(), M, N,
                                           D, n_real, out.data_ptr(), _build.stream_of(q_int))
    _build.check(lib, rc, "group_max_packed_int8_global")
    LAUNCHES["group_max_packed_int8_global"] += 1
    return out


# ------------------------------------------------------ top-k wrappers -----

def _pad_k(top_vals, top_ids, k):
    """Pad to k columns (-inf / -1) and give -1 to every non-finite score."""
    kk = top_vals.shape[-1]
    if kk < k:
        top_vals = torch.nn.functional.pad(top_vals, (0, k - kk), value=float("-inf"))
        top_ids = torch.nn.functional.pad(top_ids, (0, k - kk), value=-1)
    return top_vals, torch.where(torch.isfinite(top_vals), top_ids, -1)


def dense_topk_int8(queries: torch.Tensor, corpus_rows: torch.Tensor,
                    d_scale: torch.Tensor, k: int = 100):
    """Quantized fused dense top-k -> (scores [B, k], ids [B, k] int32).

    Queries quantize per row; the kernel's packed group maxima go through
    an exact top-k with lax.top_k's tie order; the per-query scale
    multiplies only the k winners (a positive row factor never reorders a
    row). Counterpart of pallas_dense_topk_int8(exact_merge=True)."""
    q_int, q_scale = quantize_rows(queries.to(torch.float32))
    vals = group_max_packed_int8(q_int, corpus_rows, d_scale)
    tv, tx = topk_first(vals, min(k, vals.shape[-1]))
    clean, lane = unpack_lane(tv)
    top_ids = tx.to(torch.int32) * GROUP + lane
    top_vals = torch.where(clean > NEG_FINITE / 2, clean * q_scale, float("-inf"))
    return _pad_k(top_vals, top_ids, k)


def pallas_dense_topk(queries: torch.Tensor, corpus: torch.Tensor, k: int = 100,
                      tn: int = 2048, exact_merge: bool = False, stride: int = 1,
                      packed: bool = True, transposed: bool = False):
    """Fused bf16 dense top-k -> (scores [B, k], ids [B, k] int32).

    Queries round to the corpus dtype (bf16). packed (default): K7's packed
    group maxima, an exact merge, ids from (column, lane), scores with the
    lane bits cleared (<= 2^-16 relative). packed=False: K8's (max, argmax)
    at `stride`, grouped by the tn tile. The merge is always exact, so
    `exact_merge` (kept for the JAX signature) changes nothing."""
    del exact_merge
    if packed and stride != 1:
        raise ValueError("packed=True supports stride=1 only; pass packed=False "
                         "for stride coarsening")
    if transposed and not packed:
        raise ValueError("transposed corpus layout is supported on the packed path only")
    if corpus.dtype != torch.bfloat16:
        raise ValueError(f"the fused dense kernels take a bf16 corpus, got {corpus.dtype}; "
                         "ops.dense.dense_topk serves other dtypes")
    q = queries.to(torch.bfloat16).contiguous()
    if packed:
        vals = group_max_packed(q, corpus, transposed=transposed)
        tv, tx = topk_first(vals, min(k, vals.shape[-1]))
        clean, lane = unpack_lane(tv)
        top_ids = tx.to(torch.int32) * GROUP + lane
        top_vals = torch.where(clean > NEG_FINITE / 2, clean, float("-inf"))
    else:
        vals, ids = group_max_scores(q, corpus, stride=stride, tn=tn)
        top_vals, tx = topk_first(vals, min(k, vals.shape[-1]))
        top_ids = torch.gather(ids, -1, tx)
    return _pad_k(top_vals, top_ids, k)


def pallas_dense_topk_int8_global(queries: torch.Tensor, corpus_rows: torch.Tensor,
                                  corpus_scale, k: int = 100):
    """Global-scale int8 fused top-k -> (scores [B, k], ids [B, k] int32):
    queries quantize per row, K9 reduces in int32, the exact merge ranks
    the packed ints, and both scales multiply the k winners only. The
    corpus is rows [N, D] int8 (quantize_global) where the JAX function
    takes [D, N]; the result is JAX's with exact_merge=True."""
    q_int, q_scale = quantize_rows(queries.to(torch.float32))
    _check_int8_width(queries.shape[1])
    vals = group_max_packed_int8_global(q_int, corpus_rows)
    tv, tx = topk_first(vals, min(k, vals.shape[-1]))
    score_i = tv >> 7
    top_ids = tx.to(torch.int32) * GROUP + (tv & 0x7F)
    scale = q_scale * torch.as_tensor(corpus_scale, dtype=torch.float32, device=q_scale.device)
    # the pad unpacks to exactly -(1 << 24); real scores stay above it
    top_vals = torch.where(score_i > INT8_PAD, score_i.to(torch.float32) * scale,
                           float("-inf"))
    return _pad_k(top_vals, top_ids, k)


def _project(queries, view_proj):
    """[B, D] x [R, D, Dv] -> f32 [R, B, Dv] (the JAX einsum, in f32)."""
    return torch.einsum("bd,rdv->rbv", queries.to(torch.float32),
                        view_proj.to(torch.float32))


def pallas_multi_view_topk(queries: torch.Tensor, view_proj: torch.Tensor,
                           corpus: torch.Tensor, k: int = 100, transposed: bool = False):
    """R-view fused dense top-k on K7: the queries project in f32, then
    round to bf16 inside pallas_dense_topk. The corpus is bf16 [N, Dv], or
    [Dv, N] with transposed=True. -> (scores [R, B, k], ids [R, B, k])."""
    qv = _project(queries, view_proj)
    R, B, Dv = qv.shape
    vals, ids = pallas_dense_topk(qv.reshape(R * B, Dv), corpus, k=k, transposed=transposed)
    return vals.reshape(R, B, k), ids.reshape(R, B, k)


def pallas_multi_view_topk_int8(queries: torch.Tensor, view_proj: torch.Tensor,
                                corpus_rows: torch.Tensor, d_scale: torch.Tensor,
                                k: int = 100):
    """R-view quantized dense top-k on K1 over int8 rows [N, Dv] and
    per-doc scales [N]. -> (scores [R, B, k], ids [R, B, k])."""
    qv = _project(queries, view_proj)
    R, B, Dv = qv.shape
    vals, ids = dense_topk_int8(qv.reshape(R * B, Dv), corpus_rows, d_scale, k=k)
    return vals.reshape(R, B, k), ids.reshape(R, B, k)
