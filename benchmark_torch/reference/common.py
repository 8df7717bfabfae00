"""Plain PyTorch pieces that the step references share: the dense views'
group-max top-k, the 13 QPP statistics, the normalizations and weighted
CombSUM. Written from the semantics of the published method (the Java QPP
statistics of QPP-Fusion-RAG as the JAX package states them), not from the
port's code, and importing nothing of the program.

``ft`` is the float type the float32 arithmetic runs in: float32 for the
reference, bfloat16 for the control (the precision one step below the one
the configurations state for scores, QPP and fusion).
"""

from __future__ import annotations

import math

import torch

GROUP = 128                   # docs that offer one candidate to the dense merge
LANE = 0x7F                   # a doc's lane in its group: the low 7 bits of its score
QPP_CUTOFF = 50               # the statistics read the top min(50, n) scores
SNQC_POWER = 0.33 * 0.33


def exact_float32() -> None:
    """float32 products stay float32: no TF32 in matmuls."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def quantize_rows(x: torch.Tensor):
    """Symmetric per-row int8 quantization, scale = max|x| / 127 (taken as
    max|x| times the float32 reciprocal of 127), 1 for a zero row.
    -> (integer values as f32 [M, D], scales f32 [M, 1])."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    s = torch.where(amax > 0, amax * (1.0 / 127.0), 1.0)
    return torch.clamp(torch.round(x / s), -127, 127), s


def group_max_topk(q: torch.Tensor, rows: torch.Tensor, k: int, row_scale=None,
                   chunk: int = 65_536):
    """The dense views' top-k: each doc scores q . row in f32 (times
    row_scale[doc] where given); every group of 128 consecutive docs offers
    its best doc, its score's low 7 bits replaced by the doc's lane before
    the max; the k best offers, ties lowest group first, give the doc id and
    its score with the lane bits cleared.
    q f32 [M, D]; rows [N, D] int8 or bf16. -> (scores f32 [M, k], ids int64 [M, k])."""
    M, N = q.shape[0], rows.shape[0]
    groups = -(-N // GROUP)
    best = torch.empty((M, groups), dtype=torch.float32, device=q.device)
    for n0 in range(0, N, chunk):
        n1 = min(N, n0 + chunk)
        s = q @ rows[n0:n1].to(torch.float32).T
        if row_scale is not None:
            s = s * row_scale[n0:n1]
        lane = torch.arange(n0, n1, dtype=torch.int32, device=q.device) & LANE
        offer = ((s.view(torch.int32) & ~LANE) | lane).view(torch.float32)
        del s
        pad = (-(n1 - n0)) % GROUP
        if pad:
            offer = torch.nn.functional.pad(offer, (0, pad), value=float("-inf"))
        best[:, n0 // GROUP:-(-n1 // GROUP)] = offer.reshape(M, -1, GROUP).amax(-1)
        del offer
    vals, gidx = torch.sort(best, dim=-1, descending=True, stable=True)
    bits = vals[:, :k].view(torch.int32)
    ids = gidx[:, :k] * GROUP + (bits & LANE).to(torch.int64)
    return (bits & ~LANE).view(torch.float32), ids


def qpp13(s: torch.Tensor, valid: torch.Tensor, text: torch.Tensor,
          cutoff: int = QPP_CUTOFF) -> torch.Tensor:
    """The 13 statistics of each score list, in this column order: nqc,
    smv, wig, SigmaMax, SigmaX, RSD, UEF, MaxIDF, avgidf, cumnqc, snqc,
    dense-qpp, dense-qpp-m. s [..., K] descending scores, valid [..., K]
    (a prefix of each row), text [..., 4] (terms, unique terms, longest
    term, mean term length), all in the dtype of s. -> [..., 13]."""
    ft = s.dtype
    K = s.shape[-1]
    idx = torch.arange(K, device=s.device)
    m = torch.clamp(valid.sum(-1), max=cutoff)
    mask = idx < m[..., None]
    s = torch.where(mask, s, torch.zeros((), dtype=ft, device=s.device))
    mf = torch.clamp(m, min=1).to(ft)
    zero = torch.zeros((), dtype=ft, device=s.device)
    n_terms = torch.clamp(text[..., 0], min=1.0)
    n_unique, max_len, avg_len = text[..., 1], text[..., 2], text[..., 3]

    mean = s.sum(-1) / mf
    dev = torch.where(mask, s - mean[..., None], zero)
    var = (dev * dev).sum(-1) / mf
    std = torch.sqrt(var)
    nqc = var
    mu = torch.where(mean > 0, mean, 1.0)
    pos = mask & (s > 0)
    smv = torch.where(pos, s * torch.abs(torch.log(torch.where(pos, s, 1.0) / mu[..., None])),
                      zero).sum(-1) / mf
    wig = (torch.where(mask, s - 1.0 / torch.clamp(mean, min=0.01)[..., None], zero).sum(-1)
           / (n_terms * mf))

    j = torch.arange(1, K + 1, device=s.device).to(ft)
    pmean = torch.cumsum(s, -1) / j
    pvar = torch.clamp(torch.cumsum(s * s, -1) / j - pmean * pmean, min=0.0)
    prefix = (idx >= 1) & mask                       # prefixes of 2..m scores
    sigma_max = torch.where(m >= 2, torch.where(prefix, torch.sqrt(pvar), zero).amax(-1)
                            / torch.sqrt(n_terms), zero)

    top = torch.where(mask, s, zero)[..., :1]
    sel = mask & (s >= 0.5 * top)
    n_sel = sel.sum(-1)
    c_sel = torch.clamp(n_sel, min=1).to(ft)
    smean = torch.where(sel, s, zero).sum(-1) / c_sel
    svar = torch.where(sel, (s - smean[..., None]) ** 2, zero).sum(-1) / c_sel
    sigma_x = torch.where((m >= 2) & (n_sel >= 2), torch.sqrt(svar), zero)

    z = dev / torch.clamp(std, min=1e-30)[..., None]
    rsd = torch.where((m >= 3) & (std >= 1e-10), (z * z * z).sum(-1) / mf, zero)

    top20 = idx < torch.clamp(m, max=20)[..., None]
    dcg = 1.0 / (torch.log(j + 1.0) / math.log(2.0))
    uef = (torch.where(top20, s * dcg, zero).sum(-1)
           / torch.clamp(torch.where(top20, dcg, zero).sum(-1), min=1e-30))

    max_idf = torch.log(1.0 + n_unique) + 0.5 * torch.log(1.0 + max_len)
    avgidf = torch.log(1.0 + avg_len) * (n_unique / n_terms)
    cumnqc = torch.where(m >= 2, torch.where(prefix, pvar, zero).sum(-1)
                         / torch.clamp(m - 1, min=1).to(ft), zero)
    f2 = torch.where(pos, dev * dev / torch.where(pos, s, 1.0), zero)
    snqc = torch.where(mean > 0, torch.where(pos, torch.clamp(f2, min=0.0) ** SNQC_POWER,
                                             zero).sum(-1) / mf, zero)
    hi = torch.where(mask, s, float("-inf")).amax(-1)
    lo = torch.where(mask, s, float("inf")).amin(-1)
    spread = hi - lo
    dense = torch.where((m >= 2) & (spread > 0),
                        torch.log(1.0 + 1.0 / torch.where(spread > 0, spread, 1.0)), zero)

    cols = [nqc, smv, wig, sigma_max, sigma_x, rsd, uef, max_idf, avgidf, cumnqc, snqc,
            dense, dense]
    out = torch.stack(torch.broadcast_tensors(*cols), dim=-1).to(ft)
    return torch.where((m > 0)[..., None], out, zero)


def minmax_over_batch(qpp: torch.Tensor) -> torch.Tensor:
    """[R, B, 13] -> each (view, statistic) mapped onto [0, 1] by its min and
    max over the batch; a constant column maps to 0.5."""
    lo = qpp.amin(dim=1, keepdim=True)
    hi = qpp.amax(dim=1, keepdim=True)
    return torch.where(hi > lo, (qpp - lo) / torch.where(hi > lo, hi - lo, 1.0), 0.5)


def combsum(ids: torch.Tensor, vals: torch.Tensor, weights: torch.Tensor):
    """Weighted CombSUM of R runs: each run's valid scores mapped onto [0, 1]
    by its own min and max (a constant run maps to 0), times its weight,
    summed per doc. ids [R, B, K] (-1 pad), vals [R, B, K], weights [R, B].
    -> the whole fused ranking, descending, ties lowest doc id first:
       (ids int64 [B, C] (-1 pad), scores f32 [B, C] (-inf pad))."""
    R, B, K = ids.shape
    ft = vals.dtype
    valid = ids >= 0
    lo = torch.where(valid, vals, float("inf")).amin(-1, keepdim=True)
    hi = torch.where(valid, vals, float("-inf")).amax(-1, keepdim=True)
    norm = (vals - torch.where(torch.isfinite(lo), lo, 0.0)) / torch.where(hi > lo, hi - lo, 1.0)
    contrib = torch.where(valid, weights[..., None].to(ft) * norm, 0.0).to(ft)

    flat_ids = ids.permute(1, 0, 2).reshape(B, R * K).long()
    flat_c = contrib.permute(1, 0, 2).reshape(B, R * K)
    keep = flat_ids >= 0
    span = int(flat_ids.max()) + 1 if keep.any() else 1
    row = torch.arange(B, device=ids.device)[:, None].expand(B, R * K)
    key, inv = torch.unique(row[keep] * span + flat_ids[keep], return_inverse=True)
    sums = torch.zeros(key.numel(), dtype=ft, device=ids.device).index_add_(0, inv, flat_c[keep])
    krow, kdoc = key // span, key % span
    counts = torch.bincount(krow, minlength=B)
    C = int(counts.max()) if key.numel() else 1
    col = torch.arange(key.numel(), device=ids.device) - (torch.cumsum(counts, 0) - counts)[krow]
    out_ids = torch.full((B, C), -1, dtype=torch.int64, device=ids.device)
    out_s = torch.full((B, C), float("-inf"), dtype=torch.float32, device=ids.device)
    out_ids[krow, col] = kdoc
    out_s[krow, col] = sums.to(torch.float32)
    order = torch.sort(out_s, dim=-1, descending=True, stable=True).indices
    return torch.gather(out_ids, -1, order), torch.gather(out_s, -1, order)


def fuse_views(ids: torch.Tensor, vals: torch.Tensor, text: torch.Tensor, qpp_index: int):
    """QPP per view, normalized over the batch, then CombSUM weighted by
    column `qpp_index`. ids [R, B, K], vals [R, B, K] in the float type,
    text [B, 4]. -> {"ids", "scores"} (the whole fused ranking) and "qpp"
    [R, B, 13] f32."""
    ft = vals.dtype
    valid = ids >= 0
    raw = qpp13(torch.where(valid, vals, 0.0).to(ft), valid, text.to(vals.device, ft))
    qpp = minmax_over_batch(raw)
    f_ids, f_scores = combsum(ids, vals, qpp[..., qpp_index])
    return {"ids": f_ids, "scores": f_scores, "qpp": qpp.to(torch.float32)}
