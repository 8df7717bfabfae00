"""The 13 QPP statistics as one batched reduction: scores [..., K] -> [..., 13].

Counterpart of qpp_fusion_rag_tpu/ops/qpp.py (the host's query-text
features, qpp_kernel and the normalization helpers). The JAX kernel takes
[Q, K] and is vmapped over retrievers; this one takes any leading dims.
Column order:
[nqc, smv, wig, SigmaMax, SigmaX, RSD, UEF, MaxIDF, avgidf, cumnqc, snqc,
 dense-qpp, dense-qpp-m].
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

from qpp_fusion_rag_tpu_torch import tracing as T
from qpp_fusion_rag_tpu_torch.ops import graphs as G
from qpp_fusion_rag_tpu_torch.ops.segment import cumsum_blocked

N_METHODS = 13
DEFAULT_CUTOFF = 50   # k = min(50, |scores|)

METHOD_NAMES: List[str] = [
    "nqc", "smv", "wig", "SigmaMax", "SigmaX", "RSD", "UEF",
    "MaxIDF", "avgidf", "cumnqc", "snqc", "dense-qpp", "dense-qpp-m",
]


def text_features(query_text: str) -> Tuple[float, float, float, float]:
    """(num_terms, num_unique, max_term_len, avg_term_len) of a query, split
    as Java's ``text.toLowerCase().split("\\\\s+")``: an empty string is
    one empty term (num_terms 1, max_len 0, avg_len 0)."""
    terms = query_text.lower().split()
    if not terms:
        terms = [""]
    unique = set(terms)
    return (float(len(terms)), float(len(unique)), float(max(len(t) for t in unique)),
            float(sum(len(t) for t in terms) / len(terms)))


def text_features_batch(query_texts: Sequence[str]) -> np.ndarray:
    """-> the [B, 4] f32 host array every step takes as text_feats."""
    return np.array([text_features(t) for t in query_texts], dtype=np.float32)


def _sum_in_order(x: torch.Tensor) -> torch.Tensor:
    """f32 sum along the last axis, strictly left to right: deterministic
    and identical on every device, and the order XLA's CPU backend reduces
    a short row in (measured at K=32; at K=100 it differs). The mean needs
    it: snqc raises |s - mean| to the 0.109th power, so a one-ulp change in
    the mean of tied scores moves snqc by ~1e-2."""
    acc = x[..., 0]
    for i in range(1, x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def qpp_kernel(scores: torch.Tensor, n_valid: torch.Tensor,
               text_feats: torch.Tensor, cutoff: int = DEFAULT_CUTOFF) -> torch.Tensor:
    """scores [..., K] desc-sorted (padding masked by n_valid [...]),
    text_feats [..., 4] (num_terms, num_unique, max_len, avg_len), leading
    dims broadcast. -> raw (un-normalized) statistics [..., 13]. On a CUDA
    device a repeated call replays a captured graph of qpp_statistics
    (ops/graphs.py, site "qpp"); elsewhere it runs qpp_statistics."""
    return G.replay_or_run("qpp", qpp_statistics, (scores, n_valid, text_feats),
                           {"cutoff": cutoff})


def qpp_statistics(scores: torch.Tensor, n_valid: torch.Tensor,
                   text_feats: torch.Tensor, cutoff: int = DEFAULT_CUTOFF) -> torch.Tensor:
    """qpp_kernel's eager route: the statistics op by op."""
    with T.span("qpp.mean"):
        K = scores.shape[-1]
        s = scores.to(torch.float32)
        m = torch.clamp(n_valid.to(torch.int32), max=cutoff)
        idx = torch.arange(K, dtype=torch.int32, device=s.device)
        mask = idx < m[..., None]
        sm = torch.where(mask, s, 0.0)
        mf_sum = torch.clamp(m.to(torch.float32), min=1.0)
        neg_inf, pos_inf = float("-inf"), float("inf")

        num_terms = torch.clamp(text_feats[..., 0], min=1.0)
        num_unique = text_feats[..., 1]
        max_len = text_feats[..., 2]
        avg_len = text_feats[..., 3]

        mean = _sum_in_order(sm) / mf_sum

    with T.span("qpp.moments"):
        dev = s - mean[..., None]
        var = torch.where(mask, dev ** 2, 0.0).sum(-1) / mf_sum
        std = torch.sqrt(var)

        # 1. NQC — variance * avgIDF(=1)
        nqc = torch.where(m > 0, var, 0.0)

        # 2. SMV — mean over k of s*|log(s/muHat)| for s>0
        mu_hat = torch.where(mean > 0, mean, 1.0)
        pos = mask & (s > 0)
        smv_terms = torch.where(
            pos, s * torch.abs(torch.log(torch.where(pos, s, 1.0) / mu_hat[..., None])), 0.0)
        smv = torch.where(m > 0, smv_terms.sum(-1) / mf_sum, 0.0)

        # 3. WIG — sum(s - 1/max(0.01, mean)) / (numTerms * k)
        baseline = 1.0 / torch.clamp(mean, min=0.01)
        wig_sum = torch.where(mask, s - baseline[..., None], 0.0).sum(-1)
        wig = torch.where(m > 0, wig_sum / (num_terms * mf_sum), 0.0)

    with T.span("qpp.prefix"):
        # prefix sums for the prefix-window statistics
        c1 = cumsum_blocked(sm)
        c2 = cumsum_blocked(sm * sm)
        j = (idx + 1).to(torch.float32)
        pref_mean = c1 / j
        # one rounding for c2/j - mean^2, as the reference's compiled program
        # contracts it into a fused multiply-add (the f64 product is exact)
        pref_var = torch.clamp(
            ((c2 / j).double() - pref_mean.double() ** 2).to(torch.float32), min=0.0)
        pref_sigma = torch.sqrt(pref_var)

        # 4. SigmaMax — max prefix std (prefix len in [2, m]) / sqrt(numTerms)
        pref_ok = (idx >= 1) & mask
        sigma_max = torch.where(pref_ok, pref_sigma, 0.0).amax(-1)
        sigma_max = torch.where(
            m >= 2, sigma_max / torch.sqrt(torch.clamp(num_terms, min=1.0)), 0.0)

    with T.span("qpp.columns"):
        # 5. SigmaX — std of scores >= 0.5*top1; 0 unless >= 2 qualify
        thresh = 0.5 * sm[..., 0]
        fsel = mask & (s >= thresh[..., None])
        fc = fsel.to(torch.float32).sum(-1)
        fmean = torch.where(fsel, s, 0.0).sum(-1) / torch.clamp(fc, min=1.0)
        fvar = (torch.where(fsel, (s - fmean[..., None]) ** 2, 0.0).sum(-1)
                / torch.clamp(fc, min=1.0))
        sigma_x = torch.where((m >= 2) & (fc >= 2), torch.sqrt(fvar), 0.0)

        # 6. RSD — population skewness; 0 if m < 3 or std < 1e-10
        z3 = torch.where(mask, (dev / torch.clamp(std[..., None], min=1e-30)) ** 3, 0.0)
        skew = z3.sum(-1) / mf_sum
        rsd = torch.where((m >= 3) & (std >= 1e-10), skew, 0.0)

        # 7. UEF — DCG-weighted mean of the top-min(20, m) scores
        uef_mask = idx < torch.clamp(m, max=20)[..., None]
        w = 1.0 / (torch.log(j + 1.0) / math.log(2.0))   # 1/log2(i+2), i 0-based
        uef_num = torch.where(uef_mask, s * w, 0.0).sum(-1)
        uef_den = torch.where(uef_mask, w, 0.0).sum(-1)
        uef = torch.where(m > 0, uef_num / torch.clamp(uef_den, min=1e-30), 0.0)

        # 8. MaxIDF proxy — log(1+unique) + 0.5*log(1+maxTermLen)
        max_idf = torch.log(1.0 + num_unique) + 0.5 * torch.log(1.0 + max_len)
        # 9. avgidf proxy — log(1+avgTermLen) * (unique/terms)
        avgidf = torch.log(1.0 + avg_len) * (num_unique / num_terms)

        # 10. cumnqc — mean over prefixes 2..m of NQC(prefix)
        cumnqc_sum = torch.where(pref_ok, pref_var, 0.0).sum(-1)
        cumnqc = torch.where(
            m >= 2, cumnqc_sum / torch.clamp(m.to(torch.float32) - 1.0, min=1.0), 0.0)

        # 11. snqc — mean over k of (((s-mean)^2/s)^beta)^gamma for s>0
        beta_gamma = 0.33 * 0.33
        f2 = torch.where(pos, dev ** 2 / torch.where(pos, s, 1.0), 0.0)
        snqc_terms = torch.where(pos, torch.pow(torch.clamp(f2, min=0.0), beta_gamma), 0.0)
        snqc = torch.where((m > 0) & (mean > 0), snqc_terms.sum(-1) / mf_sum, 0.0)

        # 12/13. dense-qpp proxies — log(1 + 1/(max-min)); 0 if m<2 or range==0
        rng = (torch.where(mask, s, neg_inf).amax(-1)
               - torch.where(mask, s, pos_inf).amin(-1))
        dense = torch.where((m >= 2) & (rng > 0),
                            torch.log(1.0 + 1.0 / torch.where(rng > 0, rng, 1.0)), 0.0)

        cols = [nqc, smv, wig, sigma_max, sigma_x, rsd, uef, max_idf, avgidf,
                cumnqc, snqc, dense, dense]
        out = torch.stack(torch.broadcast_tensors(*cols), dim=-1)
        return torch.where((m > 0)[..., None], out, 0.0)


def normalize_qpp(qpp: torch.Tensor, method: str = "minmax") -> torch.Tensor:
    """Normalize each column of [Q, M] across queries. minmax:
    (v - min) / (max - min), range 1 where degenerate; zscore:
    (v - mean) / std (population std, 1 where 0); anything else: as is."""
    if method == "minmax":
        vmin = qpp.amin(dim=0, keepdim=True)
        vmax = qpp.amax(dim=0, keepdim=True)
        return (qpp - vmin) / torch.where(vmax > vmin, vmax - vmin, 1.0)
    if method == "zscore":
        mean = qpp.mean(dim=0, keepdim=True)
        std = qpp.std(dim=0, keepdim=True, correction=0)
        return (qpp - mean) / torch.where(std > 0, std, 1.0)
    return qpp


def minmax_extrema(qpp: torch.Tensor):
    """Extrema over the query axis of [R, B, M] raw QPP ->
    (vmin [R, 1, M], vmax [R, 1, M])."""
    return qpp.amin(dim=1, keepdim=True), qpp.amax(dim=1, keepdim=True)


def apply_minmax(qpp, vmin, vmax):
    """(v - min)/(max - min) per retriever x statistic; degenerate columns
    get 0.5, so weights never all vanish."""
    scale = torch.where(vmax > vmin, vmax - vmin, 1.0)
    return torch.where(vmax > vmin, (qpp - vmin) / scale, 0.5)


def qpp_calibration_stats(qpp_raw: torch.Tensor) -> torch.Tensor:
    """Frozen normalization statistics from a calibration batch of raw
    [R, B, M] QPP -> [R, 2, M] (min, max)."""
    vmin, vmax = minmax_extrema(qpp_raw)
    return torch.stack([vmin[:, 0, :], vmax[:, 0, :]], dim=1)


def normalize_qpp_with(qpp_raw: torch.Tensor, stats=None) -> torch.Tensor:
    """Normalize raw [R, B, M] QPP against frozen `stats` [R, 2, M]
    (clipped to [0, 1]), else by in-batch min-max."""
    with T.span("qpp_norm"):
        if stats is not None:
            vmin = stats[:, 0][:, None, :]
            vmax = stats[:, 1][:, None, :]
            return torch.clamp(apply_minmax(qpp_raw, vmin, vmax), 0.0, 1.0)
        vmin, vmax = minmax_extrema(qpp_raw)
        return apply_minmax(qpp_raw, vmin, vmax)
