"""Shared segmented-aggregation primitives over the last axis.

Counterpart of qpp_fusion_rag_tpu/ops/segment.py. The JAX functions take
one row and are vmapped by their callers; these take [..., M] directly.
Selection is always exact: ``topk_first`` reproduces ``lax.top_k``'s
lowest-index-first tie order, which matters because the q8 run sums are
small integers and tie constantly.
"""

from __future__ import annotations

import torch

SENTINEL = 2**31 - 1


def topk_first(x: torch.Tensor, k: int):
    """Top-k along the last axis, ties broken lowest index first (the order
    of ``lax.top_k``): a stable descending sort, then a slice.
    -> (values [..., k], indices [..., k] int64)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def cumsum_blocked(x: torch.Tensor, block: int = 16) -> torch.Tensor:
    """Inclusive f32 prefix sums along the last axis in the order XLA's
    CPU backend computes a cumsum (its reduce-window rewrite): sequential
    within blocks of 16, plus the sequential prefix of the block totals.
    Matching it keeps the reference's rounding where results are sensitive
    to it: the QPP prefix variances subtract two such sums, and the fusion
    run sums are differences of one."""
    K = x.shape[-1]
    if K == 0:
        return x.clone()
    if K <= block:
        cols = [x[..., 0]]
        for i in range(1, K):
            cols.append(cols[-1] + x[..., i])
        return torch.stack(cols, dim=-1)
    xp = torch.nn.functional.pad(x, (0, (-K) % block))
    within = cumsum_blocked(xp.reshape(*x.shape[:-1], -1, block), block)
    totals = cumsum_blocked(within[..., -1], block)
    prefix = torch.nn.functional.pad(totals[..., :-1], (1, 0))
    return (within + prefix[..., None]).reshape(xp.shape)[..., :K]


def _run_last(sids: torch.Tensor) -> torch.Tensor:
    """True at the last position of each run of equal ids."""
    tail = torch.ones_like(sids[..., :1], dtype=torch.bool)
    return torch.cat([sids[..., 1:] != sids[..., :-1], tail], dim=-1)


def segmented_sums_presorted_i32(sids: torch.Tensor,
                                 ivals: torch.Tensor) -> torch.Tensor:
    """Per-run int32 sums at each run's LAST position, -1 elsewhere and on
    SENTINEL ids. sids ascending along the last axis, ivals >= 0; exact at
    any run length (row totals must stay < 2^31)."""
    svalid = sids != SENTINEL
    last = _run_last(sids)
    c = torch.cumsum(torch.where(svalid, ivals, 0), dim=-1, dtype=torch.int32)
    marked = torch.where(last, c, -1)
    shifted = torch.cat([torch.full_like(c[..., :1], -1), marked[..., :-1]], dim=-1)
    prev = torch.cummax(shifted, dim=-1).values   # last mark before each position
    sums = c - prev.clamp_min(0)
    return torch.where(last & svalid, sums, -1)


def segmented_topk_presorted(sids: torch.Tensor, svals: torch.Tensor, k: int,
                             count_bonus: bool = False):
    """Run sums of f32 contributions over ascending ids, then the exact
    top-k runs. -> (ids [..., k] (-1 pad), sums [..., k] (-inf pad),
    counts [..., k] (0 pad)); count_bonus scores sum * count (CombMNZ)."""
    M = sids.shape[-1]
    svalid = sids != SENTINEL
    last = _run_last(sids)
    # shift values non-negative so per-run cumsums are monotone and the
    # previous run's last cumsum reduces to a running maximum
    vmin = svals.amin(dim=-1, keepdim=True).clamp_max(0.0)
    sv = torch.where(svalid, svals - vmin, 0.0)
    c = cumsum_blocked(sv)
    cnt = torch.cumsum(svalid.to(torch.float32), dim=-1)   # exact integers

    def prev_last(x):
        marked = torch.where(last, x, float("-inf"))
        shifted = torch.cat([torch.full_like(x[..., :1], float("-inf")),
                             marked[..., :-1]], dim=-1)
        run = torch.cummax(shifted, dim=-1).values
        return torch.where(torch.isneginf(run), 0.0, run)

    counts = cnt - prev_last(cnt)
    sums = (c - prev_last(c)) + vmin * counts
    scores = sums * counts if count_bonus else sums
    scores = torch.where(last & svalid, scores, float("-inf"))
    top_vals, top_idx = topk_first(scores, min(k, M))
    top_ids = torch.gather(sids, -1, top_idx)
    ok = torch.isfinite(top_vals)
    return (torch.where(ok, top_ids, -1),
            torch.where(ok, top_vals, float("-inf")),
            torch.where(ok, torch.gather(counts, -1, top_idx), 0.0))


def segmented_topk(ids: torch.Tensor, vals: torch.Tensor, k: int,
                   count_bonus: bool = False):
    """Sum contributions per unique id (SENTINEL = invalid) -> exact top-k
    (ids, sums, counts); see segmented_topk_presorted. The id sort is
    stable, so equal ids keep their contribution order."""
    sids, order = torch.sort(ids, dim=-1, stable=True)
    return segmented_topk_presorted(sids, torch.gather(vals, -1, order), k,
                                    count_bonus=count_bonus)
