"""How `correct` is decided: the program's answers against the plain
reference's, by three numbers, each with a limit of its own (limits/<cell>.json).

    fused_score_gap  the largest gap, rank by rank, between the program's
                     fused scores and the reference's, over the query's
                     best reference score
    fused_id_gap     the widest gap by which the reference's own fused score
                     of a doc the program returned lies below the
                     reference's score at that rank, over the query's best
                     (a doc the reference never retrieved scores 0: a sum
                     over no run; a repeated id, or a pad where the
                     reference has a doc, counts 1)
    qpp_gap          per statistic, the largest gap between the program's
                     normalized QPP and the reference's over views and
                     queries; the largest over the 12 statistics other
                     than snqc

snqc raises |score - mean| to the power 0.109, whose slope has no bound
near 0: a last-bit change in the mean of near-tied scores moves it by
0.005-0.05 on sound runs, as far as a wrong column of another statistic
would. Its gap is reported beside the numbers (snqc_gap) and compared
with no limit.

A tie or a near-tie taken in another order costs the id gap only the
scores' difference, so the id gap needs no tie band.
"""

from __future__ import annotations

import torch

NUMBERS = ("fused_score_gap", "fused_id_gap", "qpp_gap")
SNQC = 10                      # snqc's column among the 13 statistics


def batch_gaps(prog: dict, ref: dict):
    """One batch. prog {"ids" [B, k_out], "scores" [B, k_out], "qpp" [R, B, 13]},
    ref {"ids" [B, C], "scores" [B, C] (the whole fused ranking), "qpp"}.
    -> (score gap [B], id gap [B], per-statistic qpp gap [13], per-query qpp
    gap over the statistics other than snqc [B]), float64 on the CPU."""
    p_ids = prog["ids"].to("cpu", torch.int64)
    p_s = prog["scores"].to("cpu", torch.float64)
    r_ids = ref["ids"].to("cpu", torch.int64)
    r_s = ref["scores"].to("cpu", torch.float64)
    B, K = p_ids.shape
    if r_ids.shape[1] < K:
        pad = K - r_ids.shape[1]
        r_ids = torch.nn.functional.pad(r_ids, (0, pad), value=-1)
        r_s = torch.nn.functional.pad(r_s, (0, pad), value=float("-inf"))
    top = torch.clamp(r_s[:, 0].abs(), min=1e-30)
    r_top = r_s[:, :K]
    p_real, r_real = p_ids >= 0, r_ids[:, :K] >= 0
    same = p_real == r_real

    diff = torch.where(p_real & r_real, (p_s - r_top).abs(), 0.0) / top[:, None]
    score_gap = torch.where(same.all(1), diff.amax(1), 1.0)

    by_id, perm = torch.sort(r_ids, dim=1)
    at = torch.clamp(torch.searchsorted(by_id, p_ids), max=by_id.shape[1] - 1)
    found = (torch.gather(by_id, 1, at) == p_ids) & p_real
    ref_of = torch.where(found, torch.gather(torch.gather(r_s, 1, perm), 1, at), 0.0)
    below = torch.where(p_real & r_real, (r_top - ref_of) / top[:, None], float("-inf"))
    srt = torch.sort(torch.where(p_real, p_ids, -1 - torch.arange(K)), dim=1).values
    repeated = (srt[:, 1:] == srt[:, :-1]).any(1)
    id_gap = torch.where(same.all(1) & ~repeated, torch.clamp(below.amax(1), min=0.0), 1.0)

    qd = (prog["qpp"].to("cpu", torch.float64) - ref["qpp"].to("cpu", torch.float64)).abs()
    qd = torch.nan_to_num(qd, nan=1.0)
    rest = torch.cat([qd[..., :SNQC], qd[..., SNQC + 1:]], dim=-1)
    return score_gap, id_gap, qd.amax(dim=(0, 1)), rest.amax(dim=(0, 2))


def judge(pairs, limits: dict) -> dict:
    """pairs: [(prog, ref), ...] over the compared batches.
    -> {"numbers", "limits", "correct", "checked" (queries), "failed"
        (queries past a limit), "qpp_by_statistic", "snqc_gap"}."""
    score_gaps, id_gaps, query_gaps, qpp = [], [], [], None
    for prog, ref in pairs:
        s, i, q, qq = batch_gaps(prog, ref)
        score_gaps.append(s)
        id_gaps.append(i)
        query_gaps.append(qq)
        qpp = q if qpp is None else torch.maximum(qpp, q)
    s, i, qq = torch.cat(score_gaps), torch.cat(id_gaps), torch.cat(query_gaps)
    numbers = {"fused_score_gap": float(s.max()), "fused_id_gap": float(i.max()),
               "qpp_gap": float(qq.max())}
    lim = {n: float(limits[n]) for n in NUMBERS}
    failed = int(((s > lim["fused_score_gap"]) | (i > lim["fused_id_gap"])
                  | (qq > lim["qpp_gap"])).sum())
    correct = all(numbers[n] <= lim[n] for n in NUMBERS)
    return {"numbers": numbers, "limits": lim, "correct": correct, "checked": int(s.numel()),
            "failed": failed, "qpp_by_statistic": [float(x) for x in qpp],
            "snqc_gap": float(qpp[SNQC])}
