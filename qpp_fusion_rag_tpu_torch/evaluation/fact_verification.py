"""Fact-verification evaluation: 3-way label accuracy + evidence metrics.

Counterpart of qpp_fusion_rag_tpu/evaluation/fact_verification.py, copied (host
Python).

Mirrors the reference evaluator (reference
src/evaluation/fact_verification.py:33-227): label normalization via
FactVerificationGoldLabel.LABEL_MAP, overall accuracy, per-class
precision/recall/F1 with macro-F1, and document-level evidence
precision/recall/F1.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from qpp_fusion_rag_tpu_torch.evaluation.base import (
    FactVerificationGoldLabel,
    FactVerificationPrediction,
)

LABELS = ("SUPPORT", "CONTRADICT", "NOT_ENOUGH_INFO")


class FactVerificationEvaluator:
    def evaluate(
        self,
        predictions: Sequence[FactVerificationPrediction],
        golds: Dict[str, FactVerificationGoldLabel],
    ) -> Dict:
        """-> {accuracy, macro_f1, per_class: {label: {p, r, f1, support}},
        evidence: {precision, recall, f1}, n_evaluated}."""
        tp = {l: 0 for l in LABELS}
        fp = {l: 0 for l in LABELS}
        fn = {l: 0 for l in LABELS}
        support = {l: 0 for l in LABELS}
        correct = 0
        n = 0
        ev_p, ev_r, ev_f1 = [], [], []

        for pred in predictions:
            gold = golds.get(pred.query_id)
            if gold is None:
                continue
            n += 1
            g = FactVerificationGoldLabel.normalize_label(gold.label) or gold.label
            p = FactVerificationGoldLabel.normalize_label(pred.label) or "NOT_ENOUGH_INFO"
            support[g] = support.get(g, 0) + 1
            if p == g:
                correct += 1
                tp[g] += 1
            else:
                fp[p] = fp.get(p, 0) + 1
                fn[g] = fn.get(g, 0) + 1

            if gold.evidence_doc_ids:
                gset = set(gold.evidence_doc_ids)
                pset = set(pred.evidence_doc_ids)
                inter = len(gset & pset)
                prec = inter / len(pset) if pset else 0.0
                rec = inter / len(gset)
                ev_p.append(prec)
                ev_r.append(rec)
                ev_f1.append(2 * prec * rec / (prec + rec) if prec + rec > 0 else 0.0)

        per_class = {}
        f1s = []
        for l in LABELS:
            prec = tp[l] / (tp[l] + fp[l]) if tp[l] + fp[l] > 0 else 0.0
            rec = tp[l] / (tp[l] + fn[l]) if tp[l] + fn[l] > 0 else 0.0
            f1 = 2 * prec * rec / (prec + rec) if prec + rec > 0 else 0.0
            per_class[l] = {"precision": prec, "recall": rec, "f1": f1,
                            "support": support[l]}
            f1s.append(f1)

        def mean(xs):
            return sum(xs) / len(xs) if xs else 0.0

        return {
            "accuracy": correct / n if n else 0.0,
            "macro_f1": mean(f1s),
            "per_class": per_class,
            "evidence": {
                "precision": mean(ev_p),
                "recall": mean(ev_r),
                "f1": mean(ev_f1),
            },
            "n_evaluated": n,
        }


def parse_verdict(text: str) -> Optional[str]:
    """Extract a normalized FV label from free-form model output
    (reference src/generation.py FV verdict parsing: look for a
    'Verdict:' line first, then any known label token)."""
    for line in text.splitlines():
        if line.strip().lower().startswith("verdict"):
            tail = line.split(":", 1)[-1]
            lab = FactVerificationGoldLabel.normalize_label(tail)
            if lab:
                return lab
    up = text.upper()
    if "NOT_ENOUGH_INFO" in up or "NOT ENOUGH INFO" in up:
        return "NOT_ENOUGH_INFO"
    # Negated support must not match the bare SUPPORT token below.
    for neg in ("NOT SUPPORTED", "NOT SUPPORT", "DOES NOT SUPPORT",
                "DOESN'T SUPPORT", "UNSUPPORTED", "CANNOT BE SUPPORTED"):
        if neg in up:
            return "CONTRADICT"
    if "CONTRADICT" in up or "REFUTE" in up:
        return "CONTRADICT"
    if "SUPPORT" in up:
        return "SUPPORT"
    return None
