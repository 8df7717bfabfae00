"""QA answer metrics: EM / F1 / ROUGE-L / containment (host-side).

Counterpart of qpp_fusion_rag_tpu/evaluation/qa_evaluator.py, copied (host
Python).

Replaces the reference's HF-evaluate squad wrapper (reference
src/evaluation/qa_evaluator.py:23-191) with a native implementation of the
same formulas — SQuAD answer normalization (lowercase, strip punctuation
and articles, whitespace fold), exact match and token-F1 best-over-
references, ROUGE-L via LCS, and substring containment. Scores are in
[0, 1] (the reference scales squad's /100, qa_evaluator.py:85-90).
"""

from __future__ import annotations

import re
import string
from collections import Counter
from typing import Dict, List, Optional, Sequence

_ARTICLES = re.compile(r"\b(a|an|the)\b")
_PUNCT = str.maketrans("", "", string.punctuation)


def normalize_answer(s: str) -> str:
    """SQuAD normalization: lower, remove punctuation/articles, fold spaces."""
    s = s.lower()
    s = s.translate(_PUNCT)
    s = _ARTICLES.sub(" ", s)
    return " ".join(s.split())


def exact_match(prediction: str, references: Sequence[str]) -> float:
    p = normalize_answer(prediction)
    return float(any(p == normalize_answer(r) for r in references))


def token_f1(prediction: str, references: Sequence[str]) -> float:
    """Best token-overlap F1 over references (SQuAD metric)."""
    p_tokens = normalize_answer(prediction).split()
    best = 0.0
    for ref in references:
        r_tokens = normalize_answer(ref).split()
        if not p_tokens or not r_tokens:
            best = max(best, float(p_tokens == r_tokens))
            continue
        common = Counter(p_tokens) & Counter(r_tokens)
        overlap = sum(common.values())
        if overlap == 0:
            continue
        precision = overlap / len(p_tokens)
        recall = overlap / len(r_tokens)
        best = max(best, 2 * precision * recall / (precision + recall))
    return best


def _lcs_len(a: List[str], b: List[str]) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for i in range(1, len(a) + 1):
        cur = [0] * (len(b) + 1)
        ai = a[i - 1]
        for j in range(1, len(b) + 1):
            cur[j] = prev[j - 1] + 1 if ai == b[j - 1] else max(prev[j], cur[j - 1])
        prev = cur
    return prev[-1]


def rouge_l(prediction: str, references: Sequence[str]) -> float:
    """Best ROUGE-L F-measure over references (reference qa_evaluator
    best-over-refs semantics)."""
    p = normalize_answer(prediction).split()
    best = 0.0
    for ref in references:
        r = normalize_answer(ref).split()
        lcs = _lcs_len(p, r)
        if lcs == 0:
            continue
        prec = lcs / len(p)
        rec = lcs / len(r)
        best = max(best, 2 * prec * rec / (prec + rec))
    return best


def containment(prediction: str, references: Sequence[str]) -> float:
    """1.0 if any normalized reference appears inside the prediction.
    References that normalize to the empty string (articles/punctuation
    only) are skipped — '' is a substring of everything."""
    p = normalize_answer(prediction)
    refs = [normalize_answer(r) for r in references]
    return float(any(rn and rn in p for rn in refs))


class QAEvaluator:
    """Batch QA metric computation + aggregation
    (reference src/evaluation/qa_evaluator.py surface)."""

    METRICS = ("em", "f1", "rouge_l", "containment")

    def evaluate_single(self, prediction: str, references: Sequence[str]) -> Dict[str, float]:
        refs = [r for r in references if isinstance(r, str)] or [""]
        return {
            "em": exact_match(prediction, refs),
            "f1": token_f1(prediction, refs),
            "rouge_l": rouge_l(prediction, refs),
            "containment": containment(prediction, refs),
        }

    def evaluate_batch(
        self,
        predictions: Sequence[str],
        references: Sequence[Sequence[str]],
    ) -> List[Dict[str, float]]:
        return [self.evaluate_single(p, r) for p, r in zip(predictions, references)]

    def aggregate(self, per_item: Sequence[Dict[str, float]]) -> Dict[str, float]:
        if not per_item:
            return {m: 0.0 for m in self.METRICS}
        return {
            m: sum(d.get(m, 0.0) for d in per_item) / len(per_item)
            for m in self.METRICS
        }


def compute_qa_metrics_batch(
    predictions: Sequence[str],
    references: Sequence[Sequence[str]],
) -> Dict[str, float]:
    """One-call batch + aggregate (reference qa_evaluator.py:152-191)."""
    ev = QAEvaluator()
    return ev.aggregate(ev.evaluate_batch(predictions, references))
