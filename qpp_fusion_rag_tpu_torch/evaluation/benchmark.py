"""Published BEIR benchmark constants + retriever category mapping.

Counterpart of qpp_fusion_rag_tpu/evaluation/benchmark.py, copied (host
Python).

The hardcoded comparison table the reference ships for stage-09 reporting
(reference scripts/09_eval_rankers.py:47-83): published nDCG@10 per
(dataset, method) from the BEIR paper/leaderboard, plus the retriever ->
category mapping used in tables and plots.
"""

from __future__ import annotations

from typing import Dict, Optional

# Published nDCG@10 (BEIR paper / leaderboard), reference 09_eval_rankers.py:47-74.
BEIR_BENCHMARK: Dict[str, Dict[str, float]] = {
    "nq": {
        "BM25": 0.329,
        "docT5query": 0.399,
        "TAS-B": 0.463,
        "ColBERT": 0.524,
        "BM25+CE": 0.533,
    },
    "hotpotqa": {
        "BM25": 0.603,
        "docT5query": 0.580,
        "TAS-B": 0.584,
        "ColBERT": 0.593,
        "BM25+CE": 0.707,
    },
    "scifact": {
        "BM25": 0.665,
        "docT5query": 0.675,
        "TAS-B": 0.643,
        "ColBERT": 0.671,
        "BM25+CE": 0.688,
    },
}

# retriever name -> category (reference 09_eval_rankers.py:105-126)
RETRIEVER_CATEGORIES: Dict[str, str] = {
    "bm25": "lexical",
    "splade": "learned-sparse",
    "bge": "dense",
    "tct_colbert": "dense",
    "bm25_tct": "two-stage",
    "bm25_monot5": "two-stage",
}

# closest published comparator per retriever (for delta columns)
CLOSEST_PUBLISHED: Dict[str, str] = {
    "bm25": "BM25",
    "bge": "TAS-B",
    "tct_colbert": "ColBERT",
    "bm25_tct": "ColBERT",
    "bm25_monot5": "BM25+CE",
    "splade": "docT5query",
}


def published_for(dataset: str, retriever: Optional[str] = None):
    table = BEIR_BENCHMARK.get(dataset, {})
    if retriever is None:
        return table
    key = CLOSEST_PUBLISHED.get(retriever)
    return table.get(key) if key else None
