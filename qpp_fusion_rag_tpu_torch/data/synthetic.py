"""Synthetic Zipfian impact indexes and queries (numpy, host side).

Counterpart of qpp_fusion_rag_tpu/data/synthetic.py (zipf_bm25_csr,
zipf_queries and the calibrated shape constants), with the same RNG calls
in the same order, so a seed gives array-equal output in both packages.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

# Shape parameters fitted to real index statistics: the SciFact Terrier
# index's df curve fits Zipf(a=0.9874) with lognormal(sigma=0.3957) doc
# lengths; its SPLADE impact index has a flatter df curve, Zipf(a=0.675).
CALIBRATED_ZIPF_A_BM25 = 0.9874
CALIBRATED_ZIPF_A_SPLADE = 0.675
CALIBRATED_LOGNORMAL_SIGMA = 0.3957


def zipf_bm25_csr(
    n_docs: int,
    vocab_size: int = 100_000,
    avg_doc_len: float = 60.0,
    zipf_a: float = 1.07,
    k1: float = 0.9,
    b: float = 0.4,
    seed: int = 0,
    max_postings: Optional[int] = None,
    lognormal_sigma: float = 0.4,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Zipfian BM25 impact-ordered CSR lists.

    -> (offsets int64 [T+1], docs int32 [P], weights f32 [P] BM25 impacts
        impact-ordered desc per term, doc_lens int32 [N]).

    Term draws follow Zipf(a) over the vocabulary (term 0 most common), doc
    lengths are lognormal around avg_doc_len, weights are the BM25 doc-side
    impact idf * tf*(k1+1) / (tf + k1*(1-b+b*len/avglen))."""
    rng = np.random.default_rng(seed)
    doc_lens = np.maximum(
        rng.lognormal(np.log(avg_doc_len), lognormal_sigma, size=n_docs), 4.0
    ).astype(np.int32)
    total = int(doc_lens.sum())
    if max_postings and total > max_postings:
        scale = max_postings / total
        doc_lens = np.maximum((doc_lens * scale).astype(np.int32), 2)
        total = int(doc_lens.sum())

    # Zipf over a finite vocab by inverse CDF on uniform draws
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    pmf = ranks ** (-zipf_a)
    cdf = np.cumsum(pmf / pmf.sum())
    draws = rng.random(total)
    # cdf[-1] may round below 1.0; clamp so a draw never indexes vocab_size
    terms = np.minimum(np.searchsorted(cdf, draws),
                       vocab_size - 1).astype(np.int64)

    doc_of = np.repeat(np.arange(n_docs, dtype=np.int64), doc_lens)
    key = doc_of * vocab_size + terms          # duplicate draws -> tf counts
    uniq, tf = np.unique(key, return_counts=True)
    docs = (uniq // vocab_size).astype(np.int32)
    terms = (uniq % vocab_size).astype(np.int64)
    tf = tf.astype(np.float32)

    df = np.bincount(terms, minlength=vocab_size).astype(np.float64)
    avglen = float(doc_lens.mean())
    idf = np.log(1.0 + (n_docs - df + 0.5) / (df + 0.5)).astype(np.float32)
    norm = k1 * (1.0 - b + b * doc_lens[docs].astype(np.float32) / avglen)
    w = idf[terms] * tf * (k1 + 1.0) / (tf + norm)

    order = np.lexsort((-w, terms))
    docs, terms, w = docs[order], terms[order], w[order]
    offsets = np.zeros(vocab_size + 1, dtype=np.int64)
    np.cumsum(df.astype(np.int64), out=offsets[1:])
    return offsets, docs, w.astype(np.float32), doc_lens


def zipf_queries(
    offsets: np.ndarray,
    n_queries: int,
    n_terms: int = 8,
    skip_top: int = 30,
    seed: int = 1,
) -> Tuple[np.ndarray, np.ndarray]:
    """Query term ids biased to mid-frequency terms (df >= 5, not among the
    `skip_top` most frequent), chosen with probability ~ log(1 + df).

    -> (q_terms int32 [B, n_terms], q_weights f32 [B, n_terms] all ones)."""
    rng = np.random.default_rng(seed)
    df = np.diff(offsets)
    candidates = np.flatnonzero(df >= 5)
    candidates = candidates[candidates >= skip_top]
    p = np.log1p(df[candidates].astype(np.float64))
    p /= p.sum()
    q_terms = rng.choice(candidates, size=(n_queries, n_terms), p=p).astype(np.int32)
    return q_terms, np.ones((n_queries, n_terms), dtype=np.float32)
