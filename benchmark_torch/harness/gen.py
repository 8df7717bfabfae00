"""The benchmark's data, made from --seed: Zipfian BM25-style impact
postings built on the device, query terms drawn on the host, and dense
rows and query embeddings drawn on the device.

The posting generator is a torch copy of the port's host generator
(``data/synthetic.py:zipf_bm25_csr``), run on the card: lognormal doc
lengths, Zipf term draws by inverse CDF, duplicate draws folded into term
frequencies by one sort-and-unique over (doc, term) keys, BM25 doc-side
impacts, each term's list ordered by impact (ties by doc id). Its random
streams are torch's, so a seed gives other postings than the numpy
generator, with the same shape (tests/test_gen.py).
"""

from __future__ import annotations

import math

import numpy as np
import torch

CORPUS_CHUNK = 262_144        # rows drawn per call


def sub_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for one named random stream of a run's --seed."""
    tag = [ord(c) for c in stream]
    return int(np.random.SeedSequence([int(seed) % (1 << 64), *tag]).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def generator(device, seed: int, stream: str) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, stream))


def zipf_csr(n_docs: int, vocab: int, avg_doc_len: float, zipf_a: float,
             lognormal_sigma: float, k1: float, b: float, gen: torch.Generator,
             device) -> dict:
    """Impact-ordered BM25 postings on `device`.
    -> {"offsets": int64 [V+1], "docs": int32 [P], "weights": f32 [P],
        "df": int64 [V]}; each term's postings descend by impact, ties by
        ascending doc id."""
    lens = torch.exp(torch.randn(n_docs, generator=gen, device=device, dtype=torch.float64)
                     * lognormal_sigma + math.log(avg_doc_len))
    doc_lens = torch.clamp(lens, min=4.0).to(torch.int32)
    del lens
    total = int(doc_lens.sum())

    ranks = torch.arange(1, vocab + 1, dtype=torch.float64, device=device)
    pmf = ranks ** (-zipf_a)
    cdf = torch.cumsum(pmf / pmf.sum(), 0)
    draws = torch.rand(total, generator=gen, device=device, dtype=torch.float64)
    terms = torch.clamp(torch.searchsorted(cdf, draws), max=vocab - 1)
    del draws
    doc_of = torch.repeat_interleave(torch.arange(n_docs, device=device),
                                     doc_lens.long(), output_size=total)
    key = doc_of * vocab + terms
    del doc_of, terms
    uniq, tf = torch.unique(key, sorted=True, return_counts=True)
    del key
    docs = (uniq // vocab).to(torch.int32)
    terms = uniq % vocab
    del uniq
    tf = tf.to(torch.float32)

    df = torch.bincount(terms, minlength=vocab)
    avglen = float(doc_lens.double().mean())
    idf = torch.log(1.0 + (n_docs - df.double() + 0.5) / (df.double() + 0.5)).to(torch.float32)
    norm = k1 * (1.0 - b + b * doc_lens[docs.long()].to(torch.float32) / avglen)
    w = idf[terms] * tf * (k1 + 1.0) / (tf + norm)
    del tf, norm

    # per term, impact descending, ties in doc order: one stable sort of
    # (term << 32 | ~bits(w)); w >= 0, so its bits order like its value
    wbits = w.view(torch.int32).to(torch.int64)
    order = torch.sort((terms << 32) | (0xFFFFFFFF - wbits), stable=True).indices
    del wbits, terms
    offsets = torch.zeros(vocab + 1, dtype=torch.int64, device=device)
    offsets[1:] = torch.cumsum(df, 0)
    return {"offsets": offsets, "docs": docs[order], "weights": w[order], "df": df}


def truncate_csr(csr: dict, cap: int) -> dict:
    """Keep each term's first min(df, cap) postings: the impact top that a
    window of p_cap = cap reads. The largest impact of a term is its first
    posting, so the per-term quantization grid is unchanged.
    -> {"offsets", "docs", "weights", "df"} (df stays the full one)."""
    off, df = csr["offsets"], csr["df"]
    eff = torch.clamp(df, max=cap)
    term = torch.repeat_interleave(torch.arange(df.numel(), device=df.device), df,
                                   output_size=csr["docs"].numel())
    keep = (torch.arange(csr["docs"].numel(), device=df.device) - off[term]) < cap
    offsets = torch.zeros_like(off)
    offsets[1:] = torch.cumsum(eff, 0)
    return {"offsets": offsets, "docs": csr["docs"][keep], "weights": csr["weights"][keep],
            "df": df}


def zipf_queries(df: np.ndarray, n_queries: int, n_terms: int, rng: np.random.Generator,
                 skip_top: int = 30, min_df: int = 5) -> np.ndarray:
    """Query term ids biased to mid-frequency terms (df >= min_df, not among
    the skip_top most frequent), drawn with probability ~ log(1 + df), as
    the port's ``data/synthetic.py:zipf_queries``. -> int32 [n, n_terms]."""
    candidates = np.flatnonzero(df >= min_df)
    candidates = candidates[candidates >= skip_top]
    p = np.log1p(df[candidates].astype(np.float64))
    p /= p.sum()
    return rng.choice(candidates, size=(n_queries, n_terms), p=p).astype(np.int32)


def int8_rows(n: int, dim: int, gen: torch.Generator, device):
    """Normal rows quantized per row to int8 (scale = max|x| / 127).
    -> (rows int8 [n, dim], scales f32 [n])."""
    rows = torch.empty((n, dim), dtype=torch.int8, device=device)
    scale = torch.empty(n, dtype=torch.float32, device=device)
    for n0 in range(0, n, CORPUS_CHUNK):
        n1 = min(n, n0 + CORPUS_CHUNK)
        x = torch.randn((n1 - n0, dim), generator=gen, device=device)
        amax = x.abs().amax(dim=1, keepdim=True)
        s = torch.where(amax > 0, amax * (1.0 / 127.0), 1.0)
        rows[n0:n1] = torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)
        scale[n0:n1] = s[:, 0]
    return rows, scale


def bf16_rows(n: int, dim: int, gen: torch.Generator, device) -> torch.Tensor:
    """Normal rows in bf16 [n, dim]."""
    rows = torch.empty((n, dim), dtype=torch.bfloat16, device=device)
    for n0 in range(0, n, CORPUS_CHUNK):
        n1 = min(n, n0 + CORPUS_CHUNK)
        rows[n0:n1] = torch.randn((n1 - n0, dim), generator=gen, device=device)
    return rows


def grid_queries(shape, gen: torch.Generator, device) -> torch.Tensor:
    """Normal query embeddings on the grid of 1/64 within +-4."""
    x = torch.randn(shape, generator=gen, device=device)
    return torch.round(x * 64).clamp(-256, 256) / 64


def grid_projections(shape, scale: float, gen: torch.Generator, device) -> torch.Tensor:
    """Normal projections times `scale`, on the grid of 1/256 within +-1/8.
    With queries on grid_queries' grid every product is a multiple of 2^-14
    and a sum of up to 2^10 such products stays below 2^24 steps, so an f32
    projection is exact in any summation order: the program and the
    reference project alike, and the check compares what follows."""
    x = torch.randn(shape, generator=gen, device=device) * scale
    return torch.round(x * 256).clamp(-32, 32) / 256
