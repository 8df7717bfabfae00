"""Sparse index: host build (native C++), device search (ops/sparse.py).

Counterpart of qpp_fusion_rag_tpu/index/sparse.py: one artifact format
serves BM25 (weights computed at finalize) and learned-impact retrieval.
The on-disk layout is the JAX package's, so one saved index serves both
packages:
    sparse.npz    offsets/docs/weights/doc_lens (+ term_scales when quantized)
    vocab.txt     terms, one per line, id order
    docnos.txt    external doc ids, one per line, row order
    params.json   build parameters

The settings the JAX package reads from its YAML config are defaults here:
max_query_terms 64, bm25_k1 0.9, bm25_b 0.4. `device` defaults to the
card ("cuda"); pass device="cpu" for the plain versions of the kernels.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from qpp_fusion_rag_tpu_torch.index.engines import PackedEngineMixin, to_numpy
from qpp_fusion_rag_tpu_torch.index.native import NativeIndexBuilder
from qpp_fusion_rag_tpu_torch.ops.sparse import (
    sparse_score_topk,
    sparse_score_topk_q8_certified,
    term_scales_from_csr,
)

MAX_QUERY_TERMS = 64
BM25_K1, BM25_B = 0.9, 0.4          # BEIR's parameters


class SparseIndex(PackedEngineMixin):
    """Immutable CSR impact-list index + query tokenization."""

    def __init__(
        self,
        offsets: np.ndarray,      # int32/int64 [T+1]
        docs: np.ndarray,         # int32 [P]
        weights: np.ndarray,      # f32 [P]
        doc_lens: np.ndarray,     # int32 [N]
        docnos: List[str],
        vocab_dump: str,
        params: Optional[Dict] = None,
        device=None,
    ):
        # host offsets stay int64 (no silent wrap while building); the
        # >= 2^31 guard runs at device transfer
        self.offsets = np.asarray(offsets).astype(np.int64)
        self.docs = np.asarray(docs, dtype=np.int32)
        weights = np.asarray(weights)
        self.weights = weights if weights.dtype == np.uint8 else weights.astype(np.float32)
        self.term_scales = None
        self.doc_lens = np.asarray(doc_lens, dtype=np.int32)
        self.docnos = list(docnos)
        self.vocab_dump = vocab_dump
        self.params = params or {}
        self.device = torch.device("cuda" if device is None else device)
        self._tok: Optional[NativeIndexBuilder] = None
        self._device = None
        # optional override: callable (texts, max_terms) -> (term_ids,
        # weights) padded arrays, in place of the native tokenizer in
        # encode_queries (a format importer whose query model differs)
        self.query_encoder = None

    # -- properties ----------------------------------------------------
    @property
    def num_docs(self) -> int:
        return len(self.docnos)

    @property
    def num_terms(self) -> int:
        return len(self.offsets) - 1

    @property
    def num_postings(self) -> int:
        return len(self.docs)

    @property
    def max_df(self) -> int:
        return int(np.max(np.diff(self.offsets))) if self.num_terms else 0

    # -- build ---------------------------------------------------------
    @classmethod
    def build_bm25(
        cls,
        corpus: Iterable[Tuple[str, str]],   # (docno, text)
        k1: Optional[float] = None,
        b: Optional[float] = None,
        batch_size: int = 4096,
        device=None,
    ) -> "SparseIndex":
        """Build a BM25 impact index (BEIR's k1 0.9, b 0.4 by default)."""
        k1 = k1 if k1 is not None else BM25_K1
        b = b if b is not None else BM25_B
        builder = NativeIndexBuilder(k1=k1, b=b)
        docnos: List[str] = []
        batch: List[str] = []
        for docno, text in corpus:
            docnos.append(docno)
            batch.append(text)
            if len(batch) >= batch_size:
                builder.add_docs(batch)
                batch = []
        if batch:
            builder.add_docs(batch)
        builder.finalize(bm25_weights=True)
        offsets, docs, weights, doc_lens = builder.export()
        idx = cls(offsets, docs, weights, doc_lens, docnos, builder.vocab_dump(),
                  params={"kind": "bm25", "k1": k1, "b": b}, device=device)
        # the builder's C++ postings rival the exported arrays in size:
        # _tokenizer() makes a vocab-only instance on the first query
        builder.close()
        return idx

    # -- quantization ----------------------------------------------------
    def quantize(self, bits: int = 8) -> "SparseIndex":
        """Quantize impacts to uint8 with a per-term scale (quantized impact
        lists): 4x smaller postings, at most 0.4 % relative weight error.
        Returns self (in place)."""
        if self.params.get("quantized"):
            return self
        assert bits == 8, "only 8-bit quantization is supported"
        counts = np.diff(self.offsets).astype(np.int64)
        scales = term_scales_from_csr(self.weights, self.offsets)
        per_posting_scale = np.repeat(scales, counts)
        q = np.clip(np.round(self.weights / np.maximum(per_posting_scale, 1e-12)), 0, 255
                    ).astype(np.uint8)
        self.weights = q
        self.term_scales = scales
        self.params["quantized"] = True
        self._device = None
        return self

    # -- persistence ---------------------------------------------------
    def save(self, path) -> None:
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        arrays = dict(offsets=self.offsets, docs=self.docs, weights=self.weights,
                      doc_lens=self.doc_lens)
        if self.params.get("quantized"):
            arrays["term_scales"] = self.term_scales
        np.savez_compressed(path / "sparse.npz", **arrays)
        (path / "vocab.txt").write_text(self.vocab_dump)
        (path / "docnos.txt").write_text("\n".join(self.docnos) + "\n")
        (path / "params.json").write_text(json.dumps(self.params))

    @classmethod
    def load(cls, path, device=None) -> "SparseIndex":
        path = Path(path)
        arrs = np.load(path / "sparse.npz")
        params = json.loads((path / "params.json").read_text())
        idx = cls(arrs["offsets"], arrs["docs"], arrs["weights"], arrs["doc_lens"],
                  (path / "docnos.txt").read_text().splitlines(),
                  (path / "vocab.txt").read_text(), params=params, device=device)
        if params.get("quantized"):
            idx.term_scales = np.asarray(arrs["term_scales"], dtype=np.float32)
        return idx

    # -- query path ----------------------------------------------------
    def _tokenizer(self) -> NativeIndexBuilder:
        if self._tok is None:
            tok = NativeIndexBuilder(k1=self.params.get("k1", BM25_K1),
                                     b=self.params.get("b", BM25_B))
            tok.vocab_load(self.vocab_dump)
            self._tok = tok
        return self._tok

    def encode_queries(self, texts: Sequence[str],
                       max_terms: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        """-> (term_ids [B, Tq] int32 -1-padded, weights [B, Tq] f32 qtf)."""
        max_terms = max_terms or MAX_QUERY_TERMS
        if self.query_encoder is not None:
            return self.query_encoder(texts, max_terms)
        tok = self._tokenizer()
        B = len(texts)
        ids = np.full((B, max_terms), -1, dtype=np.int32)
        wts = np.zeros((B, max_terms), dtype=np.float32)
        n_max = 1
        for i, text in enumerate(texts):
            tids, counts = self._query_terms(tok, text, max_terms)
            ids[i, :len(tids)] = tids
            wts[i, :len(tids)] = counts
            n_max = max(n_max, len(tids))
        # trim the trailing all-invalid term columns (the window area scales
        # with the column count), rounded up to a power of two >= 8 so the
        # scorers see few distinct shapes
        n_pad = 8
        while n_pad < n_max:
            n_pad *= 2
        n_pad = min(n_pad, max_terms)
        return ids[:, :n_pad], wts[:, :n_pad]

    def _query_terms(self, tok: NativeIndexBuilder, text: str, max_terms: int):
        """tok.query_terms(text, max_terms) with the native truncation rule
        applied here: keep the max_terms rarest terms (df ascending, then
        term id), in term-id order. The native rule reads the builder's
        postings, which a vocabulary-only handle does not have (it reads
        past an empty vector there), so the handle is asked for every term
        (at most one per two bytes of text) and the index's own df
        truncates."""
        n_all = max(max_terms, (len(text.encode("utf-8", "ignore")) + 1) // 2 + 1)
        tids, counts = tok.query_terms(text, n_all)
        if len(tids) > max_terms:
            df = np.diff(self.offsets)[tids]
            keep = np.sort(np.lexsort((tids, df))[:max_terms])   # tids ascend
            tids, counts = tids[keep], counts[keep]
        return tids, counts

    def _offsets_i32(self) -> np.ndarray:
        """int32 CSR offsets for the device, with the overflow guard (the
        device scorers index postings with int32)."""
        if len(self.offsets) and int(self.offsets[-1]) >= 2**31:
            raise OverflowError(
                f"{int(self.offsets[-1])} postings exceed the int32 device-index range; "
                "shard the corpus over multiple SparseIndex instances")
        return self.offsets.astype(np.int32)

    def _device_arrays(self):
        """(docs, weights, offsets_i32, term_scales | None) on the device for
        the "exact" engine (made once)."""
        if self._device is None:
            self._device = (
                self._to_device(self.docs), self._to_device(self.weights),
                self._to_device(self._offsets_i32()),
                self._to_device(self.term_scales) if self.term_scales is not None else None)
        return self._device

    def _packed_source(self):
        """PackedEngineMixin provider: dequantized CSR postings (uint8
        storage dequantizes through the per-term scales, and the same grid
        is passed back so the packed layout requantizes identically)."""
        w = self.weights
        scales = None
        if w.dtype == np.uint8:
            df = np.diff(self.offsets).astype(np.int64)
            w = w.astype(np.float32) * np.repeat(self.term_scales, df)
            scales = self.term_scales
        return self.docs, w, self.offsets, scales

    def _doc_vector_terms(self) -> int:
        return self.num_terms

    def _default_p_cap(self, p_cap: Optional[int]) -> int:
        if p_cap is None:
            p_cap = int(self.params.get("p_cap", 0)) or min(self.max_df, 4096)
        return max(min(p_cap, self.max_df), 1)

    def search(
        self,
        queries: Sequence[str],
        k: int = 100,
        p_cap: Optional[int] = None,
        exact_topk: bool = True,
        engine: str = "exact",
        candidates: int = 2048,
        presorted: bool = False,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Batch search -> (scores [B, k], doc row indices [B, k], -1 pad).

        p_cap defaults to min(max_df, 4096): posting windows materialize as
        [B, Tq, p_cap] device tensors, so scoring a big corpus's longest
        posting list whole (p_cap=max_df, possibly millions) must be asked
        for; terms with df <= p_cap are always scored exactly.

        engine: "exact" (the pair-sort engine: K3 windows of docs and f32
        weights, f32 run sums), "q8" (the throughput engine: K3, then the
        quantized single-key sort K2 and a top-k, by the bitonic pool K4 /
        K5 when exact_topk), "q8r" (rank-safe: the q8 run sums pool the top
        `candidates` (K4 / K5) and every pooled doc is rescored exactly
        against its doc-major term vector, K6), or "certified"
        (search_certified without its info). q8 / q8r need doc ids
        < 2^23 - 1.

        presorted=True (q8 / q8r only) scores over the dual doc-ordered
        layout (ops.sparse.pack_postings_presorted, built on first use at
        this p_cap): the same candidates and scores, and K2 skips its first
        log2(p_cap) rounds.
        """
        if engine == "certified":
            if presorted:
                raise ValueError(
                    "engine='certified' runs its own plain-layout escalation ladder (p_cap "
                    "grows per round, but the dual layout is built at ONE cap); drop presorted")
            s, i, _info = self.search_certified(queries, k=k, p_cap=p_cap,
                                                candidates=candidates)
            return s, i
        q_terms, q_weights = self.encode_queries(queries)
        p_cap = self._default_p_cap(p_cap)
        if presorted and engine not in ("q8", "q8r"):
            raise ValueError("presorted layout needs engine 'q8' or 'q8r'")
        if engine in ("q8", "q8r"):
            return self._engine_topk(q_terms, q_weights, k=k, p_cap=p_cap, engine=engine,
                                     candidates=candidates, presorted=presorted,
                                     exact_topk=exact_topk)
        if engine != "exact":
            raise ValueError(f"unknown engine {engine!r}")
        flat_docs, flat_weights, offsets, scales = self._device_arrays()
        return to_numpy(*sparse_score_topk(
            flat_docs, flat_weights, offsets, self._to_device(q_terms),
            self._to_device(q_weights), k=k, p_cap=p_cap, term_scales=scales,
            exact_topk=exact_topk))

    def search_certified(
        self,
        queries: Sequence[str],
        k: int = 100,
        p_cap: Optional[int] = None,
        candidates: int = 1024,
        max_rounds: int = 2,
        exact_rescore: bool = True,
    ) -> Tuple[np.ndarray, np.ndarray, Dict]:
        """Provably rank-exact batch search at adaptive cost.
        -> (scores [B, k], doc rows [B, k], info).

        Round 0 runs the certified scorer (ops.sparse.
        sparse_score_topk_q8_certified): q8 windows pool candidates, every
        pooled doc is rescored exactly, and an upper bound proves per query
        whether the result equals full exhaustive scoring. A query the
        certificate cannot prove escalates: p_cap x4 and candidates x2 per
        round, up to `max_rounds`, then one exhaustive "exact" pass at
        p_cap = max_df serves the queries still pending. Every returned
        ranking is therefore rank-exact for the stored weights.

        exact_rescore=True (the default) rescores the pools against the raw
        f32 doc vectors (pack_doc_vectors_exact: the per-candidate slack
        collapses to the f32 tie band); False keeps the imp_bits rows (K6).

        Each round scores only the pending queries (the scorer is row-wise,
        so no padding of the subset is needed).

        info: {"certified_round": [B] (the 0-based round that certified
        each query; -1 = the exhaustive pass), "rounds": per-round counts}.
        """
        q_terms, q_weights = self.encode_queries(queries)
        B = len(queries)
        p_cap = self._default_p_cap(p_cap)
        packed, offs, pscales = self._device_packed()
        dp, ds, bits = self._device_doc_vectors()
        dt = dw = None
        if exact_rescore:
            dt, dw = self._device_doc_vectors_exact()

        out_s = np.full((B, k), -np.inf, np.float32)
        out_i = np.full((B, k), -1, np.int32)
        cert_round = np.full(B, -1, np.int64)
        rounds = []
        pending = np.arange(B)
        cap, cand = p_cap, candidates
        for rnd in range(max_rounds):
            if not len(pending):
                break
            s, i, ok, _slack = sparse_score_topk_q8_certified(
                packed, offs, pscales, dp, ds, self._to_device(q_terms[pending]),
                self._to_device(q_weights[pending]), k=k, p_cap=cap,
                candidates=min(max(cand, k), max(self.num_docs, 1)), imp_bits=bits,
                doc_terms=dt, doc_w=dw)
            s, i, ok = to_numpy(s, i, ok)
            done = pending[ok]
            out_s[done], out_i[done] = s[ok], i[ok]
            cert_round[done] = rnd
            rounds.append({"p_cap": cap, "candidates": cand, "certified": int(ok.sum()),
                           "pending": int(len(pending))})
            pending = pending[~ok]
            if cap >= self.max_df:
                break
            cap = min(cap * 4, self.max_df)
            cand = min(cand * 2, max(self.num_docs, k))
        if len(pending):
            # full-depth exhaustive pass: exact by construction
            s, i = self.search([queries[j] for j in pending], k=k, p_cap=self.max_df,
                               exact_topk=True, engine="exact")
            out_s[pending], out_i[pending] = s, i
            rounds.append({"p_cap": int(self.max_df), "exhaustive": True,
                           "pending": int(len(pending))})
        return out_s, out_i, {"certified_round": cert_round, "rounds": rounds}

    def docno(self, row: int) -> str:
        return self.docnos[row]

    def export_doc_vectors(self, path, weighting: str = "bm25", top_terms: int = 0) -> int:
        """Write per-doc sparse term vectors as ``docno\\tterm:wt ...``.

        The CSR postings (term-major, impact- or BM25-weighted at build
        time) invert to doc-major on the host. weighting: "bm25" writes the
        stored weights, "tfidf" re-weights them by log(N/df), "tf" writes
        the stored weights (an alias of bm25 when the index stores raw tf).
        top_terms > 0 keeps only each doc's heaviest terms. Returns the
        number of docs written."""
        if weighting not in ("bm25", "tf", "tfidf"):
            raise ValueError(f"unknown weighting {weighting!r}")
        terms = self.vocab_dump.splitlines()
        df = np.diff(self.offsets).astype(np.int64)
        w = self.weights.astype(np.float32)
        if self.term_scales is not None:
            w = w * np.repeat(self.term_scales, df)
        if weighting == "tfidf":
            idf = np.log(max(self.num_docs, 1) / np.maximum(df, 1))
            w = w * np.repeat(idf.astype(np.float32), df)
        term_of_posting = np.repeat(np.arange(self.num_terms, dtype=np.int64), df)
        order = np.argsort(self.docs, kind="stable")
        sorted_docs = self.docs[order]
        bounds = np.searchsorted(sorted_docs, np.arange(self.num_docs + 1))
        n = 0
        with open(path, "w") as f:
            for d in range(self.num_docs):
                lo, hi = bounds[d], bounds[d + 1]
                idx = order[lo:hi]
                tw = sorted(((terms[int(term_of_posting[i])], float(w[i])) for i in idx),
                            key=lambda kv: -kv[1])
                if top_terms > 0:
                    tw = tw[:top_terms]
                f.write(self.docnos[d] + "\t" + " ".join(f"{t}:{x:.4f}" for t, x in tw) + "\n")
                n += 1
        return n
