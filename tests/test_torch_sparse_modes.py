"""Port parity, the ensemble's remaining sparse modes: the pair-sort engines
("sort": sparse_score_topk, sparse_score_topk_packed), the sort-free window
rescore (sparse_rescore_topk and its packed form, the step's
sparse_candidates > 0) and the certified step (q8c), each against the JAX
package on the same numpy inputs.

The pair-sort engines reproduce JAX's run sums bit for bit: both sort the
pairs by id and take the differences of one f32 cumsum in XLA's CPU order
(segment.cumsum_blocked). The window rescore sums each pooled doc from the
same id-sorted row, where JAX forms a [B, pool, M] match and reduces it, so
its sums carry the cumsum-difference error of the pinned hazard "Float run
sums" (ROADMAP Queue 3: about 3e-4 relative at M = 32k): scores are held
to RUN_RTOL, and ids may differ only between docs whose scores lie within
it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qpp_fusion_rag_tpu.ops import sparse as JSP
from qpp_fusion_rag_tpu.ops.pallas.dense_topk import quantize_rows as j_quantize_rows
from qpp_fusion_rag_tpu.pipeline import ensemble as JE
from qpp_fusion_rag_tpu_torch.data.synthetic import zipf_bm25_csr, zipf_queries
from qpp_fusion_rag_tpu_torch.ops import sparse as TSP
from qpp_fusion_rag_tpu_torch.pipeline import ensemble as TE
from qpp_fusion_rag_tpu_torch.pipeline.interop import indexes_from_numpy

N, D, B, K, CAP, IMP_BITS = 8192, 32, 16, 32, 64, 14
CAP_C = 512                 # q8c: windows long enough to certify
RUN_RTOL = 3e-4             # the pinned hazard "Float run sums"


@pytest.fixture(scope="module")
def views():
    """BM25 and SPLADE CSRs, both posting layouts (the dual one at CAP_C),
    doc vectors cut at doc_cap 128 with tails, and queries (8 and 16 terms,
    one with pads)."""
    out = {}
    for name, vocab, avg, seed, tq in (("bm25", 1500, 30.0, 0, 8),
                                       ("splade", 1000, 40.0, 7, 16)):
        off, docs, w, _ = zipf_bm25_csr(N, vocab_size=vocab, avg_doc_len=avg, seed=seed)
        packed, scales = TSP.pack_postings(docs, w, off)
        pre, off2, _ = TSP.pack_postings_presorted(docs, w, off, cap=CAP_C, scales=scales)
        dp, dsc, _, tail = TSP.pack_doc_vectors(off, docs, w, N, doc_cap=128,
                                                imp_bits=IMP_BITS, return_tail=True)
        qt, qw = zipf_queries(off, B, n_terms=tq, seed=seed + 1)
        qt[1, -2:] = -1
        out[name] = dict(csr=(docs.astype(np.int32), w, off.astype(np.int32)),
                         packed=packed, scales=scales, presorted=(pre, off2.astype(np.int32)),
                         doc=(dp, dsc), tail=tail, q=(qt, qw))
    return out


def _assert_ranked_within(ts, ti, js, ji, rtol):
    """Row-sorted scores within rtol (-inf pads equal); an id in both rows
    carries the same score within rtol, and an id in one row only scores
    within rtol of the other row's last finite score (a near-tie at the
    cut)."""
    assert ts.shape == js.shape and ti.dtype == ji.dtype == np.int32
    np.testing.assert_allclose(ts, js, rtol=rtol, atol=0)
    np.testing.assert_array_equal(ti < 0, ji < 0)
    for b in range(ts.shape[0]):
        j_of = dict(zip(ji[b].tolist(), js[b].tolist()))
        j_last = js[b][ji[b] >= 0].min() if (ji[b] >= 0).any() else None
        for i, s in zip(ti[b].tolist(), ts[b].tolist()):
            if i < 0:
                continue
            ref = j_of.get(i, j_last)
            assert abs(s - ref) <= rtol * abs(ref), (b, i, s, ref)


# ----------------------------------------------------- the engines --------

@pytest.mark.parametrize("p_cap", [CAP, 512])
@pytest.mark.parametrize("view", ["bm25", "splade"])
def test_pair_sort_engines_match_jax_bit_for_bit(views, view, p_cap):
    """sparse_score_topk on f32 and on uint8 weights (with term_scales),
    and sparse_score_topk_packed: the same ids and scores as JAX's."""
    v = views[view]
    docs, w, off = v["csr"]
    qt, qw = v["q"]
    w8 = np.clip(np.round(w / np.repeat(v["scales"], np.diff(off))), 0, 255).astype(np.uint8)
    for args, kw, jfn, tfn in (
            ((docs, w, off, qt, qw), {}, JSP.sparse_score_topk, TSP.sparse_score_topk),
            ((docs, w8, off, qt, qw), {"term_scales": v["scales"]}, JSP.sparse_score_topk,
             TSP.sparse_score_topk),
            ((v["packed"], off, v["scales"], qt, qw), {}, JSP.sparse_score_topk_packed,
             TSP.sparse_score_topk_packed)):
        js, ji = map(np.asarray, jfn(*map(jnp.asarray, args), k=K, p_cap=p_cap,
                                     **{n: jnp.asarray(x) for n, x in kw.items()}))
        ts, ti = tfn(*map(torch.as_tensor, args), k=K, p_cap=p_cap,
                     **{n: torch.as_tensor(x) for n, x in kw.items()})
        np.testing.assert_array_equal(ti.numpy(), ji)
        np.testing.assert_array_equal(ts.numpy(), js)
        assert (ti.numpy()[:, 0] >= 0).all()


@pytest.mark.parametrize("p_cap,candidates", [(CAP, 4), (512, 2), (512, 64)])
@pytest.mark.parametrize("view", ["bm25", "splade"])
def test_window_rescore_matches_jax(views, view, p_cap, candidates):
    """sparse_rescore_topk (f32 postings) and its packed form: pools of
    candidates·k raw contributions, from a strict part of the row to the
    whole row (64·32 >= M), rescored without the [B, pool, M] match."""
    v = views[view]
    docs, w, off = v["csr"]
    qt, qw = v["q"]
    for args, jfn, tfn in (((docs, w, off, qt, qw), JSP.sparse_rescore_topk,
                            TSP.sparse_rescore_topk),
                           ((v["packed"], off, v["scales"], qt, qw),
                            JSP.sparse_rescore_topk_packed, TSP.sparse_rescore_topk_packed)):
        js, ji = map(np.asarray, jfn(*map(jnp.asarray, args), k=K, p_cap=p_cap,
                                     candidates=candidates))
        ts, ti = tfn(*map(torch.as_tensor, args), k=K, p_cap=p_cap, candidates=candidates)
        _assert_ranked_within(ts.numpy(), ti.numpy(), js, ji, RUN_RTOL)


def test_rescore_pool_keeps_the_first_of_duplicate_candidates():
    """A doc whose contributions fill several pool slots is scored once,
    at its first slot, with the sum of all its contributions; SENTINEL
    slots never score."""
    S = TSP.SENTINEL
    docs = torch.tensor([[5, 9, 5, 3, S, 9, 5, 1]], dtype=torch.int32)
    vals = torch.tensor([[4.0, 3.5, 3.0, 2.0, 9.0, 1.0, 0.5, 0.25]])
    s, i = TSP._rescore_pool(docs, vals, k=2, candidates=3)    # pool of 6
    assert i.tolist() == [[5, 9]] and s.tolist() == [[7.5, 4.5]]
    s, i = TSP._rescore_pool(docs, vals, k=8, candidates=1)
    assert i.tolist() == [[5, 9, 3, 1, -1, -1, -1, -1]]
    assert s[0, :4].tolist() == [7.5, 4.5, 2.0, 0.25] and torch.isneginf(s[0, 4:]).all()


# --------------------------------------------------------- the step -------

@pytest.fixture(scope="module")
def step_index(views):
    """JAX and port indexes over the same arrays: the plain layout (for
    "sort" and the window rescore) and the presorted one with doc vectors
    and tails (q8c)."""
    rng = np.random.default_rng(0)
    corpus = rng.standard_normal((D, N)).astype(np.float32)
    c_int, d_scale = jax.jit(lambda c: j_quantize_rows(c, axis=0))(jnp.asarray(corpus))
    dense = dict(corpus_int=np.asarray(c_int), corpus_rows=np.asarray(c_int).T.copy(),
                 d_scale=np.asarray(d_scale).reshape(1, N))
    out = {}
    for layout in ("plain", "presorted"):
        arrays = dict(dense)
        for name, v in views.items():
            packed, off = ((v["packed"], v["csr"][2]) if layout == "plain"
                           else v["presorted"])
            arrays.update({f"{name}_packed": packed, f"{name}_offsets": off,
                           f"{name}_scales": v["scales"]})
            if layout == "presorted":
                arrays.update({f"{name}_doc_packed": v["doc"][0],
                               f"{name}_doc_scale": v["doc"][1], f"{name}_tail": v["tail"]})
        jidx = JE.EnsembleIndexes(**{f: jnp.asarray(x) for f, x in arrays.items()})
        out[layout] = (jidx, indexes_from_numpy(arrays, "cpu", doc_imp_bits=IMP_BITS))
    q = rng.standard_normal((B, D)).astype(np.float32)
    proj = (rng.standard_normal((2, D, D)) * 0.05).astype(np.float32)
    tf = np.tile(np.array([6.0, 6.0, 9.0, 5.0], np.float32), (B, 1))
    out["inputs"] = (*views["bm25"]["q"], *views["splade"]["q"], q, proj, tf)
    return out


def _steps(step_index, layout, **kw):
    jidx, tidx = step_index[layout]
    kw = dict(dict(k=K, k_out=K, p_cap=CAP, doc_imp_bits=IMP_BITS), **kw)
    jo = [np.asarray(x) for x in JE._ensemble_retrieval_step(jidx, *step_index["inputs"], **kw)]
    to = [x.numpy() for x in TE.ensemble_retrieval_step(tidx, *step_index["inputs"], **kw)]
    return to, jo


def test_step_sort_mode_matches_jax(step_index):
    """The default sparse_mode, "sort", end to end: the sparse views equal
    JAX's, so the fused outputs agree to the QPP and fusion arithmetic."""
    to, jo = _steps(step_index, "plain")
    assert [x.shape for x in to] == [x.shape for x in jo] == [(B, K), (B, K), (5, B, 13)]
    np.testing.assert_allclose(to[2], jo[2], rtol=1e-4, atol=1e-5)
    _assert_ranked_within(to[1], to[0], jo[1], jo[0], 1e-5)


def test_step_window_rescore_matches_jax(step_index):
    """sparse_candidates > 0 (mode "sort" or "q8"): the window rescore on
    both sparse views. The views' run sums carry RUN_RTOL, and so do the
    fused scores, which are weighted sums of min-max normalised views."""
    for mode in ("sort", "q8"):
        to, jo = _steps(step_index, "plain", sparse_mode=mode, sparse_candidates=4)
        assert [x.shape for x in to] == [(B, K), (B, K), (5, B, 13)]
        np.testing.assert_allclose(to[2], jo[2], rtol=RUN_RTOL, atol=RUN_RTOL)
        _assert_ranked_within(to[1], to[0], jo[1], jo[0], RUN_RTOL)


def test_step_q8c_returns_jax_five_tuple(step_index):
    """q8c on the presorted layout with tails, the pool the whole row on
    both views (8192 candidates >= M = 4096, 8192), where both packages
    take a plain top-k: fused outputs, the certificates' AND and the
    slacks' min as JAX's."""
    to, jo = _steps(step_index, "presorted", sparse_mode="q8c", sparse_candidates=8192,
                    sparse_presorted=True, p_cap=CAP_C)
    assert [x.shape for x in to] == [x.shape for x in jo] == [(B, K), (B, K), (5, B, 13),
                                                              (B,), (B,)]
    assert to[3].dtype == np.bool_ and to[4].dtype == np.float32
    np.testing.assert_allclose(to[2], jo[2], rtol=1e-4, atol=1e-5)
    _assert_ranked_within(to[1], to[0], jo[1], jo[0], 1e-5)
    np.testing.assert_allclose(to[4], jo[4], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(to[3], jo[3])
    assert to[3].any() and not to[3].all()


def test_mode_refusals_match_jax(step_index):
    """The layout and option refusals of JAX's make_sparse_scorer."""
    for kw, match in ((dict(sparse_mode="sort"), "presorted layout"),
                      (dict(sparse_mode="q8", sparse_candidates=4), "sparse_candidates > 0"),
                      (dict(sparse_mode="q8c", sparse_sort_ids=True), "sort_ids")):
        for pkg in (JE.make_sparse_scorer, TE.make_sparse_scorer):
            with pytest.raises(ValueError, match=match):
                pkg(kw["sparse_mode"], kw.get("sparse_candidates", 0), K, CAP,
                    presorted=True, sort_ids=kw.get("sparse_sort_ids", False))
    _, tidx = step_index["plain"]
    with pytest.raises(ValueError, match="doc-major vectors"):
        TE.ensemble_retrieval_step(tidx, *step_index["inputs"], k=K, k_out=K, p_cap=CAP,
                                   sparse_mode="q8c")
