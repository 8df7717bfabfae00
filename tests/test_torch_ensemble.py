"""Port parity, whole slice: qpp_fusion_rag_tpu_torch's q8 ensemble step
against the JAX package's ensemble_retrieval_step (sparse_mode="q8",
presorted postings) on one index built once and carried over through
pipeline.interop; plus the port's import isolation from jax and pyyaml."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qpp_fusion_rag_tpu.data import synthetic as JS
from qpp_fusion_rag_tpu.ops.pallas.dense_topk import quantize_rows as j_quantize_rows
from qpp_fusion_rag_tpu.ops.sparse import pack_postings_presorted
from qpp_fusion_rag_tpu.pipeline import ensemble as JE
from qpp_fusion_rag_tpu_torch.pipeline import ensemble as TE
from qpp_fusion_rag_tpu_torch.pipeline.interop import indexes_from_numpy

REPO = Path(__file__).resolve().parents[1]
N, D, B, CAP, K = 16_384, 64, 16, 64, 32


@pytest.fixture(scope="module")
def built():
    """One host build (JAX generators and packers), one JAX index, and the
    port's index made from the JAX index's arrays."""
    bo, bd, bw, _ = JS.zipf_bm25_csr(
        N, vocab_size=3000, avg_doc_len=30.0, seed=0,
        zipf_a=JS.CALIBRATED_ZIPF_A_BM25, lognormal_sigma=JS.CALIBRATED_LOGNORMAL_SIGMA)
    so, sd, sw, _ = JS.zipf_bm25_csr(
        N, vocab_size=2000, avg_doc_len=40.0, seed=7,
        zipf_a=JS.CALIBRATED_ZIPF_A_SPLADE, lognormal_sigma=JS.CALIBRATED_LOGNORMAL_SIGMA)
    bp, bo2, bs = pack_postings_presorted(bd, bw, bo, cap=CAP)
    sp, so2, ss = pack_postings_presorted(sd, sw, so, cap=CAP)
    rng = np.random.default_rng(0)
    corpus = rng.standard_normal((D, N)).astype(np.float32)
    c_int, d_scale = jax.jit(lambda c: j_quantize_rows(c, axis=0))(jnp.asarray(corpus))
    jidx = JE.EnsembleIndexes(
        bm25_packed=jnp.asarray(bp), bm25_scales=jnp.asarray(bs),
        bm25_offsets=jnp.asarray(bo2.astype(np.int32)),
        splade_packed=jnp.asarray(sp), splade_scales=jnp.asarray(ss),
        splade_offsets=jnp.asarray(so2.astype(np.int32)),
        corpus_int=c_int, corpus_rows=jnp.transpose(c_int),
        d_scale=d_scale.reshape(1, N))
    arrays = {f: np.asarray(getattr(jidx, f)) for f in jidx._fields
              if getattr(jidx, f) is not None and f != "doc_imp_bits"}
    tidx = indexes_from_numpy(arrays, "cpu")
    bt, bq = JS.zipf_queries(bo, B, n_terms=8, seed=1)
    st, sq = JS.zipf_queries(so, B, n_terms=16, seed=2)
    q = rng.standard_normal((B, D)).astype(np.float32)
    proj = (rng.standard_normal((2, D, D)) * 0.05).astype(np.float32)
    tf = np.tile(np.array([6.0, 6.0, 9.0, 5.0], np.float32), (B, 1))
    return dict(jidx=jidx, tidx=tidx, arrays=arrays,
                inputs=(bt, bq, st, sq, q, proj, tf))


STEP_KW = dict(k=K, k_out=K, p_cap=CAP, sparse_mode="q8", sparse_presorted=True)


def _assert_ids_equal_up_to_near_ties(ti, ts, ji, tol=1e-5):
    """Equal ids, except two adjacent positions may swap where their fused
    scores differ by < tol (the rerank's f32 sums run in another order)."""
    for b in range(ti.shape[0]):
        i = 0
        while i < ti.shape[1]:
            if ti[b, i] == ji[b, i]:
                i += 1
                continue
            assert i + 1 < ti.shape[1], (b, i)
            assert ti[b, i] == ji[b, i + 1] and ti[b, i + 1] == ji[b, i], (b, i)
            assert abs(ts[b, i] - ts[b, i + 1]) < tol, (b, i)
            i += 2


def test_ensemble_step_matches_jax(built):
    jo = [np.asarray(x) for x in JE.ensemble_retrieval_step(
        built["jidx"], *built["inputs"], **STEP_KW)]
    to = [x.numpy() for x in TE.ensemble_retrieval_step(
        built["tidx"], *built["inputs"], **STEP_KW)]
    assert [x.shape for x in to] == [x.shape for x in jo] == [(B, K), (B, K), (5, B, 13)]
    np.testing.assert_allclose(to[2], jo[2], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(to[1], jo[1], rtol=1e-5)
    _assert_ids_equal_up_to_near_ties(to[0], to[1], jo[0])


def test_kernel_views_match_jax_bit_for_bit(built):
    """The three kernel-bearing views of the step: BM25 and SPLADE q8 (K3 +
    K2) and the int8 dense view (K1)."""
    from qpp_fusion_rag_tpu.ops.sparse import sparse_score_topk_q8 as j_q8
    from qpp_fusion_rag_tpu_torch.ops.sparse import sparse_score_topk_q8 as t_q8

    jidx, tidx = built["jidx"], built["tidx"]
    bt, bq, st, sq, q, _, _ = built["inputs"]
    for view, terms, qw in (("bm25", bt, bq), ("splade", st, sq)):
        jargs = [getattr(jidx, f"{view}_{f}") for f in ("packed", "offsets", "scales")]
        targs = [getattr(tidx, f"{view}_{f}") for f in ("packed", "offsets", "scales")]
        js, ji = j_q8(*jargs, terms, qw, k=K, p_cap=CAP, presorted=True)
        ts, ti = t_q8(*targs, torch.as_tensor(terms), torch.as_tensor(qw),
                      k=K, p_cap=CAP, presorted=True)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji), err_msg=view)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js), err_msg=view)
    js, ji = JE.dense_view_topk(jnp.asarray(q), jidx.corpus_int, jidx.d_scale, K)
    ts, ti = TE.dense_view_topk(torch.as_tensor(q), tidx.corpus_rows, tidx.d_scale, K)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_rerank_candidates_matches_jax(built):
    jidx, tidx = built["jidx"], built["tidx"]
    _, _, _, _, q, proj, _ = built["inputs"]
    rng = np.random.default_rng(9)
    cand = rng.integers(0, N, (B, K)).astype(np.int32)
    cand[:, -3:] = -1
    qv = np.einsum("bd,vdw->vbw", q, proj).astype(np.float32)
    js, ji = map(np.asarray, JE.rerank_candidates(
        jnp.asarray(qv), jnp.asarray(cand), jidx.corpus_rows, jidx.d_scale))
    ts, ti = TE.rerank_candidates(torch.as_tensor(qv), torch.as_tensor(cand),
                                  tidx.corpus_rows, tidx.d_scale)
    np.testing.assert_allclose(ts.numpy(), js, rtol=1e-5, atol=1e-6)
    for v in range(2):
        _assert_ids_equal_up_to_near_ties(ti.numpy()[v], ts.numpy()[v], ji[v])
    assert (ti.numpy()[..., -3:] == -1).all()


def test_unported_modes_raise_not_implemented(built):
    tidx = built["tidx"]
    for kw in (dict(sparse_mode="q8r"), dict(sparse_mode="q8c"),
               dict(sparse_mode="sort"), dict(sparse_candidates=4),
               dict(dense_rescore_pool=8), dict(mlp_params={"w": 1})):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            TE.ensemble_retrieval_step(tidx, *built["inputs"], k=K, k_out=K, p_cap=CAP,
                                       sparse_presorted=True, **kw)
    with pytest.raises(ValueError, match="unknown sparse_mode"):
        TE.make_sparse_scorer("q9", 0, K, CAP)
    with pytest.raises(ValueError, match="build cap"):
        TE.ensemble_retrieval_step(tidx, *built["inputs"], k=K, k_out=K,
                                   p_cap=CAP // 2, sparse_presorted=True)


def test_resolve_doc_imp_bits():
    assert TE.resolve_doc_imp_bits(None, None) == 8
    assert TE.resolve_doc_imp_bits(None, 6) == 6
    assert TE.resolve_doc_imp_bits(7, None) == 7
    with pytest.raises(ValueError, match="conflicts"):
        TE.resolve_doc_imp_bits(7, 8)


def test_interop_layouts(built):
    arrays, tidx = built["arrays"], built["tidx"]
    assert tidx.bm25_offsets.dtype == torch.int32
    assert tuple(tidx.d_scale.shape) == (N,)
    assert tuple(tidx.corpus_rows.shape) == (N, D)
    assert not hasattr(tidx, "corpus_int")       # one dense layout only
    bad = dict(arrays, corpus_int=np.roll(arrays["corpus_int"], 1, axis=1))
    with pytest.raises(ValueError, match="corpus_rows.T"):
        indexes_from_numpy(bad, "cpu")


def test_port_imports_without_jax_yaml_or_reference(tmp_path):
    """A subprocess in which jax, yaml and the JAX package cannot be imported
    builds a tiny index with the port's own host code and runs the slice."""
    script = tmp_path / "isolated.py"
    script.write_text(f"""
import sys
for name in ("jax", "jaxlib", "yaml", "qpp_fusion_rag_tpu"):
    sys.modules[name] = None
sys.path.insert(0, {str(REPO)!r})
import numpy as np, torch
from qpp_fusion_rag_tpu_torch.data.synthetic import zipf_bm25_csr, zipf_queries
from qpp_fusion_rag_tpu_torch.ops.kernels.dense_topk import quantize_rows
from qpp_fusion_rag_tpu_torch.ops.sparse import pack_postings_presorted
from qpp_fusion_rag_tpu_torch.pipeline.ensemble import ensemble_retrieval_step
from qpp_fusion_rag_tpu_torch.pipeline.interop import indexes_from_numpy
n, d, b, cap = 2048, 32, 4, 16
bo, bd, bw, _ = zipf_bm25_csr(n, vocab_size=400, avg_doc_len=20.0, seed=0)
so, sd, sw, _ = zipf_bm25_csr(n, vocab_size=300, avg_doc_len=25.0, seed=7)
bp, bo2, bs = pack_postings_presorted(bd, bw, bo, cap=cap)
sp, so2, ss = pack_postings_presorted(sd, sw, so, cap=cap)
g = torch.Generator().manual_seed(0)
rows, scale = quantize_rows(torch.randn(n, d, generator=g))
idx = indexes_from_numpy(dict(bm25_packed=bp, bm25_scales=bs, bm25_offsets=bo2,
                              splade_packed=sp, splade_scales=ss, splade_offsets=so2,
                              corpus_rows=rows, d_scale=scale), "cpu")
bt, bq = zipf_queries(bo, b, n_terms=4, seed=1)
st, sq = zipf_queries(so, b, n_terms=8, seed=2)
q = torch.randn(b, d, generator=g)
proj = torch.randn(2, d, d, generator=g) * 0.05
tf = np.tile(np.array([6, 6, 9, 5], np.float32), (b, 1))
ids, scores, qpp = ensemble_retrieval_step(idx, bt, bq, st, sq, q, proj, tf, k=16,
                                           k_out=16, p_cap=cap, sparse_presorted=True)
assert ids.shape == (b, 16) and qpp.shape == (5, b, 13)
assert torch.isfinite(qpp).all()
assert not any(m == "jax" or m.startswith(("jax.", "yaml", "qpp_fusion_rag_tpu."))
               for m in sys.modules if sys.modules[m] is not None)
print("isolated ok")
""")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                       env=env, timeout=300, cwd=tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "isolated ok" in r.stdout
