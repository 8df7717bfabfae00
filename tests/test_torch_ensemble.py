"""Port parity, whole slice: qpp_fusion_rag_tpu_torch's ensemble step in
q8 and rank-safe q8r mode against the JAX package (presorted postings) on
indexes built once and carried over through pipeline.interop; plus the
port's import isolation from jax and pyyaml.

q8r is compared two ways: (a) with JAX's own ensemble_retrieval_step where
the pool is the whole row (both sides then take a plain top-k), and (b)
where the pool is a strict part of the row, with a jitted composition of
JAX's public functions in the order of _ensemble_retrieval_step that calls
sparse_score_topk_q8_rescored(bitonic=True): the port's pool follows the
TPU's bitonic route and its tie order (tests/test_torch_sparse.py)."""

import os
import subprocess
import sys
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qpp_fusion_rag_tpu.data import synthetic as JS
from qpp_fusion_rag_tpu.ops import fusion as JF
from qpp_fusion_rag_tpu.ops.pallas.dense_topk import quantize_rows as j_quantize_rows
from qpp_fusion_rag_tpu.ops.sparse import (
    pack_doc_vectors,
    pack_postings_presorted,
    sparse_score_topk_q8_rescored,
)
from qpp_fusion_rag_tpu.pipeline import ensemble as JE
from qpp_fusion_rag_tpu.pipeline.engine import qpp_from_runs
from qpp_fusion_rag_tpu_torch.pipeline import ensemble as TE
from qpp_fusion_rag_tpu_torch.pipeline.interop import indexes_from_numpy, mlp_params_from_numpy

REPO = Path(__file__).resolve().parents[1]
N, D, B, CAP, K = 16_384, 64, 16, 64, 32


IMP_BITS, POOL, CAP_B = 14, 48, 128


def _arrays(jidx):
    return {f: np.asarray(getattr(jidx, f)) for f in jidx._fields
            if getattr(jidx, f) is not None and f != "doc_imp_bits"}


@pytest.fixture(scope="module")
def built():
    """One host build (JAX generators and packers), the JAX indexes and the
    port's indexes made from the JAX indexes' arrays: the q8 index (int8
    rows), its rank-safe twin (bf16 corpus_rows, doc vectors at imp_bits 14
    and doc_cap 128, tails), and a rank-safe index over postings packed at
    cap 128 (pools that are a strict part of the row)."""
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
    arrays = _arrays(jidx)
    tidx = indexes_from_numpy(arrays, "cpu")

    docvec = {}
    for view, (o, d_, w) in (("bm25", (bo, bd, bw)), ("splade", (so, sd, sw))):
        dp, dsc, _, tail = pack_doc_vectors(o, d_, w, N, doc_cap=128, imp_bits=IMP_BITS,
                                            return_tail=True)
        docvec.update({f"{view}_doc_packed": jnp.asarray(dp),
                       f"{view}_doc_scale": jnp.asarray(dsc), f"{view}_tail": jnp.asarray(tail)})
    rows_bf16 = jnp.transpose(jnp.asarray(corpus)).astype(jnp.bfloat16)
    jidx_rs = jidx._replace(corpus_rows=rows_bf16, **docvec)
    arrays_rs = _arrays(jidx_rs)
    tidx_rs = indexes_from_numpy(arrays_rs, "cpu", doc_imp_bits=IMP_BITS)

    bp, bo2, _ = pack_postings_presorted(bd, bw, bo, cap=CAP_B, scales=bs)
    sp, so2, _ = pack_postings_presorted(sd, sw, so, cap=CAP_B, scales=ss)
    jidx_b = jidx_rs._replace(bm25_packed=jnp.asarray(bp),
                              bm25_offsets=jnp.asarray(bo2.astype(np.int32)),
                              splade_packed=jnp.asarray(sp),
                              splade_offsets=jnp.asarray(so2.astype(np.int32)))
    tidx_b = indexes_from_numpy(_arrays(jidx_b), "cpu", doc_imp_bits=IMP_BITS)

    bt, bq = JS.zipf_queries(bo, B, n_terms=8, seed=1)
    st, sq = JS.zipf_queries(so, B, n_terms=16, seed=2)
    q = rng.standard_normal((B, D)).astype(np.float32)
    proj = (rng.standard_normal((2, D, D)) * 0.05).astype(np.float32)
    tf = np.tile(np.array([6.0, 6.0, 9.0, 5.0], np.float32), (B, 1))
    return dict(jidx=jidx, tidx=tidx, arrays=arrays, jidx_rs=jidx_rs, tidx_rs=tidx_rs,
                arrays_rs=arrays_rs, jidx_b=jidx_b, tidx_b=tidx_b,
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


def test_ensemble_step_with_mlp_weights_matches_jax(built):
    """Learned fusion weights: softmax(mlp_apply(params, [B, 5*13] QPP
    features)), the same numpy parameters carried over to both packages."""
    rng = np.random.default_rng(4)
    sizes = [5 * 13, 32, 16, 5]
    params = [{"w": (rng.standard_normal((a, b)) * 0.3).astype(np.float32),
               "b": (rng.standard_normal(b) * 0.1).astype(np.float32)}
              for a, b in zip(sizes[:-1], sizes[1:])]
    jparams = [{k: jnp.asarray(v) for k, v in layer.items()} for layer in params]
    jo = [np.asarray(x) for x in JE.ensemble_retrieval_step(
        built["jidx"], *built["inputs"], mlp_params=jparams, **STEP_KW)]
    to = [x.numpy() for x in TE.ensemble_retrieval_step(
        built["tidx"], *built["inputs"], mlp_params=mlp_params_from_numpy(params, "cpu"),
        **STEP_KW)]
    assert [x.shape for x in to] == [x.shape for x in jo] == [(B, K), (B, K), (5, B, 13)]
    np.testing.assert_allclose(to[2], jo[2], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(to[1], jo[1], rtol=1e-5)
    _assert_ids_equal_up_to_near_ties(to[0], to[1], jo[0])
    qpp_w = [x.numpy() for x in TE.ensemble_retrieval_step(built["tidx"], *built["inputs"],
                                                           **STEP_KW)]
    assert not np.allclose(qpp_w[1], to[1])      # the weights did change the fusion


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
    """The modes once unported are served now (tests/test_torch_sparse_modes.py):
    q8c runs on the rank-safe index and returns JAX's 5-tuple; "sort" and the
    window rescore refuse the presorted layout, as in JAX."""
    tidx = built["tidx"]
    out = TE.ensemble_retrieval_step(built["tidx_rs"], *built["inputs"], k=K, k_out=K,
                                     p_cap=CAP, sparse_presorted=True, sparse_mode="q8c",
                                     doc_imp_bits=IMP_BITS)
    assert [tuple(x.shape) for x in out] == [(B, K), (B, K), (5, B, 13), (B,), (B,)]
    assert out[3].dtype == torch.bool
    for kw, match in ((dict(sparse_mode="sort"), "presorted layout"),
                      (dict(sparse_candidates=4), "window rescore")):
        with pytest.raises(ValueError, match=match):
            TE.ensemble_retrieval_step(tidx, *built["inputs"], k=K, k_out=K, p_cap=CAP,
                                       sparse_presorted=True, **kw)
    with pytest.raises(ValueError, match="doc-major vectors"):   # q8 index: no doc vectors
        TE.ensemble_retrieval_step(tidx, *built["inputs"], k=K, k_out=K, p_cap=CAP,
                                   sparse_mode="q8c", sparse_presorted=True)
    with pytest.raises(ValueError, match="unknown sparse_mode"):
        TE.make_sparse_scorer("q9", 0, K, CAP)
    with pytest.raises(ValueError, match="build cap"):
        TE.ensemble_retrieval_step(tidx, *built["inputs"], k=K, k_out=K,
                                   p_cap=CAP // 2, sparse_mode="q8", sparse_presorted=True)
    with pytest.raises(ValueError, match="doc-major vectors"):   # q8 index: no doc vectors
        TE.ensemble_retrieval_step(tidx, *built["inputs"], k=K, k_out=K, p_cap=CAP,
                                   sparse_mode="q8r", sparse_presorted=True)


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
    builds a tiny index with the port's own host code (postings and doc
    vectors) and runs the slice in q8, in q8r with a dense pool and in q8c,
    then the dense flagship step on its three routes (learned weights on
    one), the kernel entry points of the dense family and DenseIndex's
    engines."""
    script = tmp_path / "isolated.py"
    script.write_text(f"""
import sys
for name in ("jax", "jaxlib", "yaml", "qpp_fusion_rag_tpu"):
    sys.modules[name] = None
sys.path.insert(0, {str(REPO)!r})
import numpy as np, torch
from qpp_fusion_rag_tpu_torch.data.synthetic import zipf_bm25_csr, zipf_queries
from qpp_fusion_rag_tpu_torch.ops.kernels.dense_topk import quantize_rows
from qpp_fusion_rag_tpu_torch.ops.sparse import (
    doc_vector_imp_bits, pack_doc_vectors, pack_postings_presorted)
from qpp_fusion_rag_tpu_torch.pipeline.ensemble import ensemble_retrieval_step
from qpp_fusion_rag_tpu_torch.pipeline.interop import indexes_from_numpy, mlp_params_from_numpy
n, d, b, cap = 2048, 32, 4, 16
bo, bd, bw, _ = zipf_bm25_csr(n, vocab_size=400, avg_doc_len=20.0, seed=0)
so, sd, sw, _ = zipf_bm25_csr(n, vocab_size=300, avg_doc_len=25.0, seed=7)
bp, bo2, bs = pack_postings_presorted(bd, bw, bo, cap=cap)
sp, so2, ss = pack_postings_presorted(sd, sw, so, cap=cap)
bits = doc_vector_imp_bits(400)
bdp, bds, _ = pack_doc_vectors(bo, bd, bw, n, doc_cap=128, imp_bits=bits)
sdp, sds, _ = pack_doc_vectors(so, sd, sw, n, doc_cap=128, imp_bits=bits)
g = torch.Generator().manual_seed(0)
x = torch.randn(n, d, generator=g)
rows, scale = quantize_rows(x)
arrays = dict(bm25_packed=bp, bm25_scales=bs, bm25_offsets=bo2,
              splade_packed=sp, splade_scales=ss, splade_offsets=so2,
              corpus_rows=rows, d_scale=scale)
idx = indexes_from_numpy(arrays, "cpu")
idx_rs = indexes_from_numpy(arrays | dict(
    corpus_rows=x.to(torch.bfloat16), corpus_int=rows.T, bm25_doc_packed=bdp,
    bm25_doc_scale=bds, splade_doc_packed=sdp, splade_doc_scale=sds), "cpu",
    doc_imp_bits=bits)
bt, bq = zipf_queries(bo, b, n_terms=4, seed=1)
st, sq = zipf_queries(so, b, n_terms=8, seed=2)
q = torch.randn(b, d, generator=g)
proj = torch.randn(2, d, d, generator=g) * 0.05
tf = np.tile(np.array([6, 6, 9, 5], np.float32), (b, 1))
for index, kw in ((idx, dict(sparse_mode="q8")),
                  (idx_rs, dict(sparse_mode="q8r", sparse_candidates=32,
                                dense_rescore_pool=24)),
                  (idx_rs, dict(sparse_mode="q8c", sparse_candidates=32))):
    ids, scores, qpp, *cert = ensemble_retrieval_step(
        index, bt, bq, st, sq, q, proj, tf, k=16, k_out=16, p_cap=cap,
        sparse_presorted=True, **kw)
    assert ids.shape == (b, 16) and qpp.shape == (5, b, 13)
    assert len(cert) == (2 if kw["sparse_mode"] == "q8c" else 0)
    assert torch.isfinite(qpp).all() and (ids[:, 0] >= 0).all()
from qpp_fusion_rag_tpu_torch.ops.kernels.dense_topk import (
    pallas_dense_topk, pallas_dense_topk_int8_global, quantize_global)
from qpp_fusion_rag_tpu_torch.ops.kernels.streaming_topk import streaming_dense_topk
from qpp_fusion_rag_tpu_torch.pipeline.engine import (
    fused_retrieval_step, learned_fused_retrieval_step)
from qpp_fusion_rag_tpu_torch.pipeline.interop import (
    flagship_corpus_from_numpy, mlp_params_from_numpy)
from qpp_fusion_rag_tpu_torch.retrievers.dense import DenseIndex, DenseRetriever
vp = torch.randn(5, d, d, generator=g) * 0.1
tf5 = tf
bf = x.to(torch.bfloat16)
rng = np.random.default_rng(0)
mlp = mlp_params_from_numpy([{{"w": rng.standard_normal((65, 5)).astype(np.float32),
                              "b": np.zeros(5, np.float32)}}], "cpu")
c8, s8 = flagship_corpus_from_numpy(rows.T.numpy(), "cpu", scale.reshape(1, -1).numpy())
for out in (fused_retrieval_step(q, vp, bf, tf5, k=16, k_out=16, chunk=512),
            fused_retrieval_step(q, vp, bf, tf5, k=16, k_out=16, use_pallas=True),
            fused_retrieval_step(q, vp, bf.T.contiguous(), tf5, k=16, k_out=16,
                                 use_pallas=True, corpus_transposed=True),
            fused_retrieval_step(q, vp, c8, tf5, k=16, k_out=16, corpus_scale=s8),
            learned_fused_retrieval_step(mlp, q, vp, bf, tf5, k=16, k_out=16,
                                         use_pallas=True)):
    assert out[0].shape == (b, 16) and out[2].shape == (5, b, 13)
    assert torch.isfinite(out[2]).all() and (out[0][:, 0] >= 0).all()
for packed in (True, False):
    assert pallas_dense_topk(q, bf, k=8, packed=packed)[1].shape == (b, 8)
gi, gs = quantize_global(x)
assert pallas_dense_topk_int8_global(q, gi, gs, k=8)[1].shape == (b, 8)
assert streaming_dense_topk(q, bf, k=8)[1].shape == (b, 8)
index = DenseIndex(x.numpy(), [f"d{{i}}" for i in range(n)], device="cpu")
for engine in ("stream", "int8", "int8r"):
    res = DenseRetriever(index, encoder=lambda t: q[:len(t)].numpy(), engine=engine,
                         rescore_pool=32).retrieve_batch({{"a": "x", "b": "y"}}, top_k=5)
    assert [len(r.results) for r in res.values()] == [5, 5]
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


def test_offline_path_runs_without_jax_yaml_pandas_or_reference(tmp_path):
    """A subprocess in which jax, yaml, pandas and the JAX package cannot be
    imported writes and reads run files, computes the QPP stage, fuses with
    run_fusion, evaluates with IREvaluator and trains the per-retriever GBDT
    with train_fusion_models, all on the CPU."""
    script = tmp_path / "isolated_offline.py"
    script.write_text(f"""
import sys
for name in ("jax", "jaxlib", "yaml", "pandas", "qpp_fusion_rag_tpu"):
    sys.modules[name] = None
sys.path.insert(0, {str(REPO)!r})
import numpy as np
from qpp_fusion_rag_tpu_torch.data import RunTensor, load_qrels
from qpp_fusion_rag_tpu_torch.evaluation import IREvaluator
from qpp_fusion_rag_tpu_torch.fusion import run_fusion
from qpp_fusion_rag_tpu_torch.qpp import compute_qpp_dir
from qpp_fusion_rag_tpu_torch.data.loaders import load_qpp_scores
from qpp_fusion_rag_tpu_torch.train import train_fusion_models
rng = np.random.default_rng(0)
R, Q, K = 3, 40, 20
runs = {{f"r{{r}}": {{f"test{{q}}": [(f"d{{d}}", float(s), i + 1) for i, (d, s) in enumerate(
    zip(rng.choice(300, K, replace=False), np.sort(rng.uniform(0, 9, K))[::-1]))]
    for q in range(Q)}} for r in range(R)}}
rt = RunTensor.from_run_dicts(runs)
for r, name in enumerate(rt.retrievers):
    rt.write_trec(r, "runs/" + name + ".res")
    rt.minmax_normalized().write_trec(r, "runs/" + name + ".norm.res")
with open("qrels.tsv", "w") as f:
    for q in range(Q):
        for d in rng.choice(300, 3, replace=False):
            f.write(f"test{{q}}\\td{{d}}\\t{{int(rng.integers(1, 3))}}\\n")
qrels = load_qrels("qrels.tsv")
assert len(compute_qpp_dir("runs", "qpp", device="cpu")) == R
qpp = load_qpp_scores("qpp")
fused = run_fusion("wcombsum", "runs", "qpp", k_out=30, device="cpu")
assert fused.doc_ids.shape == (1, Q, 30)
metrics = IREvaluator(device="cpu").evaluate(fused, qrels)
assert 0 < metrics["nDCG@10"] < 1 and len(metrics) == 10
out = train_fusion_models(RunTensor.from_trec_dir("runs"), qpp, qrels,
                          model_types=("per_retriever",), output_dir=".", device="cpu")
assert set(out) == {{"_baselines", "per_retriever"}}
learned = run_fusion("learned", "runs", qpp, model_path="fusion_per_retriever.pkl",
                     device="cpu")
assert learned.retrievers == ["learned"]
assert not any(m == "jax" or m.startswith(("jax.", "yaml", "pandas", "qpp_fusion_rag_tpu."))
               for m in sys.modules if sys.modules[m] is not None)
print("isolated ok")
""")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env.pop("QPP_CONFIG", None)
    r = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                       env=env, timeout=300, cwd=tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "isolated ok" in r.stdout


# ------------------------------------------------------------ q8r ---------

RS_KW = dict(k=K, k_out=K, sparse_mode="q8r", dense_rescore_pool=POOL,
             sparse_presorted=True, doc_imp_bits=IMP_BITS)


def _assert_step_close(to, jo):
    assert [x.shape for x in to] == [x.shape for x in jo] == [(B, K), (B, K), (5, B, 13)]
    np.testing.assert_allclose(to[2], jo[2], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(to[1], jo[1], rtol=1e-5)
    _assert_ids_equal_up_to_near_ties(to[0], to[1], jo[0])


def test_q8r_step_matches_jax_whole_row_pool(built):
    """(a) JAX's own step at p_cap 64: M = 512 (BM25) and 1024 (SPLADE), so
    1024 candidates are the whole row on both views."""
    kw = dict(RS_KW, p_cap=CAP, sparse_candidates=1024)
    jo = [np.asarray(x) for x in JE.ensemble_retrieval_step(
        built["jidx_rs"], *built["inputs"], **kw)]
    to = [x.numpy() for x in TE.ensemble_retrieval_step(
        built["tidx_rs"], *built["inputs"], **kw)]
    _assert_step_close(to, jo)


@partial(jax.jit, static_argnames=("k", "p_cap", "candidates", "pool"))
def _jax_q8r_step_bitonic(idx, bt, bq, st, sq, q_emb, proj, tf, k, p_cap, candidates, pool):
    """JAX's _ensemble_retrieval_step (q8r, dense pool) spelled out from its
    public functions, with the sparse pools on the bitonic route."""
    kw = dict(k=k, p_cap=p_cap, candidates=candidates, bitonic=True, imp_bits=IMP_BITS,
              presorted=True)
    bm25_s, bm25_i = sparse_score_topk_q8_rescored(
        idx.bm25_packed, idx.bm25_offsets, idx.bm25_scales, idx.bm25_doc_packed,
        idx.bm25_doc_scale, bt, bq, **kw)
    splade_s, splade_i = sparse_score_topk_q8_rescored(
        idx.splade_packed, idx.splade_offsets, idx.splade_scales, idx.splade_doc_packed,
        idx.splade_doc_scale, st, sq, **kw)
    dense_s, dense_i = JE.dense_view_rescored(q_emb, idx.corpus_int, idx.d_scale,
                                              idx.corpus_rows, k, pool)
    qv = jnp.einsum("bd,vdw->vbw", q_emb.astype(jnp.float32), proj)
    rr_s, rr_i = JE.rerank_candidates(qv, bm25_i, idx.corpus_rows, idx.d_scale)
    vals = jnp.stack([bm25_s, splade_s, dense_s, rr_s[0], rr_s[1]])
    ids = jnp.stack([bm25_i, splade_i, dense_i, rr_i[0], rr_i[1]])
    qpp = JE.normalize_qpp_with(qpp_from_runs(vals, ids, tf, normalize=False), None)
    fused_ids, fused_scores = JE.fuse_tail(vals, ids, qpp, JF.COMBSUM, 5, k, None)
    return fused_ids, fused_scores, qpp


def test_q8r_step_matches_jax_bitonic_pool(built, monkeypatch):
    """(b) p_cap 128 over postings packed at cap 128, 256 candidates: BM25's
    M = 1024 takes the full-sort pool (K5), SPLADE's M = 2048 the top-bs
    pool (K4)."""
    from qpp_fusion_rag_tpu_torch.ops import sparse as TSP

    routes = []
    for name in ("bitonic_sort_rows", "bitonic_topp_rows"):
        fn = getattr(TSP, name)
        monkeypatch.setattr(TSP, name, lambda keys, *a, _f=fn, _n=name, **kw: (
            routes.append((_n, keys.shape[1])) or _f(keys, *a, **kw)))
    jo = [np.asarray(x) for x in _jax_q8r_step_bitonic(
        built["jidx_b"], *map(jnp.asarray, built["inputs"]), k=K, p_cap=CAP_B,
        candidates=256, pool=POOL)]
    to = [x.numpy() for x in TE.ensemble_retrieval_step(
        built["tidx_b"], *built["inputs"], p_cap=CAP_B, sparse_candidates=256, **RS_KW)]
    assert routes == [("bitonic_sort_rows", 1024), ("bitonic_topp_rows", 2048)]
    _assert_step_close(to, jo)


def test_dense_view_rescored_matches_jax(built):
    jidx, tidx = built["jidx_rs"], built["tidx_rs"]
    q = built["inputs"][4]
    js, ji = map(np.asarray, JE.dense_view_rescored(
        jnp.asarray(q), jidx.corpus_int, jidx.d_scale, jidx.corpus_rows, K, POOL))
    ts, ti = TE.dense_view_rescored(torch.as_tensor(q), tidx.corpus_rows, tidx.d_scale,
                                    tidx.rerank_rows, K, POOL)
    np.testing.assert_allclose(ts.numpy(), js, rtol=1e-5, atol=1e-6)
    _assert_ids_equal_up_to_near_ties(ti.numpy(), ts.numpy(), ji)


def test_step_takes_doc_imp_bits_and_sort_ids(built):
    """The JAX signature: doc_imp_bits is reconciled with the index's value
    (a conflict raises), and sparse_sort_ids reaches the rescore (it breaks
    exact ties by doc id instead of pool position, as in JAX)."""
    tidx, inputs = built["tidx"], built["inputs"]
    base = TE.ensemble_retrieval_step(tidx, *inputs, **STEP_KW)
    same = TE.ensemble_retrieval_step(tidx, *inputs, doc_imp_bits=IMP_BITS, **STEP_KW)
    for x, y in zip(base, same):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="conflicts"):
        TE.ensemble_retrieval_step(built["tidx_rs"], *inputs, **dict(
            RS_KW, p_cap=CAP, doc_imp_bits=IMP_BITS - 2))
    kw = dict(RS_KW, p_cap=CAP, sparse_candidates=1024, sparse_sort_ids=True)
    jo = [np.asarray(x) for x in JE.ensemble_retrieval_step(built["jidx_rs"], *inputs, **kw)]
    to = [x.numpy() for x in TE.ensemble_retrieval_step(built["tidx_rs"], *inputs, **kw)]
    _assert_step_close(to, jo)


def test_interop_carries_the_rank_safe_index(built):
    arrays, tidx, jidx = built["arrays_rs"], built["tidx_rs"], built["jidx_rs"]
    assert tidx.corpus_rows.dtype == torch.int8
    np.testing.assert_array_equal(tidx.corpus_rows.numpy(), arrays["corpus_int"].T)
    assert tidx.rerank_rows.dtype == torch.bfloat16
    np.testing.assert_array_equal(tidx.rerank_rows.view(torch.int16).numpy(),
                                  np.asarray(jidx.corpus_rows).view(np.int16))
    for f in ("bm25_packed", "bm25_scales", "bm25_offsets", "splade_packed",
              "splade_scales", "splade_offsets", "bm25_doc_packed", "bm25_doc_scale",
              "splade_doc_packed", "splade_doc_scale"):
        np.testing.assert_array_equal(getattr(tidx, f).numpy(), arrays[f], err_msg=f)
    np.testing.assert_array_equal(tidx.d_scale.numpy(), arrays["d_scale"][0])
    assert tidx.doc_imp_bits == IMP_BITS
    assert not hasattr(tidx, "corpus_int")
    for f in ("bm25_tail", "splade_tail"):
        assert getattr(tidx, f).dtype == torch.float32
        np.testing.assert_array_equal(getattr(tidx, f).numpy(), arrays[f], err_msg=f)
    with pytest.raises(ValueError, match="corpus_int"):
        indexes_from_numpy({k: v for k, v in arrays.items() if k != "corpus_int"}, "cpu")
    with pytest.raises(ValueError, match="corpus_int must be int8"):
        indexes_from_numpy(dict(arrays, corpus_int=arrays["corpus_int"][:, :-1]), "cpu")
