"""Port parity, dense flagship: fused_retrieval_step on its three retrieval
routes (chunked matmul; use_pallas=True on a bf16 corpus, both layouts
(K7); corpus_scale on int8 rows (K1)) and learned_fused_retrieval_step,
against the JAX package, with the corpus and MLP parameters carried over
through pipeline.interop.

The kernel routes get integer-valued queries, projections and corpora, so
the retrieval runs are exact in any summation order and agree bit for bit
(tests/test_torch_dense.py). QPP and fusion are f32 arithmetic in another
order, held to the tolerances of the ensemble step's tests: QPP rtol 1e-4
atol 1e-5, fused scores rtol 1e-5, ids equal up to adjacent swaps whose
fused scores differ by < 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qpp_fusion_rag_tpu.models.mlp import mlp_apply as j_mlp_apply
from qpp_fusion_rag_tpu.ops.pallas.dense_topk import quantize_rows as j_quantize_rows
from qpp_fusion_rag_tpu.pipeline import engine as JE
from qpp_fusion_rag_tpu_torch.models.mlp import mlp_apply
from qpp_fusion_rag_tpu_torch.pipeline import engine as TE
from qpp_fusion_rag_tpu_torch.pipeline.interop import (
    flagship_corpus_from_numpy,
    mlp_params_from_numpy,
)

R, B, D, DV, N, K = 5, 8, 32, 48, 3000, 20


def _ints(rng, shape, lo, hi):
    return rng.integers(lo, hi + 1, shape).astype(np.float32)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    q = _ints(rng, (B, D), -2, 2)
    proj = _ints(rng, (R, D, DV), -1, 1)
    corpus = jnp.asarray(_ints(rng, (N, DV), -3, 3), jnp.bfloat16)
    c_int, c_scale = jax.jit(lambda c: j_quantize_rows(c, axis=0))(
        jnp.asarray(rng.standard_normal((DV, N)).astype(np.float32)))
    tf = np.tile(np.array([6.0, 6.0, 9.0, 5.0], np.float32), (B, 1))
    sizes = [R * 13, 32, 16, R]
    mlp = [{"w": (rng.standard_normal((a, b)) * 0.3).astype(np.float32),
            "b": (rng.standard_normal(b) * 0.1).astype(np.float32)}
           for a, b in zip(sizes[:-1], sizes[1:])]
    return dict(q=q, proj=proj, corpus=corpus, c_int=c_int, c_scale=c_scale.reshape(1, N),
                tf=tf, mlp=mlp)


def _routes(d):
    """(JAX corpus + kwargs, port corpus + kwargs) per route."""
    bf = np.asarray(d["corpus"])
    t_bf, _ = flagship_corpus_from_numpy(bf, "cpu")
    t_bf_t, _ = flagship_corpus_from_numpy(np.ascontiguousarray(bf.T), "cpu")
    t_i8, t_sc = flagship_corpus_from_numpy(np.asarray(d["c_int"]), "cpu",
                                            np.asarray(d["c_scale"]))
    return {
        "xla": ((d["corpus"], dict(chunk=1024)), (t_bf, dict(chunk=1024))),
        "pallas": ((d["corpus"], dict(use_pallas=True)), (t_bf, dict(use_pallas=True))),
        "pallas_t": ((d["corpus"].T, dict(use_pallas=True, corpus_transposed=True)),
                     (t_bf_t, dict(use_pallas=True, corpus_transposed=True))),
        "int8": ((d["c_int"], dict(corpus_scale=d["c_scale"])),
                 (t_i8, dict(corpus_scale=t_sc))),
    }


def _assert_step_close(to, jo):
    to = [x.numpy() for x in to]
    jo = [np.asarray(x) for x in jo]
    assert [x.shape for x in to] == [x.shape for x in jo] == [(B, K), (B, K), (R, B, 13)]
    np.testing.assert_allclose(to[2], jo[2], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(to[1], jo[1], rtol=1e-5)
    ti, ts, ji = to[0], to[1], jo[0]
    for b in range(B):
        i = 0
        while i < K:
            if ti[b, i] == ji[b, i]:
                i += 1
                continue
            assert i + 1 < K and ti[b, i] == ji[b, i + 1] and ti[b, i + 1] == ji[b, i], (b, i)
            assert abs(ts[b, i] - ts[b, i + 1]) < 1e-5, (b, i)
            i += 2


@pytest.mark.parametrize("route", ["xla", "pallas", "pallas_t", "int8"])
def test_fused_retrieval_step_matches_jax(data, route):
    (jc, jkw), (tc, tkw) = _routes(data)[route]
    args = (data["q"], data["proj"])
    jo = JE.fused_retrieval_step(*args, jc, data["tf"], k=K, k_out=K, **jkw)
    to = TE.fused_retrieval_step(*args, tc, data["tf"], k=K, k_out=K, **tkw)
    _assert_step_close(to, jo)


@pytest.mark.parametrize("route", ["xla", "pallas", "int8"])
def test_learned_step_matches_jax(data, route):
    (jc, jkw), (tc, tkw) = _routes(data)[route]
    jparams = [{k: jnp.asarray(v) for k, v in layer.items()} for layer in data["mlp"]]
    args = (data["q"], data["proj"])
    jo = JE.learned_fused_retrieval_step(jparams, *args, jc, data["tf"], k=K, k_out=K, **jkw)
    to = TE.learned_fused_retrieval_step(mlp_params_from_numpy(data["mlp"], "cpu"), *args, tc,
                                         data["tf"], k=K, k_out=K, **tkw)
    _assert_step_close(to, jo)


def test_frozen_qpp_stats_make_batches_independent(data):
    """Under qpp_norm_stats the step's output for a query does not depend on
    the rest of its batch (so a subset of a batch can be cross-checked),
    and both packages agree."""
    (jc, jkw), (tc, tkw) = _routes(data)["pallas"]
    vals, ids = TE._retrieve(torch.as_tensor(data["q"]), torch.as_tensor(data["proj"]), tc, K,
                             16384, True, False, None)
    stats = TE.Q.qpp_calibration_stats(TE.qpp_from_runs(
        vals, ids, torch.as_tensor(data["tf"]), normalize=False))
    args = (data["q"], data["proj"])
    jo = JE.fused_retrieval_step(*args, jc, data["tf"], k=K, k_out=K,
                                 qpp_norm_stats=jnp.asarray(stats.numpy()), **jkw)
    to = TE.fused_retrieval_step(*args, tc, data["tf"], k=K, k_out=K, qpp_norm_stats=stats,
                                 **tkw)
    _assert_step_close(to, jo)
    part = TE.fused_retrieval_step(data["q"][:3], data["proj"], tc, data["tf"][:3], k=K,
                                   k_out=K, qpp_norm_stats=stats, **tkw)
    assert torch.equal(part[0], to[0][:3])
    for a, b in zip(part[1:], to[1:]):       # f32 sums may regroup with the batch size
        torch.testing.assert_close(a, b[:3] if a.dim() == 2 else b[:, :3], rtol=1e-6,
                                   atol=1e-7)


def test_mlp_apply_matches_jax(data):
    x = np.random.default_rng(1).standard_normal((B, R * 13)).astype(np.float32)
    jparams = [{k: jnp.asarray(v) for k, v in layer.items()} for layer in data["mlp"]]
    out = mlp_apply(mlp_params_from_numpy(data["mlp"], "cpu"), torch.as_tensor(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(j_mlp_apply(jparams, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-6)


def test_interop_flagship_layouts(data):
    c_int, c_scale = np.asarray(data["c_int"]), np.asarray(data["c_scale"])
    rows, scale = flagship_corpus_from_numpy(c_int, "cpu", c_scale)
    assert rows.shape == (N, DV) and rows.is_contiguous() and scale.shape == (N,)
    assert torch.equal(rows, torch.as_tensor(c_int.T.copy()))
    bf, none = flagship_corpus_from_numpy(np.asarray(data["corpus"]), "cpu")
    assert none is None and bf.dtype == torch.bfloat16
    np.testing.assert_array_equal(bf.view(torch.int16).numpy(),
                                  np.asarray(data["corpus"]).view(np.int16))
    with pytest.raises(ValueError, match="int8"):
        flagship_corpus_from_numpy(c_int.T.copy(), "cpu", c_scale)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        flagship_corpus_from_numpy(c_int, "cpu")
    params = mlp_params_from_numpy(data["mlp"], "cpu")
    assert [p["w"].shape for p in params] == [(65, 32), (32, 16), (16, 5)]


def test_int8_route_refuses_the_jax_layout(data):
    c_int, c_scale = np.asarray(data["c_int"]), np.asarray(data["c_scale"])
    with pytest.raises(ValueError, match="flagship_corpus_from_numpy"):
        TE.fused_retrieval_step(data["q"], data["proj"], torch.as_tensor(c_int),
                                data["tf"], corpus_scale=torch.as_tensor(c_scale))
    with pytest.raises(ValueError, match="use_pallas=True"):
        TE.fused_retrieval_step(data["q"], data["proj"], torch.zeros(DV, N), data["tf"],
                                corpus_transposed=True)
