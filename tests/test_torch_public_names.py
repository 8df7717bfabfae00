"""Port parity, names that modules already ported lacked: the host's query
text features (equal, the empty string too), normalize_qpp (minmax and
zscore, rtol 1e-5 atol 1e-6), the string-dispatch fuse with ranx's min-max
default (the fusion kernel's tolerances: ids equal, scores rtol 1e-5 atol
1e-5), segmented_sums_presorted (equal: on integer-valued contributions the
f32 run sums are exact, and on random f32 the port's blocked cumsum takes
XLA's CPU order) and exact_sparse_scores_host (numpy in both: equal)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qpp_fusion_rag_tpu.data import synthetic as JSYN
from qpp_fusion_rag_tpu.ops import fusion as JF
from qpp_fusion_rag_tpu.ops import qpp as JQ
from qpp_fusion_rag_tpu.ops import segment as JSEG
from qpp_fusion_rag_tpu_torch.data import synthetic as TSYN
from qpp_fusion_rag_tpu_torch.ops import fusion as TF
from qpp_fusion_rag_tpu_torch.ops import qpp as TQ
from qpp_fusion_rag_tpu_torch.ops import segment as TSEG

FUSE_TOL = dict(rtol=1e-5, atol=1e-5)
TEXTS = ["what is the boiling point of water", "", "   ", "A a A b", "x",
         "Héllo wörld\ttabs\nnewline", "repeat repeat repeat longer-token"]


def test_text_features_equal_jax():
    for text in TEXTS:
        assert TQ.text_features(text) == JQ.text_features(text), text
    assert TQ.text_features("") == (1.0, 1.0, 0.0, 0.0)
    got, want = TQ.text_features_batch(TEXTS), JQ.text_features_batch(TEXTS)
    assert got.dtype == want.dtype == np.float32 and got.shape == (len(TEXTS), 4)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("method", ["minmax", "zscore", "none"])
def test_normalize_qpp_matches_jax(method):
    rng = np.random.default_rng(1)
    qpp = (rng.standard_normal((40, 13)) * rng.uniform(0.1, 30, 13)).astype(np.float32)
    qpp[:, 4] = 2.5                                    # a degenerate column
    got = TQ.normalize_qpp(torch.as_tensor(qpp), method=method).numpy()
    want = np.asarray(JQ.normalize_qpp(jnp.asarray(qpp), method=method))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    if method != "none":
        assert (got[:, 4] == 0).all()


def _runs(seed, R=4, Q=12, K=24):
    rng = np.random.default_rng(seed)
    vals = np.sort(rng.uniform(0, 10, (R, Q, K)).astype(np.float32), axis=-1)[..., ::-1].copy()
    ids = np.stack([np.stack([rng.permutation(60)[:K] for _ in range(Q)])
                    for _ in range(R)]).astype(np.int32)
    n_valid = rng.integers(3, K + 1, (R, Q))
    pad = np.arange(K) >= n_valid[..., None]
    ids[pad] = -1
    vals[pad] = -np.inf
    return ids, vals


@pytest.mark.parametrize("method", ["combsum", "CombMNZ", "rrf", "sum", "mnz"])
@pytest.mark.parametrize("weighted", [False, True])
def test_fuse_matches_jax(method, weighted):
    """fusion/engine.py's calls: unweighted (min-max normalized by default)
    and weighted (taken as normalized), on numpy inputs and on tensors."""
    ids, vals = _runs(2)
    w = (np.random.default_rng(3).uniform(0.1, 1.0, ids.shape[:2]).astype(np.float32)
         if weighted else None)
    ji, js = map(np.asarray, JF.fuse(jnp.asarray(ids), jnp.asarray(vals),
                                     None if w is None else jnp.asarray(w),
                                     method=method, k_out=30))
    ti, ts = TF.fuse(ids, vals, w, method=method, k_out=30, device="cpu")
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_allclose(ts.numpy(), js, **FUSE_TOL)
    ti2, ts2 = TF.fuse(torch.as_tensor(ids), torch.as_tensor(vals),
                       None if w is None else torch.as_tensor(w), method, 60.0, None, 30)
    assert torch.equal(ti2, ti) and torch.equal(ts2, ts)


def test_fuse_explicit_minmax_and_unknown_method():
    ids, vals = _runs(4)
    for norm in (True, False):
        ji, js = map(np.asarray, JF.fuse(jnp.asarray(ids), jnp.asarray(vals),
                                         minmax_norm=norm, rrf_k=10.0, k_out=16))
        ti, ts = TF.fuse(ids, vals, minmax_norm=norm, rrf_k=10.0, k_out=16, device="cpu")
        np.testing.assert_array_equal(ti.numpy(), ji)
        np.testing.assert_allclose(ts.numpy(), js, **FUSE_TOL)
    with pytest.raises(KeyError):
        TF.fuse(ids, vals, method="borda", device="cpu")


def _sorted_rows(rng, integer):
    ids = np.sort(rng.integers(0, 300, (8, 700)), axis=1).astype(np.int32)
    ids[:, -40:] = JSEG.SENTINEL
    vals = (rng.integers(0, 50, ids.shape).astype(np.float32) if integer
            else rng.uniform(0, 3, ids.shape).astype(np.float32))
    return ids, np.where(ids == JSEG.SENTINEL, 0, vals).astype(np.float32)


@pytest.mark.parametrize("integer", [True, False])
def test_segmented_sums_presorted_matches_jax(integer):
    """The port's [..., M] rows against JAX's vmapped 1-D function: sums at
    each run's last position, -inf elsewhere; equal on integer-valued and
    on random f32 contributions."""
    ids, vals = _sorted_rows(np.random.default_rng(5 + integer), integer)
    want = np.asarray(jax.vmap(JSEG.segmented_sums_presorted)(jnp.asarray(ids),
                                                               jnp.asarray(vals)))
    got = TSEG.segmented_sums_presorted(torch.as_tensor(ids), torch.as_tensor(vals)).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.isneginf(got).any() and np.isfinite(got).sum() > 8 * 100


def test_exact_sparse_scores_host_equals_jax():
    offsets, docs, weights, _ = JSYN.zipf_bm25_csr(3000, vocab_size=800, avg_doc_len=20.0,
                                                   seed=3)
    qt, qw = JSYN.zipf_queries(offsets, 12, n_terms=6, seed=4)
    qt[2, 3:] = -1
    qt[5] = -1                                         # a query with no terms
    qw = qw * np.random.default_rng(0).uniform(0.5, 2, qw.shape).astype(np.float32)
    for k in (10, 100):
        got = TSYN.exact_sparse_scores_host(offsets, docs, weights, qt, qw, 3000, k=k)
        want = JSYN.exact_sparse_scores_host(offsets, docs, weights, qt, qw, 3000, k=k)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert (got[1][5] == -1).all() and (got[1][0] >= 0).all()


@pytest.mark.parametrize("package", ["data", "evaluation", "fusion", "train", "qpp", "ops"])
def test_packages_export_jax_names(package):
    """Each package of the offline path (and ops, with the metrics names)
    exports JAX's names: __all__ equal where JAX has one, else the same
    public names; each name is the port's own object of the same name."""
    import importlib
    import types

    j = importlib.import_module(f"qpp_fusion_rag_tpu.{package}")
    t = importlib.import_module(f"qpp_fusion_rag_tpu_torch.{package}")

    def public(mod):
        return sorted(n for n, v in vars(mod).items()
                      if not n.startswith("_") and not isinstance(v, types.ModuleType))

    names = getattr(j, "__all__", None) or public(j)
    assert (t.__all__ if hasattr(j, "__all__") else public(t)) == names
    for name in names:
        obj = getattr(t, name)
        assert getattr(obj, "__module__", "").startswith("qpp_fusion_rag_tpu_torch") or \
            not callable(obj), name
        assert getattr(obj, "__name__", name) == getattr(getattr(j, name), "__name__", name)
