"""Port parity, fusion models: ops/trees.py (stack_trees, predict_ensemble),
the GBDT (host trainer copied unchanged, so the same seed and data grow the
same trees, importances and histories; device traversal against the host
loop), the MLP's functional core, the registry, the base helpers and the
reference-pickle interop, against the JAX package on the CPU.

Tree predictions are f32 sums over trees in another order: rtol 1e-5,
atol 1e-6. The reference pickles are written here: fake ``src.models.*``
and ``lightgbm.basic`` classes are registered in sys.modules only while a
pickle is written, and both packages' shim unpicklers read it back."""

import pickle
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qpp_fusion_rag_tpu import models as JMOD
from qpp_fusion_rag_tpu.models import base as JB
from qpp_fusion_rag_tpu.models import gbdt as JG
from qpp_fusion_rag_tpu.models import interop as JI
from qpp_fusion_rag_tpu.models import mlp as JM
from qpp_fusion_rag_tpu.ops import trees as JT
from qpp_fusion_rag_tpu_torch import models as TMOD
from qpp_fusion_rag_tpu_torch.models import base as TB
from qpp_fusion_rag_tpu_torch.models import gbdt as TG
from qpp_fusion_rag_tpu_torch.models import interop as TI
from qpp_fusion_rag_tpu_torch.models import mlp as TM
from qpp_fusion_rag_tpu_torch.ops import trees as TT
from qpp_fusion_rag_tpu_torch.pipeline.interop import tree_ensemble_from_numpy

TREE_TOL = dict(rtol=1e-5, atol=1e-6)
RETRIEVERS = ["BGE", "BM25", "BM25_MonoT5", "BM25_TCT", "Splade"]
GBDT_PARAMS = dict(num_boost_round=40, early_stopping_rounds=5, num_leaves=7,
                   min_data_in_leaf=5, max_bin=32, bagging_freq=3, learning_rate=0.2)


@pytest.fixture(scope="module")
def regression():
    rng = np.random.default_rng(11)
    X = rng.random((300, 8)).astype(np.float32)
    y = (np.sin(3 * X[:, 0]) + X[:, 1] * X[:, 2] + 0.3 * rng.standard_normal(300))
    return X[:220], y[:220], X[220:], y[220:]


@pytest.fixture(scope="module")
def fusion():
    rng = np.random.default_rng(12)
    X = rng.random((120, 13 * len(RETRIEVERS))).astype(np.float32)
    Y = rng.random((120, len(RETRIEVERS))).astype(np.float32) + X[:, 5::13]
    return X[:90], (Y / Y.sum(1, keepdims=True))[:90], X[90:], (Y / Y.sum(1, keepdims=True))[90:]


def _fit_both(X, y, Xv, yv, params, seed):
    jb, tb = JG.Booster(params, seed=seed), TG.Booster(params, seed=seed, device="cpu")
    return jb, jb.fit(X, y, Xv, yv), tb, tb.fit(X, y, Xv, yv)


# ------------------------------------------------------------- trees ------

def test_stack_trees_and_predict_ensemble_match_jax(regression):
    X, y, Xv, _ = regression
    jb = JG.Booster(dict(GBDT_PARAMS, num_boost_round=12), seed=3)
    jb.fit(X, y)
    je = JT.stack_trees(jb.trees, jb.base_score, 0.2)
    te = TT.stack_trees(jb.trees, jb.base_score, 0.2, device="cpu")
    for field in ("feature", "threshold", "children", "value"):
        got, want = getattr(te, field).numpy(), np.asarray(getattr(je, field))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert (te.max_depth, te.base_score, te.learning_rate) == \
        (je.max_depth, je.base_score, je.learning_rate)
    want = np.asarray(JT.predict_ensemble(je, jnp.asarray(Xv)))
    np.testing.assert_allclose(TT.predict_ensemble(te, torch.from_numpy(Xv)).numpy(), want,
                               **TREE_TOL)
    np.testing.assert_allclose(TT.predict_ensemble(te, Xv).numpy(), want, **TREE_TOL)
    carried = tree_ensemble_from_numpy(je, "cpu")
    for field in ("feature", "threshold", "children", "value"):
        assert torch.equal(getattr(carried, field), getattr(te, field))
    assert carried[4:] == te[4:]
    leaves = TT._traverse(torch.from_numpy(Xv), te.feature, te.threshold, te.children,
                          te.value, te.max_depth)
    np.testing.assert_allclose(leaves.numpy(), np.asarray(JT._traverse(
        jnp.asarray(Xv), je.feature, je.threshold, je.children, je.value, je.max_depth)),
        **TREE_TOL)


def test_stack_trees_pads_uneven_trees_with_self_loops():
    trees = [{"feature": np.array([0, -1, -1], np.int32), "threshold": np.array([.5, 0, 0],
              np.float32), "left": np.array([1, 1, 2], np.int32),
              "right": np.array([2, 1, 2], np.int32), "value": np.array([0, -1, 1], np.float32),
              "depth": 2},
             {"feature": np.array([-1], np.int32), "threshold": np.zeros(1, np.float32),
              "left": np.zeros(1, np.int32), "right": np.zeros(1, np.int32),
              "value": np.array([0.25], np.float32), "depth": 1}]
    te = TT.stack_trees(trees, 1.0, 0.5, device="cpu")
    je = JT.stack_trees(trees, 1.0, 0.5)
    np.testing.assert_array_equal(te.children.numpy(), np.asarray(je.children))
    assert te.children[1, 2].tolist() == [2, 2]
    x = np.array([[0.2], [0.9]], np.float32)
    np.testing.assert_allclose(TT.predict_ensemble(te, x).numpy(), [1 + 0.5 * (-1 + 0.25),
                                                                    1 + 0.5 * (1 + 0.25)])


# -------------------------------------------------------------- GBDT ------

def test_gbdt_host_helpers_equal_jax(regression):
    X, y, _, _ = regression
    je, te = JG.make_bins(X, 32), TG.make_bins(X, 32)
    np.testing.assert_array_equal(te, je)
    np.testing.assert_array_equal(TG.bin_data(X, te), JG.bin_data(X, je))
    binned = JG.bin_data(X, je)
    grad = (y - y.mean())
    cols = np.arange(8)
    assert TG._best_split(binned, grad, cols, 32, 5, 0.0) == \
        JG._best_split(binned, grad, cols, 32, 5, 0.0)
    rows = np.arange(len(X))
    jt, jimp = JG.grow_tree(binned, grad, rows, je, 7, 5, 0.0, cols, 32)
    tt, timp = TG.grow_tree(binned, grad, rows, je, 7, 5, 0.0, cols, 32)
    for k in jt:
        np.testing.assert_array_equal(tt[k], jt[k])
    np.testing.assert_array_equal(timp, jimp)
    np.testing.assert_array_equal(TG._predict_tree_host(tt, X), JG._predict_tree_host(jt, X))


@pytest.mark.parametrize("seed,params", [
    (0, GBDT_PARAMS),
    (4, dict(GBDT_PARAMS, bagging_fraction=1.0, feature_fraction=0.5, lambda_l2=1.0)),
])
def test_booster_fit_grows_equal_trees(regression, seed, params):
    """Field by field, with the bag re-drawn every bagging_freq rounds and
    early stopping truncating to the best prefix; importances and the
    history equal; predictions on both routes against JAX's."""
    X, y, Xv, yv = regression
    jb, jinfo, tb, tinfo = _fit_both(X, y, Xv, yv, params, seed)
    assert len(tb.trees) == len(jb.trees) == tinfo["n_trees"]
    assert len(jinfo["history"]["val_mse"]) > len(jb.trees)      # truncated
    for jt, tt in zip(jb.trees, tb.trees):
        assert jt.keys() == tt.keys()
        for k in jt:
            np.testing.assert_array_equal(tt[k], jt[k])
    np.testing.assert_array_equal(tb.importance, jb.importance)
    assert tinfo["history"] == jinfo["history"]
    assert tinfo["best_val_mse"] == jinfo["best_val_mse"]
    assert tb.base_score == jb.base_score
    np.testing.assert_array_equal(tb.predict(Xv, device=False), jb.predict(Xv, device=False))
    dev = tb.predict(Xv)
    assert dev.dtype == np.float32
    np.testing.assert_allclose(dev, jb.predict(Xv), **TREE_TOL)
    np.testing.assert_allclose(dev, tb.predict(Xv, device=False), **TREE_TOL)
    assert tb.ensemble().feature.device.type == "cpu"


def test_booster_pickles_without_its_ensemble(regression, tmp_path):
    X, y, Xv, _ = regression
    tb = TG.Booster(dict(GBDT_PARAMS, num_boost_round=8), device="cpu")
    tb.fit(X, y)
    before = tb.predict(Xv)
    assert tb._ensemble is not None
    back = pickle.loads(pickle.dumps(tb))
    assert back._ensemble is None and back.device == "cpu"
    np.testing.assert_array_equal(back.predict(Xv), before)
    tb.fit(X[:100], y[:100])                     # a refit replaces the model
    assert tb._ensemble is None and len(tb.trees) == 8
    with pytest.raises(RuntimeError, match="no trees"):
        TG.Booster(device="cpu").ensemble()


@pytest.mark.parametrize("cls", ["PerRetrieverGBDT", "MultiOutputGBDT"])
def test_fusion_gbdt_matches_jax_and_round_trips(fusion, tmp_path, cls):
    X, Y, Xv, Yv = fusion
    params = dict(GBDT_PARAMS, num_boost_round=15)
    jm = getattr(JG, cls)(RETRIEVERS, params=params, seed=2)
    tm = getattr(TG, cls)(RETRIEVERS, params=params, seed=2, device="cpu")
    jinfo, tinfo = jm.train(X, Y, Xv, Yv), tm.train(X, Y, Xv, Yv)
    assert tinfo == jinfo
    assert [b.seed for b in tm.boosters] == [b.seed for b in jm.boosters]
    np.testing.assert_allclose(tm.predict(Xv), jm.predict(Xv), rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(tm.feature_importance, jm.feature_importance)
    assert tm.feature_names == jm.feature_names and tm.n_features == 65
    tm.save(tmp_path / "m.pkl")
    with open(tmp_path / "m.pkl", "rb") as f:
        env = pickle.load(f)
    assert (env["retrievers"], env["n_qpp"], env["model_type"]) == (RETRIEVERS, 13, cls)
    back = TMOD.load_model(tmp_path / "m.pkl")
    assert type(back) is getattr(TG, cls)
    np.testing.assert_array_equal(back.predict(Xv), tm.predict(Xv))
    row = {r: list(Xv[0, 13 * j:13 * (j + 1)]) for j, r in enumerate(RETRIEVERS)}
    single, want = tm.predict_single(row), jm.predict_single(row)
    assert list(single) == list(want) == RETRIEVERS
    np.testing.assert_allclose(list(single.values()), list(want.values()), rtol=1e-5,
                               atol=1e-7)


# ------------------------------------------------------- base, registry ----

def test_registry_and_exports_match_jax():
    assert TMOD.__all__ == JMOD.__all__
    assert list(TMOD.MODEL_REGISTRY) == list(JMOD.MODEL_REGISTRY)
    assert [c.__name__ for c in TMOD.MODEL_REGISTRY.values()] == \
        [c.__name__ for c in JMOD.MODEL_REGISTRY.values()]
    assert TMOD.get_model_class("mlp") is TM.FusionMLP
    with pytest.raises(KeyError, match="Unknown model type"):
        TMOD.get_model_class("lgbm")


def test_build_features_compute_targets_and_normalize_match_jax():
    rng = np.random.default_rng(3)
    qpp = {f"q{i}": {r: list(rng.random(13 if i % 3 else 9)) for r in RETRIEVERS[:4]}
           for i in range(7)}
    for kw in ({}, dict(n_qpp=5), dict(qids=["q3", "q1", "missing"])):
        tX, tq = TB.build_features(qpp, RETRIEVERS, **kw)
        jX, jq = JB.build_features(qpp, RETRIEVERS, **kw)
        np.testing.assert_array_equal(tX, jX)
        assert tq == jq
    quality = rng.random((5, 9)).astype(np.float32)
    quality[:, 2] = 0
    np.testing.assert_array_equal(TB.compute_targets(quality), JB.compute_targets(quality))
    w = rng.standard_normal((6, 5)).astype(np.float32)
    w[1] = -1
    np.testing.assert_array_equal(TB.BaseFusionModel._normalize_weights(w),
                                  JB.BaseFusionModel._normalize_weights(w))
    np.testing.assert_array_equal(TI._normalize_weights(w), JI._normalize_weights(w))


# --------------------------------------------------------------- MLP ------

def _mlp_params(rng, sizes):
    return [{"w": (rng.standard_normal((a, b)) * 0.4).astype(np.float32),
             "b": (rng.standard_normal(b) * 0.1).astype(np.float32)}
            for a, b in zip(sizes[:-1], sizes[1:])]


def test_mlp_apply_and_soft_cross_entropy_match_jax():
    """On grid-valued inputs (integer features, weights in steps of 1/16)
    every product and sum of the three layers is exact in f32, so the
    logits agree to rtol 1e-6 (they are equal) whatever the summation
    order; on random inputs, f32 sums of up to 65 products in another
    order, within rtol 1e-5, atol 1e-5. A dropout without a key changes
    nothing."""
    rng = np.random.default_rng(4)
    sizes = [65, 32, 16, 5]
    grid = [{"w": rng.integers(-2, 3, (a, b)).astype(np.float32) / 16,
             "b": rng.integers(-2, 3, b).astype(np.float32) / 16}
            for a, b in zip(sizes[:-1], sizes[1:])]
    t = rng.random((40, 5)).astype(np.float32)
    t /= t.sum(1, keepdims=True)
    for params, x, tol in (
            (grid, rng.integers(-3, 4, (40, 65)).astype(np.float32), dict(rtol=1e-6, atol=0)),
            (_mlp_params(rng, sizes), rng.standard_normal((40, 65)).astype(np.float32),
             dict(rtol=1e-5, atol=1e-5))):
        tp = [{k: torch.from_numpy(v) for k, v in layer.items()} for layer in params]
        jl = np.array(JM.mlp_apply(params, jnp.asarray(x)))
        tl = TM.mlp_apply(tp, torch.from_numpy(x), dropout=0.5)
        np.testing.assert_allclose(tl.numpy(), jl, **tol)
        np.testing.assert_allclose(
            float(TM.soft_cross_entropy(torch.from_numpy(jl), torch.from_numpy(t))),
            float(JM.soft_cross_entropy(jnp.asarray(jl), jnp.asarray(t))), rtol=1e-6)


def test_mlp_dropout_keeps_one_minus_p_and_rescales():
    """With a key: hidden units are kept at about 1 - p and survivors are
    scaled by 1 / (1 - p); the same generator seed draws the same mask, and
    the generator advances between calls."""
    p = 0.3
    eye = [{"w": torch.eye(256), "b": torch.zeros(256)}, {"w": torch.eye(256),
                                                           "b": torch.zeros(256)}]
    x = torch.rand(64, 256) + 0.5
    a = TM.mlp_apply(eye, x, dropout=p, key=torch.Generator().manual_seed(9))
    b = TM.mlp_apply(eye, x, dropout=p, key=torch.Generator().manual_seed(9))
    assert torch.equal(a, b)
    kept = a != 0
    assert abs(float(kept.float().mean()) - (1 - p)) < 0.01
    torch.testing.assert_close(a[kept], (x / (1 - p))[kept], rtol=1e-6, atol=0)
    g = torch.Generator().manual_seed(9)
    first = TM.mlp_apply(eye, x, dropout=p, key=g)
    assert torch.equal(first, a) and not torch.equal(TM.mlp_apply(eye, x, dropout=p, key=g), a)


def test_init_mlp_params_he_scale_and_dtype():
    params = TM.init_mlp_params(torch.Generator().manual_seed(0), [400, 300, 5],
                                dtype=torch.float64)
    assert [tuple(layer["w"].shape) for layer in params] == [(400, 300), (300, 5)]
    assert params[0]["w"].dtype == torch.float64 and (params[0]["b"] == 0).all()
    assert abs(float(params[0]["w"].std()) - np.sqrt(2 / 400)) < 2e-3
    jparams = JM.init_mlp_params(jax.random.PRNGKey(0), [400, 300, 5])
    assert abs(float(jnp.std(jparams[0]["w"])) - float(params[0]["w"].std())) < 2e-3


# ----------------------------------------------------------- interop ------

def _tree_text(i, shift):
    """LightGBM model-text sections: a two-split tree, a constant tree and
    a three-split tree (features < 13, thresholds shifted per model)."""
    return "\n".join([
        f"Tree={3 * i}", "num_leaves=3", "num_cat=0", "split_feature=2 7",
        "split_gain=1 1", f"threshold={0.5 + shift} {0.25 + shift}", "decision_type=2 2",
        "left_child=1 -1", "right_child=-3 -2", f"leaf_value=0.1 {-0.2 + shift} 0.3",
        "shrinkage=0.1", "",
        f"Tree={3 * i + 1}", "num_leaves=1", f"leaf_value={0.05 + shift}", "shrinkage=1", "",
        f"Tree={3 * i + 2}", "num_leaves=4", "split_feature=0 5 12",
        f"threshold={0.3 + shift} 0.6 0.4", "left_child=1 -1 -3", "right_child=2 -2 -4",
        f"leaf_value=-0.1 0.2 {0.15 + shift} 0.4", ""])


def _model_text(shift):
    return ("tree\nversion=v4\nnum_class=1\nmax_feature_idx=64\n\n"
            + _tree_text(0, shift) + "\nend of trees\n\nfeature_importances:\nColumn_2=1\n")


def test_parse_lgbm_model_text_matches_jax_and_host_traversal():
    text = _model_text(0.0)
    jt, tt = JI.parse_lgbm_model_str(text), TI.parse_lgbm_model_str(text)
    assert len(tt) == len(jt) == 3
    for a, b in zip(tt, jt):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    assert [t["depth"] for t in tt] == [3, 1, 3]
    x = np.random.default_rng(6).random((50, 65)).astype(np.float32)
    want = sum(TI._traverse_host(t, x) for t in tt)
    np.testing.assert_array_equal(want, sum(JI._traverse_host(t, x) for t in jt))
    ens = TI.booster_to_ensemble(text, "cpu")
    assert (ens.base_score, ens.learning_rate) == (0.0, 1.0)
    np.testing.assert_allclose(TT.predict_ensemble(ens, x).numpy(), want, **TREE_TOL)
    np.testing.assert_allclose(TT.predict_ensemble(ens, x).numpy(),
                               np.asarray(JT.predict_ensemble(JI.booster_to_ensemble(text),
                                                              jnp.asarray(x))), **TREE_TOL)
    with pytest.raises(ValueError, match="no Tree"):
        TI.parse_lgbm_model_str("tree\nversion=v4\n")
    with pytest.raises(ValueError, match="categorical"):
        TI.parse_lgbm_model_str("Tree=0\nnum_leaves=2\nsplit_feature=1\nthreshold=1\n"
                                "decision_type=1\nleft_child=-1\nright_child=-2\n"
                                "leaf_value=1 2\n")


class _FakeBooster:
    def __init__(self, text):
        self.text = text

    def __getstate__(self):
        return {"handle": self.text, "best_iteration": -1, "pandas_categorical": None}


def _write_reference_pickle(path, monkeypatch, model_type):
    """An envelope the reference would write, through fake classes that
    exist in sys.modules only while the pickle is written."""
    fakes = {}
    for name in ("src", "src.models", "src.models.lightgbm_models", "src.models.mlp_model",
                 "lightgbm", "lightgbm.basic"):
        fakes[name] = types.ModuleType(name)
    booster = type("Booster", (_FakeBooster,), {"__module__": "lightgbm.basic"})
    fakes["lightgbm.basic"].Booster = booster
    for cls in ("MultiOutputLGBM", "PerRetrieverLGBM"):
        setattr(fakes["src.models.lightgbm_models"], cls,
                type(cls, (), {"__module__": "src.models.lightgbm_models"}))
    fakes["src.models.mlp_model"].FusionMLP = type("FusionMLP", (),
                                                   {"__module__": "src.models.mlp_model"})
    with monkeypatch.context() as m:
        for name, mod in fakes.items():
            m.setitem(sys.modules, name, mod)
        if model_type == "FusionMLP":
            model = fakes["src.models.mlp_model"].FusionMLP()
            rng = np.random.default_rng(8)
            seq = torch.nn.Sequential(torch.nn.Linear(5, 8), torch.nn.ReLU(),
                                      torch.nn.Dropout(0.2), torch.nn.Linear(8, 5))
            with torch.no_grad():
                for layer in (seq[0], seq[3]):
                    layer.weight.copy_(torch.from_numpy(
                        rng.standard_normal(tuple(layer.weight.shape)).astype(np.float32)))
                    layer.bias.copy_(torch.from_numpy(
                        rng.standard_normal(tuple(layer.bias.shape)).astype(np.float32)))
            model.__dict__.update(model=seq, qpp_indices=[5])
        else:
            model = getattr(fakes["src.models.lightgbm_models"], model_type)()
            boosters = [booster(_model_text(0.05 * j)) for j in range(len(RETRIEVERS))]
            model.models = (boosters if model_type == "MultiOutputLGBM"
                            else dict(zip(RETRIEVERS, boosters)))
        with open(path, "wb") as f:
            pickle.dump({"model": model, "retrievers": RETRIEVERS, "n_qpp": 13,
                         "model_type": model_type}, f)
    assert "src" not in sys.modules and "lightgbm.basic" not in sys.modules


@pytest.mark.parametrize("model_type", ["MultiOutputLGBM", "PerRetrieverLGBM", "FusionMLP"])
def test_load_reference_fusion_model_matches_jax(tmp_path, monkeypatch, model_type):
    path = tmp_path / f"{model_type}.pkl"
    _write_reference_pickle(path, monkeypatch, model_type)
    jm = JI.load_reference_fusion_model(path)
    tm = TI.load_reference_fusion_model(path, device="cpu")
    assert type(tm).__name__ == type(jm).__name__ and tm.retrievers == RETRIEVERS
    x = np.random.default_rng(9).random((30, 65)).astype(np.float32)
    tw, jw = tm.predict(x), jm.predict(x)
    assert tw.shape == (30, 5) and (tw >= 0).all()
    np.testing.assert_allclose(tw.sum(1), 1.0, rtol=1e-6)
    if model_type == "FusionMLP":
        for (tW, tb), (jW, jb) in zip(tm.layers, jm.layers):
            np.testing.assert_array_equal(tW, jW)
            np.testing.assert_array_equal(tb, jb)
        np.testing.assert_array_equal(tw, jw)
    else:
        assert all(e.feature.device.type == "cpu" for e in tm.ensembles)
        for te, je in zip(tm.ensembles, jm.ensembles):
            np.testing.assert_array_equal(te.feature.numpy(), np.asarray(je.feature))
            np.testing.assert_array_equal(te.value.numpy(), np.asarray(je.value))
        np.testing.assert_allclose(tw, jw, rtol=1e-5, atol=1e-6)
