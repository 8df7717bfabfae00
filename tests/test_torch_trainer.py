"""Port parity, train/fusion_trainer.py (stage 04): build_training_data
and evaluate_weights against JAX's; train_fusion_models with the GBDT
models (JAX's host numpy trainer copied: the trees equal field by field,
train_info equal, fused metrics within 1e-6), with the MLP under JAX's
initial draws (the port's init_mlp_params monkeypatched; dropout 0 and
full-batch epochs, as tests/test_torch_train.py holds FusionMLP), the
uniform / oracle baselines, the saved models and the n_train < 1 error."""

import functools

import jax
import numpy as np
import pytest
import torch

from qpp_fusion_rag_tpu.data.runtensor import RunTensor as JRunTensor
from qpp_fusion_rag_tpu.models import mlp as JM
from qpp_fusion_rag_tpu.qpp import engine as JQE
from qpp_fusion_rag_tpu.train import fusion_trainer as JT
from qpp_fusion_rag_tpu_torch.data.runtensor import RunTensor as TRunTensor
from qpp_fusion_rag_tpu_torch.models import load_model
from qpp_fusion_rag_tpu_torch.models import mlp as TM
from qpp_fusion_rag_tpu_torch.train import fusion_trainer as TT
from torch_offline_inputs import make_qrels, make_runs

METRIC_ATOL = 1e-6


@pytest.fixture(scope="module")
def case():
    runs = make_runs(31, R=4, Q=64, K=30, n_docs=120, integer=False)
    jrt = JRunTensor.from_run_dicts(runs).minmax_normalized()
    trt = TRunTensor.from_run_dicts(runs).minmax_normalized()
    qrels = make_qrels(32, jrt.qids, n_docs=120, judged_frac=0.9)
    qpp = JQE.qpp_tensor_to_dict(JQE.compute_qpp_for_runtensor(jrt), jrt.qids, jrt.retrievers)
    del qpp["test1"]                                   # a query without QPP is dropped
    return trt, jrt, qrels, qpp


def test_build_training_data_and_evaluate_weights_match_jax(case):
    trt, jrt, qrels, qpp = case
    for metric in ("nDCG@10", "AP"):
        got = TT.build_training_data(trt, qpp, qrels, metric, device="cpu")
        want = JT.build_training_data(jrt, qpp, qrels, metric)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got[1], want[1], rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(got[2], want[2], rtol=1e-6, atol=0)
        assert got[3] == want[3] and "test1" not in got[3] and len(got[3]) > 40
    qids = want[3][::3]
    w = np.random.default_rng(3).dirichlet(np.ones(4), len(qids)).astype(np.float32)
    for metric in ("nDCG@10", "R@100"):
        a = TT.evaluate_weights(trt, qids, w, qrels, metric, device="cpu")
        b = JT.evaluate_weights(jrt, qids, w, qrels, metric)
        assert abs(a - b) <= METRIC_ATOL and 0 < a < 1


def _assert_trees_equal(tm, jm):
    assert len(tm.boosters) == len(jm.boosters)
    for tb, jb in zip(tm.boosters, jm.boosters):
        assert tb.base_score == jb.base_score and len(tb.trees) == len(jb.trees) > 0
        for tt, jt in zip(tb.trees, jb.trees):
            assert tt.keys() == jt.keys()
            for key in jt:
                np.testing.assert_array_equal(np.asarray(tt[key]), np.asarray(jt[key]), err_msg=key)


def _assert_baselines_equal(got, want):
    for key in ("n_train", "n_test"):
        assert got[key] == want[key]
    for key in ("uniform", "oracle"):
        assert abs(got[key] - want[key]) <= METRIC_ATOL, key
    assert got["oracle"] > got["uniform"]


def test_train_fusion_models_gbdt_matches_jax(case, tmp_path):
    trt, jrt, qrels, qpp = case
    kinds = ("per_retriever", "multioutput")
    got = TT.train_fusion_models(trt, qpp, qrels, kinds, output_dir=tmp_path, seed=3,
                                 device="cpu")
    want = JT.train_fusion_models(jrt, qpp, qrels, kinds, seed=3)
    assert list(got) == list(want) == ["_baselines", *kinds]
    _assert_baselines_equal(got["_baselines"], want["_baselines"])
    X = TT.build_training_data(trt, qpp, qrels, device="cpu")[0]
    for kind in kinds:
        tm, jm = got[kind]["model"], want[kind]["model"]
        assert type(tm).__name__ == type(jm).__name__
        assert all(b.device == "cpu" for b in tm.boosters)
        assert got[kind]["train_info"] == want[kind]["train_info"]
        _assert_trees_equal(tm, jm)
        assert abs(got[kind]["fused_nDCG@10"] - want[kind]["fused_nDCG@10"]) <= METRIC_ATOL
        assert got[kind]["path"] == str(tmp_path / f"fusion_{kind}.pkl")
        back = load_model(got[kind]["path"])
        np.testing.assert_array_equal(back.predict(X), tm.predict(X))


def test_train_fusion_models_mlp_matches_jax(case, monkeypatch):
    """FusionMLP from JAX's initial draws: dropout 0 and full-batch epochs
    (as tests/test_torch_train.py), the registry patched in both packages
    to build it so; epochs, lr history and losses as there; the fused
    metric of the port's predictions from JAX's trained parameters within
    1e-6."""
    trt, jrt, qrels, qpp = case
    kw = dict(dropout=0.0, batch_size=1024, epochs=15, learning_rate=0.05, patience=6)
    monkeypatch.setattr(JT, "get_model_class", lambda name: functools.partial(JM.FusionMLP, **kw))
    monkeypatch.setattr(TT, "get_model_class", lambda name: functools.partial(TM.FusionMLP, **kw))
    want = JT.train_fusion_models(jrt, qpp, qrels, ("mlp",), seed=5)
    jm = want["mlp"]["model"]
    sizes = [jm.n_input, *jm.hidden_sizes, 4]
    _, init_key = jax.random.split(jax.random.PRNGKey(5))
    init = [{k: np.array(v) for k, v in layer.items()}
            for layer in JM.init_mlp_params(init_key, sizes)]
    monkeypatch.setattr(TM, "init_mlp_params", lambda key, s, dtype=torch.float32: [
        {k: torch.from_numpy(v.copy()) for k, v in layer.items()} for layer in init])
    got = TT.train_fusion_models(trt, qpp, qrels, ("mlp",), seed=5, device="cpu")
    _assert_baselines_equal(got["_baselines"], want["_baselines"])
    tm = got["mlp"]["model"]
    assert tm.device == "cpu" and tm.seed == jm.seed == 5
    ti, ji = got["mlp"]["train_info"], want["mlp"]["train_info"]
    assert ti["epochs_run"] == ji["epochs_run"] and ti["history"]["lr"] == ji["history"]["lr"]
    np.testing.assert_allclose(ti["history"]["train_loss"], ji["history"]["train_loss"], rtol=1e-4)
    np.testing.assert_allclose(ti["history"]["val_loss"], ji["history"]["val_loss"], rtol=1e-4)
    X, _, _, qids = TT.build_training_data(trt, qpp, qrels, device="cpu")
    n_train = got["_baselines"]["n_train"]
    tm.params = [{k: np.asarray(v) for k, v in layer.items()} for layer in jm.params]
    fused = TT.evaluate_weights(trt, qids[n_train:], tm.predict(X[n_train:]), qrels, device="cpu")
    assert abs(fused - want["mlp"]["fused_nDCG@10"]) <= METRIC_ATOL


def test_train_fusion_models_refuses_an_empty_train_split(case):
    trt, jrt, qrels, qpp = case
    for mod, rt, kw in ((TT, trt, {"device": "cpu"}), (JT, jrt, {})):
        with pytest.raises(ValueError, match="leaves no training queries"):
            mod.train_fusion_models(rt, qpp, qrels, ("per_retriever",), train_ratio=0.01, **kw)
