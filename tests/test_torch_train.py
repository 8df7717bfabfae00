"""Port parity, learned-fusion training: pipeline/engine.py's
learned_fusion_train_step from the same carried-over MLP parameters (one
step, and one step after three JAX steps whose optax Adam state is carried
over with pipeline.interop.adam_state_from_optax), and FusionMLP.train's
whole loop, against the JAX package on the CPU.

The step's retrieval takes integer-valued queries, projections and corpus,
so the runs are exact in any summation order (tests/test_torch_engine.py);
the QPP features, the MLP and Adam are f32 arithmetic in another order:
the loss and the updated parameters agree to rtol 1e-5, atol 1e-6.

jax.random's draws cannot be reproduced, so the FusionMLP loop runs with
dropout 0 and a batch of all the rows (one epoch is one full-batch step,
and the permutation moves only the rounding), from JAX's initial
parameters (the port's init_mlp_params monkeypatched to return them). The
fixture keeps every monitored loss more than 1e-5 away from the early
stopping threshold, so epochs_run and the learning-rate history are equal;
the losses agree to rtol 1e-4 and the final parameters to rtol 1e-3, atol
1e-5 (optax and torch apply Adam's bias corrections in another order)."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qpp_fusion_rag_tpu.models import mlp as JM
from qpp_fusion_rag_tpu.pipeline import engine as JE
from qpp_fusion_rag_tpu_torch.models import mlp as TM
from qpp_fusion_rag_tpu_torch.pipeline import engine as TE
from qpp_fusion_rag_tpu_torch.pipeline.interop import (
    adam_state_from_optax,
    mlp_params_from_numpy,
)

REPO = Path(__file__).resolve().parents[1]
R, B, D, DV, N, K = 5, 16, 32, 48, 3000, 20
STEP_TOL = dict(rtol=1e-5, atol=1e-6)


def _ints(rng, shape, lo, hi):
    return rng.integers(lo, hi + 1, shape).astype(np.float32)


@pytest.fixture(scope="module")
def step_data():
    rng = np.random.default_rng(0)
    q = _ints(rng, (B, D), -2, 2)
    proj = _ints(rng, (R, D, DV), -1, 1)
    corpus = _ints(rng, (N, DV), -3, 3)
    tf = np.column_stack([rng.integers(1, 9, B), rng.integers(1, 9, B),
                          rng.integers(1, 12, B), rng.uniform(1, 8, B)]).astype(np.float32)
    targets = rng.random((B, R)).astype(np.float32)
    targets /= targets.sum(1, keepdims=True)
    return dict(q=q, proj=proj, corpus=corpus, tf=tf, targets=targets)


def _jax_step(state, opt, d):
    return JE.learned_fusion_train_step(
        state, opt, jnp.asarray(d["q"]), jnp.asarray(d["targets"]), jnp.asarray(d["proj"]),
        jnp.asarray(d["corpus"], jnp.bfloat16), jnp.asarray(d["tf"]), k=K, chunk=1024)


def _port_step(state, opt, d):
    return TE.learned_fusion_train_step(
        state, opt, d["q"], d["targets"], d["proj"],
        torch.as_tensor(d["corpus"]).to(torch.bfloat16), d["tf"], k=K, chunk=1024)


def _carry(jstate, lr=1e-3):
    """The port's state from the JAX state's parameters, a fresh Adam."""
    params = mlp_params_from_numpy(jstate.params, "cpu", requires_grad=True)
    opt = torch.optim.Adam([p for layer in params for p in layer.values()], lr=lr,
                           betas=(0.9, 0.999), eps=1e-8)
    return TE.TrainState(params, opt.state), opt


def _assert_params_close(tparams, jparams, **tol):
    assert len(tparams) == len(jparams)
    for lt, lj in zip(tparams, jparams):
        for name in ("w", "b"):
            np.testing.assert_allclose(lt[name].detach().numpy(), np.asarray(lj[name]), **tol)


def test_train_step_matches_jax(step_data):
    """One step from the same parameters: the loss and the updated
    parameters; the caller's carried arrays stay as they were."""
    jstate, jopt = JE.make_train_state(jax.random.PRNGKey(0), R, R * 13)
    p0 = [{k: np.asarray(v).copy() for k, v in layer.items()} for layer in jstate.params]
    tstate, topt = _carry(jstate)
    jstate, jloss = _jax_step(jstate, jopt, step_data)
    tstate2, tloss = _port_step(tstate, topt, step_data)
    assert tstate2 is tstate and tloss.shape == () and not tloss.requires_grad
    np.testing.assert_allclose(float(tloss), float(jloss), **STEP_TOL)
    _assert_params_close(tstate.params, jstate.params, **STEP_TOL)
    moved = [np.abs(tstate.params[i][n].detach().numpy() - p0[i][n]).max()
             for i in range(len(p0)) for n in ("w", "b")]
    assert min(moved) > 0
    np.testing.assert_array_equal(np.asarray(JE.make_train_state(
        jax.random.PRNGKey(0), R, R * 13)[0].params[0]["w"]), p0[0]["w"])


def test_train_step_after_carried_adam_state_matches_jax(step_data):
    """Three JAX steps, then optax's Adam state (count, mu, nu) carried
    into torch's Adam: the fourth step agrees in both packages."""
    jstate, jopt = JE.make_train_state(jax.random.PRNGKey(1), R, R * 13, hidden_sizes=(16, 8))
    for _ in range(3):
        jstate, _ = _jax_step(jstate, jopt, step_data)
    tstate, topt = _carry(jstate)
    assert adam_state_from_optax(topt, tstate.params, jstate.opt_state) is topt
    p = tstate.params[0]["w"]
    assert float(topt.state[p]["step"]) == 3.0
    np.testing.assert_array_equal(topt.state[p]["exp_avg"].numpy(),
                                  np.asarray(jstate.opt_state[0].mu[0]["w"]))
    jstate, jloss = _jax_step(jstate, jopt, step_data)
    tstate, tloss = _port_step(tstate, topt, step_data)
    np.testing.assert_allclose(float(tloss), float(jloss), **STEP_TOL)
    _assert_params_close(tstate.params, jstate.params, **STEP_TOL)
    assert float(topt.state[p]["step"]) == 4.0


def test_make_train_state_shapes_and_optimizer():
    """He-init shapes from the generator, leaves that take gradients, and
    Adam with optax's defaults; the same seed draws the same parameters."""
    state, opt = TE.make_train_state(torch.Generator().manual_seed(3), 5, 65, (32, 16), 2e-3)
    assert [tuple(layer["w"].shape) for layer in state.params] == [(65, 32), (32, 16), (16, 5)]
    assert all(p.is_leaf and p.requires_grad for layer in state.params for p in layer.values())
    assert all((layer["b"] == 0).all() for layer in state.params)
    assert state.opt_state is opt.state
    group = opt.param_groups[0]
    assert (group["lr"], group["betas"], group["eps"]) == (2e-3, (0.9, 0.999), 1e-8)
    again, _ = TE.make_train_state(torch.Generator().manual_seed(3), 5, 65, (32, 16), 2e-3)
    assert torch.equal(again.params[0]["w"], state.params[0]["w"])
    std = float(state.params[0]["w"].detach().std())
    assert abs(std - np.sqrt(2 / 65)) < 0.03


# --------------------------------------------------------- FusionMLP ------

RETRIEVERS = ["bm25", "splade", "bge", "tct", "hybrid"]


@pytest.fixture(scope="module")
def mlp_data():
    rng = np.random.default_rng(5)
    n, nv = 48, 16
    X = rng.random((n + nv, 13 * len(RETRIEVERS))).astype(np.float32)
    w = rng.standard_normal((len(RETRIEVERS), len(RETRIEVERS))).astype(np.float32)
    logits = X[:, 5::13] @ w * 2.0
    Y = np.exp(logits - logits.max(1, keepdims=True))
    Y = (Y / Y.sum(1, keepdims=True)).astype(np.float32)
    return X[:n], Y[:n], X[n:], Y[n:]


def _jax_init(seed, sizes):
    """JAX's FusionMLP.train initial draws."""
    _, init_key = jax.random.split(jax.random.PRNGKey(seed))
    return [{k: np.array(v) for k, v in layer.items()}
            for layer in JM.init_mlp_params(init_key, sizes)]


def _threshold_margins(monitored):
    """Distance of each monitored loss after the first to the early
    stopping threshold (the best loss so far, less 1e-6)."""
    best, out = monitored[0], []
    for m in monitored[1:]:
        out.append(abs(m - (best - 1e-6)))
        if m < best - 1e-6:
            best = m
    return out


@pytest.mark.parametrize("qpp_indices,lr,epochs", [([5], 0.05, 20), ([0, 5, 10], 0.3, 20)])
def test_fusion_mlp_train_loop_matches_jax(mlp_data, monkeypatch, qpp_indices, lr, epochs):
    """The whole loop, with plateaus that halve the learning rate (the
    larger rate overshoots) and early stopping: epochs_run and the lr
    history equal, the losses and the kept parameters close, and predict
    on the same parameters to rtol 1e-5."""
    X, Y, Xv, Yv = mlp_data
    kw = dict(qpp_indices=qpp_indices, dropout=0.0, learning_rate=lr, epochs=epochs,
              batch_size=len(X), patience=6, seed=7)
    jm = JM.FusionMLP(RETRIEVERS, **kw)
    jinfo = jm.train(X, Y, Xv, Yv)
    sizes = [jm.n_input, *jm.hidden_sizes, len(RETRIEVERS)]
    init = _jax_init(7, sizes)

    def jax_draws(key, s, dtype=torch.float32):
        assert list(s) == sizes and isinstance(key, torch.Generator)
        return [{k: torch.from_numpy(v) for k, v in layer.items()} for layer in init]

    monkeypatch.setattr(TM, "init_mlp_params", jax_draws)
    tm = TM.FusionMLP(RETRIEVERS, device="cpu", **kw)
    tinfo = tm.train(X, Y, Xv, Yv)
    assert min(_threshold_margins(jinfo["history"]["val_loss"])) > 1e-5
    assert tinfo["epochs_run"] == jinfo["epochs_run"]
    assert tinfo["history"]["lr"] == jinfo["history"]["lr"]
    assert len(set(jinfo["history"]["lr"])) > 1                 # the rate was halved
    np.testing.assert_allclose(tinfo["history"]["train_loss"], jinfo["history"]["train_loss"],
                               rtol=1e-4)
    np.testing.assert_allclose(tinfo["history"]["val_loss"], jinfo["history"]["val_loss"],
                               rtol=1e-4)
    np.testing.assert_allclose(tinfo["best_loss"], jinfo["best_loss"], rtol=1e-4)
    for lt, lj in zip(tm.params, jm.params):
        for name in ("w", "b"):
            assert isinstance(lt[name], np.ndarray)
            np.testing.assert_allclose(lt[name], np.asarray(lj[name]), rtol=1e-3, atol=1e-5)
    tm.params = [{k: np.asarray(v) for k, v in layer.items()} for layer in jm.params]
    np.testing.assert_allclose(tm.predict(Xv), jm.predict(Xv), rtol=1e-5)


def test_fusion_mlp_defaults_dropout_and_pickle(mlp_data, tmp_path):
    """The config defaults (RSD-only features, hidden [32, 16]), a dropout
    run from a seeded generator (the same seed trains the same model), no
    validation set (the train loss is monitored), and save / load."""
    X, Y, _, _ = mlp_data
    m = TM.FusionMLP(RETRIEVERS, epochs=5, device="cpu")
    assert (m.hidden_sizes, m.qpp_indices, m.dropout, m.batch_size, m.patience) == \
        ([32, 16], [5], 0.2, 64, 15)
    info = m.train(X, Y)
    assert info["history"]["val_loss"] == [None] * 5 and info["epochs_run"] == 5
    again = TM.FusionMLP(RETRIEVERS, epochs=5, device="cpu")
    again.train(X, Y)
    for a, b in zip(m.params, again.params):
        np.testing.assert_array_equal(a["w"], b["w"])
    w = m.predict(X)
    assert w.dtype == np.float32 and w.shape == (len(X), 5)
    np.testing.assert_allclose(w.sum(1), 1.0, rtol=1e-6)
    m.save(tmp_path / "mlp.pkl")
    from qpp_fusion_rag_tpu_torch.models import load_model

    back = load_model(tmp_path / "mlp.pkl")
    np.testing.assert_array_equal(back.predict(X), w)
    with pytest.raises(RuntimeError, match="not trained"):
        TM.FusionMLP(RETRIEVERS, device="cpu").predict(X)


# ------------------------------------------------------- isolation ------

def test_port_trains_without_jax_yaml_or_reference(tmp_path):
    """A subprocess in which jax, yaml and the JAX package cannot be
    imported trains a FusionMLP and a Booster and takes one
    learned_fusion_train_step on the CPU."""
    script = tmp_path / "isolated_train.py"
    script.write_text(f"""
import sys
for name in ("jax", "jaxlib", "yaml", "qpp_fusion_rag_tpu"):
    sys.modules[name] = None
sys.path.insert(0, {str(REPO)!r})
import numpy as np, torch
from qpp_fusion_rag_tpu_torch.config import config
from qpp_fusion_rag_tpu_torch.models import Booster, FusionMLP, get_model_class
from qpp_fusion_rag_tpu_torch.pipeline.engine import make_train_state, learned_fusion_train_step
assert config.qpp.n_methods == 13 and get_model_class("mlp") is FusionMLP
rng = np.random.default_rng(0)
X = rng.random((64, 39)).astype(np.float32)
Y = rng.random((64, 3)).astype(np.float32)
Y /= Y.sum(1, keepdims=True)
m = FusionMLP(["a", "b", "c"], epochs=3, device="cpu")
assert m.train(X[:48], Y[:48], X[48:], Y[48:])["epochs_run"] == 3
assert m.predict(X).shape == (64, 3)
b = Booster(dict(num_boost_round=5), device="cpu")
b.fit(X, Y[:, 0])
assert np.allclose(b.predict(X), b.predict(X, device=False), rtol=1e-5, atol=1e-6)
state, opt = make_train_state(torch.Generator().manual_seed(0), 3, 39)
q = torch.randn(8, 16)
corpus = torch.randn(500, 16).to(torch.bfloat16)
proj = torch.randn(3, 16, 16) * 0.1
tf = np.tile(np.array([6, 6, 9, 5], np.float32), (8, 1))
state, loss = learned_fusion_train_step(state, opt, q, Y[:8], proj, corpus, tf, k=10)
assert torch.isfinite(loss)
try:
    type(config).load("{tmp_path / 'user.yaml'}")
    raise SystemExit("a YAML file loaded without pyyaml")
except ImportError as e:
    assert "pyyaml" in str(e)
assert not any(m == "jax" or m.startswith(("jax.", "yaml", "qpp_fusion_rag_tpu."))
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
