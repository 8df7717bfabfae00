"""Port parity, back half: the 13 QPP statistics, their normalization and
the fusion kernel against the JAX package and against the committed golden
fixture tests/golden/kernels_v1.json."""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qpp_fusion_rag_tpu.ops import fusion as JF
from qpp_fusion_rag_tpu.ops import qpp as JQ
from qpp_fusion_rag_tpu_torch.ops import fusion as TF
from qpp_fusion_rag_tpu_torch.ops import qpp as TQ
from qpp_fusion_rag_tpu_torch.pipeline import engine as TE

GOLDEN = json.loads((Path(__file__).parent / "golden" / "kernels_v1.json").read_text())
GOLDEN_SCORES = {
    "q1": [0.95, 0.87, 0.82, 0.76, 0.71, 0.65, 0.58, 0.52, 0.47, 0.41],
    "q2": [3.2, 1.1, 0.9, 0.85, 0.8],
    "q3": [1.0, 1.0, 1.0, 1.0],
}
GOLDEN_TEXTS = {"q1": "sample test query", "q2": "alpha beta", "q3": "x"}
QPP_TOL = dict(rtol=1e-5, atol=1e-6)
FUSE_TOL = dict(rtol=1e-5, atol=1e-5)


def _golden_qpp_inputs():
    qids = ["q1", "q2", "q3"]
    K = max(len(v) for v in GOLDEN_SCORES.values())
    mat = np.zeros((3, K), np.float32)
    n_valid = np.zeros(3, np.int32)
    for i, q in enumerate(qids):
        r = sorted(GOLDEN_SCORES[q], reverse=True)
        mat[i, :len(r)] = r
        n_valid[i] = len(r)
    feats = JQ.text_features_batch([GOLDEN_TEXTS[q] for q in qids])
    return qids, mat, n_valid, feats


def _runs(seed, R=5, B=24, K=32):
    """Desc-sorted runs with tied scores, short rows (0..3 valid) and
    padding; ids drawn from a small pool so docs repeat across runs."""
    rng = np.random.default_rng(seed)
    vals = np.sort(rng.integers(0, 30, (R, B, K)).astype(np.float32)
                   * np.float32(0.37), axis=-1)[..., ::-1].copy()
    n_valid = rng.integers(4, K + 1, (R, B))
    n_valid[0, :4] = [0, 1, 2, 3]
    ids = np.stack([np.stack([rng.permutation(80)[:K] for _ in range(B)])
                    for _ in range(R)]).astype(np.int32)
    pad = np.arange(K) >= n_valid[..., None]
    ids[pad] = -1
    vals[pad] = -np.inf
    tf = np.column_stack([rng.integers(1, 9, B), rng.integers(1, 9, B),
                          rng.integers(1, 12, B), rng.uniform(1, 8, B)]).astype(np.float32)
    return vals, ids, n_valid.astype(np.int32), tf


@pytest.mark.parametrize("cutoff", [50, 10])
def test_qpp_kernel_matches_jax(cutoff):
    vals, ids, n_valid, tf = _runs(0)
    clean = np.where(ids >= 0, vals, 0.0).astype(np.float32)
    for r in range(vals.shape[0]):
        want = np.asarray(JQ.qpp_kernel(clean[r], n_valid[r], tf, cutoff=cutoff))
        got = TQ.qpp_kernel(torch.as_tensor(clean[r]), torch.as_tensor(n_valid[r]),
                            torch.as_tensor(tf), cutoff=cutoff).numpy()
        np.testing.assert_allclose(got, want, **QPP_TOL)
    # the batched [R, B, K] form equals the per-retriever calls
    batched = TQ.qpp_kernel(torch.as_tensor(clean), torch.as_tensor(n_valid),
                            torch.as_tensor(tf), cutoff=cutoff).numpy()
    for r in range(vals.shape[0]):
        np.testing.assert_array_equal(
            batched[r], TQ.qpp_kernel(torch.as_tensor(clean[r]), torch.as_tensor(n_valid[r]),
                                      torch.as_tensor(tf), cutoff=cutoff).numpy())


def test_qpp_kernel_golden():
    qids, mat, n_valid, feats = _golden_qpp_inputs()
    raw = TQ.qpp_kernel(torch.as_tensor(mat), torch.as_tensor(n_valid),
                        torch.as_tensor(feats)).numpy()
    for i, q in enumerate(qids):
        np.testing.assert_allclose(raw[i], GOLDEN["qpp_raw"][q], **QPP_TOL)
    # golden min-max: no column is degenerate over these 3 queries, so the
    # serving normalization (degenerate -> 0.5) coincides with the fixture's
    assert (raw.max(0) > raw.min(0)).all()
    norm = TQ.normalize_qpp_with(torch.as_tensor(raw)[None]).numpy()[0]
    for i, q in enumerate(qids):
        np.testing.assert_allclose(norm[i], GOLDEN["qpp_minmax"][q], **QPP_TOL)


def test_qpp_from_runs_and_normalization_match_jax():
    from qpp_fusion_rag_tpu.pipeline.engine import qpp_from_runs as j_qpp_from_runs

    vals, ids, _, tf = _runs(1)
    args = (vals, ids, tf)
    j_raw = np.array(j_qpp_from_runs(*map(jnp.asarray, args), normalize=False))
    t_raw = TE.qpp_from_runs(*map(torch.as_tensor, args), normalize=False)
    np.testing.assert_allclose(t_raw.numpy(), j_raw, **QPP_TOL)
    # in-batch min-max, frozen calibration stats, and the stats themselves,
    # each on the same raw input
    stats = TQ.qpp_calibration_stats(torch.as_tensor(j_raw))
    np.testing.assert_array_equal(stats.numpy(),
                                  np.asarray(JQ.qpp_calibration_stats(jnp.asarray(j_raw))))
    np.testing.assert_allclose(
        TQ.normalize_qpp_with(torch.as_tensor(j_raw)).numpy(),
        np.asarray(JQ.normalize_qpp_with(jnp.asarray(j_raw), None)), **QPP_TOL)
    half = torch.as_tensor(j_raw[:, :12])
    np.testing.assert_allclose(
        TQ.normalize_qpp_with(torch.as_tensor(j_raw), TQ.qpp_calibration_stats(half)).numpy(),
        np.asarray(JQ.normalize_qpp_with(jnp.asarray(j_raw),
                                         JQ.qpp_calibration_stats(jnp.asarray(j_raw[:, :12])))),
        **QPP_TOL)
    # degenerate columns get 0.5 in both
    flat = np.ones((2, 3, 13), np.float32)
    np.testing.assert_array_equal(TQ.normalize_qpp_with(torch.as_tensor(flat)).numpy(), 0.5)


@pytest.mark.parametrize("method", [TF.COMBSUM, TF.COMBMNZ, TF.RRF])
@pytest.mark.parametrize("minmax_norm", [True, False])
def test_fuse_kernel_matches_jax(method, minmax_norm):
    vals, ids, _, _ = _runs(2)
    rng = np.random.default_rng(3)
    w = rng.uniform(0.1, 1.0, ids.shape[:2]).astype(np.float32)
    ji, js = map(np.asarray, JF.fuse_kernel(
        jnp.asarray(ids), jnp.asarray(vals), jnp.asarray(w), method=method,
        minmax_norm=minmax_norm, k_out=40))
    ti, ts = TF.fuse_kernel(torch.as_tensor(ids), torch.as_tensor(vals),
                            torch.as_tensor(w), method=method,
                            minmax_norm=minmax_norm, k_out=40)
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_allclose(ts.numpy(), js, **FUSE_TOL)


@pytest.mark.parametrize("method", ["combsum", "combmnz", "rrf", "wcombsum"])
def test_fuse_kernel_golden(method):
    ids = np.array([[[1, 2, 3], [4, 5, -1]], [[2, 3, 6], [5, 7, -1]]], np.int32)
    sc = np.array([[[0.9, 0.5, 0.1], [1.0, 0.2, -np.inf]],
                   [[0.8, 0.6, 0.3], [0.7, 0.4, -np.inf]]], np.float32)
    if method == "wcombsum":
        w = np.array([[0.9, 0.2], [0.1, 0.8]], np.float32)
        code, minmax = TF.COMBSUM, False
    else:
        w = np.ones(ids.shape[:2], np.float32)
        code = {"combsum": TF.COMBSUM, "combmnz": TF.COMBMNZ, "rrf": TF.RRF}[method]
        minmax = True
    fi, fs = TF.fuse_kernel(torch.as_tensor(ids), torch.as_tensor(sc),
                            torch.as_tensor(w), method=code, minmax_norm=minmax, k_out=4)
    expected = GOLDEN["fusion"][method]
    np.testing.assert_array_equal(fi.numpy(), expected["ids"])
    got = np.where(np.isfinite(fs.numpy()), fs.numpy(), -1e30)
    np.testing.assert_allclose(got, expected["scores"], **FUSE_TOL)


def test_row_minmax_matches_jax():
    vals, ids, _, _ = _runs(4)
    for fill in (0.0, -np.inf):
        want = np.asarray(jax.jit(JF._row_minmax, static_argnames="fill")(
            jnp.asarray(vals), jnp.asarray(ids >= 0), fill=fill))
        got = TF._row_minmax(torch.as_tensor(vals), torch.as_tensor(ids >= 0), fill=fill)
        np.testing.assert_allclose(got.numpy(), want, **FUSE_TOL)
