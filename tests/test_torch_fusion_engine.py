"""Port parity, the QPP stage and fusion: qpp/engine.py (compute_qpp with
and without query texts and for every normalization, the .res file and
directory stage, the RunTensor path with a fully padded row; QPP within
rtol 1e-5 atol 1e-6, the tolerance of tests/test_torch_qpp_fusion.py,
except RSD and snqc: on rows longer than 32 scores XLA's CPU backend sums
in an order the port does not reproduce, and RSD's cubed deviations cancel
(a raw RSD of 0.05 moved by 2e-6 on 69 scores), so those two columns hold
to the QPP tolerance of the ensemble step's tests, rtol 1e-4 atol 1e-5,
as do z-scores, which divide the mean's sum-order error by the spread),
fusion/engine.py's run_fusion for every method (ids equal outside
near-ties, consecutive scores within rtol 4e-6; scores within rtol 1e-6),
get_qpp_weight's errors, the oracle, argmax-QPP and ProbFuse against the
JAX package on the same seeded runs, qrels and QPP data."""

import numpy as np
import pytest

from qpp_fusion_rag_tpu.data import loaders as JL
from qpp_fusion_rag_tpu.data.runtensor import RunTensor as JRunTensor
from qpp_fusion_rag_tpu.fusion import argmax_qpp as JA
from qpp_fusion_rag_tpu.fusion import engine as JE
from qpp_fusion_rag_tpu.fusion import oracle as JO
from qpp_fusion_rag_tpu.fusion import probfuse as JP
from qpp_fusion_rag_tpu.models import gbdt as JG
from qpp_fusion_rag_tpu.qpp import engine as JQE
from qpp_fusion_rag_tpu_torch.data import loaders as TL
from qpp_fusion_rag_tpu_torch.data.runtensor import RunTensor as TRunTensor
from qpp_fusion_rag_tpu_torch.fusion import argmax_qpp as TA
from qpp_fusion_rag_tpu_torch.fusion import engine as TE
from qpp_fusion_rag_tpu_torch.fusion import oracle as TO
from qpp_fusion_rag_tpu_torch.fusion import probfuse as TP
from qpp_fusion_rag_tpu_torch.models import gbdt as TG
from qpp_fusion_rag_tpu_torch.qpp import engine as TQE
from torch_offline_inputs import make_qrels, make_runs, write_beir

QPP_TOL = dict(rtol=1e-5, atol=1e-6)
SUM_ORDER_TOL = dict(rtol=1e-4, atol=1e-5)     # RSD and snqc (module docstring)
SUM_ORDER_COLS = [5, 10]


def assert_qpp_close(got, want, atol=QPP_TOL["atol"]):
    """QPP arrays [..., 13]: QPP_TOL, RSD and snqc SUM_ORDER_TOL."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    other = np.setdiff1d(np.arange(13), SUM_ORDER_COLS)
    np.testing.assert_allclose(got[..., other], want[..., other], rtol=QPP_TOL["rtol"], atol=atol)
    np.testing.assert_allclose(got[..., SUM_ORDER_COLS], want[..., SUM_ORDER_COLS],
                               **SUM_ORDER_TOL)


TIE_RTOL = 4e-6
METHODS = ["combsum", "combmnz", "rrf", "wcombsum", "wcombmnz", "wrrf", "w-combsum"]


def assert_ids_equal_outside_near_ties(ti, ts, ji, js, rtol=TIE_RTOL):
    """Per row, JAX's scores split into groups of consecutive near-equal
    values; each group holds the same ids in both packages. The group that
    the row's end cuts may hold other ids of near-equal score."""
    ti, ts, ji, js = map(np.asarray, (ti, ts, ji, js))
    assert ti.shape == ji.shape
    for b in range(ji.shape[0]):
        n, i = ji.shape[1], 0
        while i < n:
            j = i + 1
            while j < n and np.isclose(js[b, j], js[b, j - 1], rtol=rtol, atol=0):
                j += 1
            if j < n or set(ti[b, i:j]) == set(ji[b, i:j]):
                assert set(ti[b, i:j]) == set(ji[b, i:j]), (b, i, j)
            else:
                assert np.allclose(ts[b, i:j], js[b, i], rtol=rtol, atol=0), (b, i)
            i = j


def assert_fused_close(t, j):
    assert t.qids == j.qids and t.retrievers == j.retrievers
    assert t.doc_ids.shape == j.doc_ids.shape
    np.testing.assert_allclose(t.scores, j.scores, rtol=1e-6, atol=0)
    assert_ids_equal_outside_near_ties(t.doc_ids[0], t.scores[0], j.doc_ids[0], j.scores[0])


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """Runs (a fully padded row included), qrels, their BEIR files, the
    runs as .res / .norm.res files and JAX's QPP of them as one dict."""
    root = tmp_path_factory.mktemp("offline")
    runs = make_runs(21, R=4, Q=40, K=30, integer=False)
    jrt = JRunTensor.from_run_dicts(runs)
    qrels = make_qrels(22, jrt.qids)
    write_beir(root, qrels, jrt.qids)
    for r, name in enumerate(jrt.retrievers):
        jrt.write_trec(r, root / "runs" / f"{name}.res")
        jrt.minmax_normalized().write_trec(r, root / "runs" / f"{name}.norm.res")
    qpp = JQE.compute_qpp_for_runtensor(jrt.minmax_normalized())
    qpp_data = JQE.qpp_tensor_to_dict(qpp, jrt.qids, jrt.retrievers)
    return dict(root=root, runs=runs, qrels=qrels, qpp_data=qpp_data,
                jrt=jrt.minmax_normalized(),
                trt=TRunTensor.from_run_dicts(runs).minmax_normalized())


# ------------------------------------------------------------ QPP stage ----

@pytest.mark.parametrize("normalize", ["minmax", "zscore", "none", None])
@pytest.mark.parametrize("texts", [False, True])
def test_compute_qpp_matches_jax(normalize, texts):
    rng = np.random.default_rng(3)
    scores = {f"test{i}": np.round(rng.uniform(0, 5, int(rng.integers(1, 70))), 3).tolist()
              for i in range(30)}
    scores["test4"] = [2.0] * 6                        # a constant row
    scores["test5"] = [1.5]
    query_texts = {q: f"a query {i} with w{i % 4}" for i, q in enumerate(scores)} if texts else None
    for kw in ({}, {"top_k": 20, "cutoff": 10}):
        got = TQE.compute_qpp(scores, query_texts, normalize=normalize, device="cpu", **kw)
        want = JQE.compute_qpp(scores, query_texts, normalize=normalize, **kw)
        assert list(got) == list(want)
        got, want = np.array(list(got.values())), np.array(list(want.values()))
        if normalize == "zscore":
            # a column constant over the queries (the text features of
            # same-shaped texts) z-scores to rounding noise: JAX's f32 mean
            # misses the constant by an ulp and its std is that ulp, so it
            # gives +-1; the port's std is 0 there, so it gives ~0
            raw = np.array(list(JQE.compute_qpp(scores, query_texts, normalize="none",
                                                **kw).values()))
            flat = np.ptp(raw, axis=0) == 0
            assert list(np.flatnonzero(flat)) == ([7] if texts else [])   # MaxIDF
            assert (np.abs(got[:, flat]) < 1e-5).all()
            got[:, flat] = want[:, flat] = 0
            # z-scores carry the f32 mean's sum-order error times |mean| / std
            np.testing.assert_allclose(got, want, **SUM_ORDER_TOL)
        else:
            assert_qpp_close(got, want)
    with pytest.raises(NotImplementedError, match="index_aware"):
        TQE.compute_qpp(scores, index=object(), device="cpu")


def test_qpp_stage_files_match_jax(case, tmp_path):
    root = case["root"]
    res = root / "runs" / "ret1.res"
    got = TQE.compute_qpp_for_res_file(res, tmp_path / "t.qpp", queries_path=root / "queries.jsonl",
                                       device="cpu")
    want = JQE.compute_qpp_for_res_file(res, tmp_path / "j.qpp", queries_path=root / "queries.jsonl")
    assert list(got) == list(want)
    assert_qpp_close(list(got.values()), list(want.values()))
    t_file, j_file = TL.load_qpp_file(tmp_path / "t.qpp"), JL.load_qpp_file(tmp_path / "j.qpp")
    assert list(t_file) == list(j_file)
    assert_qpp_close(list(t_file.values()), list(j_file.values()), atol=2e-6)   # + .6f rounding
    # the same QPP written by both writers: byte-equal
    TL.write_qpp_file(want, tmp_path / "tw.qpp")
    assert (tmp_path / "tw.qpp").read_bytes() == (tmp_path / "j.qpp").read_bytes()
    for mod, kw in ((TQE, {"device": "cpu"}), (JQE, {})):
        with pytest.raises(FileNotFoundError):
            mod.compute_qpp_for_res_file(root / "none.res", **kw)
        (tmp_path / "empty.res").write_text("\n")
        with pytest.raises(ValueError):
            mod.compute_qpp_for_res_file(tmp_path / "empty.res", **kw)


def test_compute_qpp_dir_matches_jax(case, tmp_path):
    runs_dir = case["root"] / "runs"
    qpath = case["root"] / "queries.jsonl"
    written = TQE.compute_qpp_dir(runs_dir, tmp_path / "t", qpath, device="cpu")
    jwritten = JQE.compute_qpp_dir(runs_dir, tmp_path / "j", qpath)
    assert [p.name for p in written] == [p.name for p in jwritten] == \
        [f"ret{r}.res.mmnorm.qpp" for r in range(4)]
    got, want = TL.load_qpp_scores(tmp_path / "t"), JL.load_qpp_scores(tmp_path / "j")
    assert list(got) == list(want)
    for q in want:
        assert list(got[q]) == list(want[q])
        assert_qpp_close(list(got[q].values()), list(want[q].values()), atol=2e-6)
    assert TQE.compute_qpp_dir(runs_dir, tmp_path / "t", qpath, device="cpu") == []
    again = TQE.compute_qpp_dir(runs_dir, tmp_path / "t", qpath, skip_existing=False, device="cpu")
    assert [p.name for p in again] == [p.name for p in written]


@pytest.mark.parametrize("normalize", ["minmax", "none"])
def test_compute_qpp_for_runtensor_matches_jax(case, normalize):
    texts = {q: f"text of {q}" for q in case["jrt"].qids[::2]}
    got = TQE.compute_qpp_for_runtensor(case["trt"], texts, normalize=normalize, device="cpu")
    want = JQE.compute_qpp_for_runtensor(case["jrt"], texts, normalize=normalize)
    assert got.dtype == np.float32 and got.shape == want.shape == (4, 40, 13)
    assert_qpp_close(got, want)
    if normalize == "none":
        assert (got[0, 3] == 0).all()                      # the fully padded row
    feats = np.ones((40, 4), np.float32)
    assert_qpp_close(
        TQE.compute_qpp_for_runtensor(case["trt"], cutoff=10, features=feats, device="cpu"),
        JQE.compute_qpp_for_runtensor(case["jrt"], cutoff=10, features=feats))
    d = TQE.qpp_tensor_to_dict(want, case["jrt"].qids, case["jrt"].retrievers)
    assert d == JQE.qpp_tensor_to_dict(want, case["jrt"].qids, case["jrt"].retrievers)


def test_qpp_self_test_runs(capsys):
    def printed():
        lines = capsys.readouterr().out.splitlines()
        assert lines[0] == "[qpp --test] 10-score fixed input:" and lines[-1] == "[qpp --test] OK"
        return [ln.split()[2] for ln in lines[1:-1]], [float(ln.split()[3]) for ln in lines[1:-1]]

    TQE._self_test(device="cpu")
    t_names, t_vals = printed()
    JQE._self_test()
    j_names, j_vals = printed()
    assert t_names == j_names and len(t_vals) == 13
    assert_qpp_close(t_vals, j_vals, atol=2e-6)                # + the .6f rounding


# --------------------------------------------------------------- fusion ----

class WeightModel:
    """A fixed weight model: softmax over each retriever's RSD column."""

    def predict(self, X):
        z = np.asarray(X, np.float32)[:, 5::13] * 3.0
        e = np.exp(z - z.max(axis=1, keepdims=True))
        return (e / e.sum(axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("method", METHODS + ["learned"])
def test_run_fusion_matches_jax(case, method, tmp_path):
    qpp = case["qpp_data"]
    kw = dict(model=WeightModel()) if method == "learned" else {}
    for k_out in (None, 25):
        got = TE.run_fusion(method, case["trt"], qpp, k_out=k_out, device="cpu",
                            output_path=tmp_path / "t.res", **kw)
        want = JE.run_fusion(method, case["jrt"], qpp, k_out=k_out,
                             output_path=tmp_path / "j.res", **kw)
        assert_fused_close(got, want)
        assert got.K == (k_out or 120)                     # R * K = 120 < 512
        t_run, j_run = TL.load_run_file(tmp_path / "t.res"), JL.load_run_file(tmp_path / "j.res")
        assert list(t_run) == list(j_run)
        assert (tmp_path / "t.res").read_text().split("\n")[0].split()[-1] == \
            (tmp_path / "j.res").read_text().split("\n")[0].split()[-1]       # the tag
    if method != "learned":
        # from the runs directory, and with the reference's QPP layout
        got = TE.run_fusion(method, str(case["root"] / "runs"), qpp, qpp_model="NQC",
                            qpp_layout="reference", device="cpu")
        want = JE.run_fusion(method, str(case["root"] / "runs"), qpp, qpp_model="NQC",
                             qpp_layout="reference")
        assert_fused_close(got, want)


def test_run_fusion_edges_match_jax(case, tmp_path):
    qpp = {q: {r: list(v) for r, v in row.items()} for q, row in case["qpp_data"].items()}
    for r in qpp["test7"]:                          # a dead RSD column for one query
        qpp["test7"][r][5] = 0.0
    for method in ("wcombsum", "wrrf"):
        assert_fused_close(TE.run_fusion(method, case["trt"], qpp, device="cpu"),
                           JE.run_fusion(method, case["jrt"], qpp))
    W = TE.weights_from_qpp(qpp, case["jrt"].qids, case["jrt"].retrievers, 5)
    np.testing.assert_array_equal(W, JE.weights_from_qpp(qpp, case["jrt"].qids,
                                                         case["jrt"].retrievers, 5))
    assert (W[:, 7] == 0.25).all()
    np.testing.assert_array_equal(
        TE.weights_from_qpp(qpp, case["jrt"].qids, case["jrt"].retrievers, -1),
        JE.weights_from_qpp(qpp, case["jrt"].qids, case["jrt"].retrievers, -1))
    # learned with a query missing from qpp_data: uniform weights there
    del qpp["test9"]
    assert_fused_close(TE.run_fusion("learned", case["trt"], qpp, model=WeightModel(), device="cpu"),
                       JE.run_fusion("learned", case["jrt"], qpp, model=WeightModel()))
    # a deep run: an explicit k_out above max_candidates (512) is kept
    runs = make_runs(23, R=4, Q=6, K=140, n_docs=900, integer=False)
    t, j = TRunTensor.from_run_dicts(runs), JRunTensor.from_run_dicts(runs)
    for method, k_out in (("combsum", 540), ("rrf", 540), ("combmnz", None), ("rrf", 900)):
        got = TE.run_fusion(method, t, k_out=k_out, device="cpu")
        assert got.K == min(k_out or 512, 560)
        assert_fused_close(got, JE.run_fusion(method, j, k_out=k_out))
    for mod, rt, kw in ((TE, t, {"device": "cpu"}), (JE, j, {})):
        with pytest.raises(ValueError, match="qpp data required"):
            mod.run_fusion("wrrf", rt, **kw)
        with pytest.raises(ValueError, match="Unknown method"):
            mod.run_fusion("borda", rt, **kw)
        with pytest.raises(ValueError, match="model_path"):
            mod.run_fusion("learned", rt, qpp, **kw)


def test_get_qpp_weight_matches_jax(case):
    qpp = case["qpp_data"]
    for args in (("test1", "ret2", qpp, 5), ("test1", "ret2", qpp, None),
                 ("test1", "ret2", qpp, 0, True), ("test1", "ret0", qpp, -1)):
        assert TE.get_qpp_weight(*args) == JE.get_qpp_weight(*args)
    for args, err in ((("nope", "ret0", qpp), KeyError), (("test1", "nope", qpp), KeyError),
                      (("test1", "ret0", qpp, 13), IndexError)):
        for mod in (TE, JE):
            with pytest.raises(err) as e:
                mod.get_qpp_weight(*args)
            assert "missing" in str(e.value) or "out of range" in str(e.value)


def test_learned_fusion_from_a_saved_model_matches_jax(case, tmp_path):
    """run_fusion("learned", model_path=...) loads a pickle each package
    wrote (a small PerRetrieverGBDT trained on the same data)."""
    X = np.random.default_rng(5).uniform(0, 1, (60, 4 * 13)).astype(np.float32)
    Y = np.random.default_rng(6).dirichlet(np.ones(4), 60).astype(np.float32)
    params = {"num_boost_round": 15, "min_data_in_leaf": 5}
    tm = TG.PerRetrieverGBDT(case["trt"].retrievers, params=params, seed=0, device="cpu")
    jm = JG.PerRetrieverGBDT(case["jrt"].retrievers, params=params, seed=0)
    tm.train(X, Y)
    jm.train(X, Y)
    tm.save(tmp_path / "t.pkl")
    jm.save(tmp_path / "j.pkl")
    got = TE.run_fusion("learned", case["trt"], case["qpp_data"], model_path=str(tmp_path / "t.pkl"),
                        k_out=40, device="cpu")
    want = JE.run_fusion("learned", case["jrt"], case["qpp_data"], model_path=str(tmp_path / "j.pkl"),
                         k_out=40)
    np.testing.assert_allclose(got.scores, want.scores, rtol=1e-5, atol=1e-6)
    assert_ids_equal_outside_near_ties(got.doc_ids[0], got.scores[0], want.doc_ids[0],
                                       want.scores[0], rtol=2e-5)


# ------------------------------------------------- oracle, argmax, ProbFuse ----

def test_oracle_report_matches_jax(case):
    trt, jrt, qrels = case["trt"], case["jrt"], case["qrels"]
    for metric, extra in (("nDCG@10", None), ("AP", ["AP", "P@10"])):
        got = TO.oracle_report(trt, qrels, metric, extra, device="cpu")
        want = JO.oracle_report(jrt, qrels, metric, extra)
        for key in ("metric", "selection_histogram"):
            assert got[key] == want[key]
        for key in ("oracle_metric", "best_single", "headroom"):
            assert abs(got[key] - want[key]) <= 1e-6, key
        for d in ("oracle", "per_retriever"):
            assert list(got[d]) == list(want[d])
            assert all(abs(got[d][m] - want[d][m]) <= 1e-6 for m in want[d]), d
        sel = TO.oracle_selection(trt, qrels, metric, device="cpu")
        q = sel["per_query"]
        top2 = np.sort(q, axis=0)[-2:]
        clear = top2[1] - top2[0] > 1e-6
        np.testing.assert_array_equal(sel["selection"][clear], want["selection"][clear])
        assert clear.sum() > 10
    run = TO.oracle_run(trt, np.arange(trt.Q) % trt.R, name="o")
    jrun = JO.oracle_run(jrt, np.arange(jrt.Q) % jrt.R, name="o")
    np.testing.assert_array_equal(run.doc_ids, jrun.doc_ids)
    assert run.retrievers == ["o"]


def test_argmax_qpp_experiment_matches_jax(case):
    trt, jrt, qrels, qpp = case["trt"], case["jrt"], case["qrels"], case["qpp_data"]
    assert TA.qpp_index_names() == JA.qpp_index_names()
    for indices in (None, [5, 0]):
        got = TA.argmax_qpp_experiment(trt, qpp, qrels, indices, "nDCG@10", device="cpu")
        want = JA.argmax_qpp_experiment(jrt, qpp, qrels, indices, "nDCG@10")
        assert list(got) == list(want)
        for name in want:
            assert got[name]["histogram"] == want[name]["histogram"]
            assert got[name]["qpp_index"] == want[name]["qpp_index"]
            assert abs(got[name]["nDCG@10"] - want[name]["nDCG@10"]) <= 1e-6
    a, b = TA.argmax_qpp_run(trt, qpp, 5), JA.argmax_qpp_run(jrt, qpp, 5)
    np.testing.assert_array_equal(a.doc_ids, b.doc_ids)
    assert a.retrievers == b.retrievers == ["argmax_qpp_5"]


@pytest.mark.parametrize("variant", ["judged", "all"])
def test_probfuse_matches_jax(case, variant):
    trt, jrt, qrels = case["trt"], case["jrt"], case["qrels"]
    for K, x in ((30, 7), (25, 5), (10, 3), (7, 25)):
        np.testing.assert_array_equal(TP._segment_index(K, x), JP._segment_index(K, x))
    train, test = jrt.qids[:28], jrt.qids[28:]
    for x, depth in ((7, 30), (4, 25)):             # K = 30: not a multiple of 7 or 4
        tp, jp = TP.ProbFuse(x, depth, variant), JP.ProbFuse(x, depth, variant)
        tprobs = tp.train(trt.select_queries(train), qrels)
        jprobs = jp.train(jrt.select_queries(train), qrels)
        assert list(tprobs) == list(jprobs)
        for r in jprobs:
            np.testing.assert_array_equal(tprobs[r], jprobs[r])
        assert_fused_close(tp.fuse(trt.select_queries(test), k_out=50, device="cpu"),
                           jp.fuse(jrt.select_queries(test), k_out=50))
        got = TP.probfuse_experiment(trt, qrels, train, test, x, depth, variant, device="cpu")
        want = JP.probfuse_experiment(jrt, qrels, train, test, x, depth, variant)
        assert got["probs"] == want["probs"]
        assert abs(got["nDCG@10"] - want["nDCG@10"]) <= 1e-6
        assert_fused_close(got["fused"], want["fused"])
    with pytest.raises(RuntimeError):
        TP.ProbFuse().fuse(trt, device="cpu")
