"""Port parity, evaluation/: IREvaluator on run dicts and on RunTensors
(aggregates within 1e-6 absolute, per-query values within rtol 1e-6),
evaluate_runtensor, per_query_metric and evaluate_multiple against JAX's;
the host modules copied from JAX (QA metrics, fact verification, fairness
with its seeded tie breakers, the benchmark tables, task typing) equal."""

import dataclasses

import numpy as np
import pytest

from qpp_fusion_rag_tpu.data.runtensor import RunTensor as JRunTensor
from qpp_fusion_rag_tpu.evaluation import base as JB
from qpp_fusion_rag_tpu.evaluation import benchmark as JBM
from qpp_fusion_rag_tpu.evaluation import fact_verification as JFV
from qpp_fusion_rag_tpu.evaluation import fairness as JFA
from qpp_fusion_rag_tpu.evaluation import ir_evaluator as JIR
from qpp_fusion_rag_tpu.evaluation import qa_evaluator as JQA
from qpp_fusion_rag_tpu_torch.data.runtensor import RunTensor as TRunTensor
from qpp_fusion_rag_tpu_torch.evaluation import base as TB
from qpp_fusion_rag_tpu_torch.evaluation import benchmark as TBM
from qpp_fusion_rag_tpu_torch.evaluation import fact_verification as TFV
from qpp_fusion_rag_tpu_torch.evaluation import fairness as TFA
from qpp_fusion_rag_tpu_torch.evaluation import ir_evaluator as TIR
from qpp_fusion_rag_tpu_torch.evaluation import qa_evaluator as TQA
from torch_offline_inputs import make_qrels, make_runs


def _close_dicts(got, want, per_query=False):
    assert list(got) == list(want)
    for name in want:
        if per_query:
            assert list(got[name]) == list(want[name]), name
            np.testing.assert_allclose([got[name][q] for q in want[name]],
                                       list(want[name].values()), rtol=1e-6, atol=0,
                                       err_msg=name)
        else:
            assert abs(got[name] - want[name]) <= 1e-6, name


@pytest.fixture(scope="module")
def runs_and_qrels():
    runs = make_runs(11, R=4, Q=48, K=40, integer=False)
    qids = sorted({q for run in runs.values() for q in run})
    qrels = make_qrels(12, qids)
    return runs, qrels


@pytest.mark.parametrize("metrics", [None, ["nDCG@10", "AP", "R@100", "nDCG@50"]])
def test_ir_evaluator_matches_jax(runs_and_qrels, metrics):
    runs, qrels = runs_and_qrels
    t, j = TIR.IREvaluator(metrics, device="cpu"), JIR.IREvaluator(metrics)
    assert t.metric_names == j.metric_names
    trt, jrt = TRunTensor.from_run_dicts(runs), JRunTensor.from_run_dicts(runs)
    for per_query in (False, True):
        for r in (0, 2, "ret3"):
            _close_dicts(t.evaluate(trt, qrels, per_query=per_query, retriever=r),
                         j.evaluate(jrt, qrels, per_query=per_query, retriever=r), per_query)
        # a run dict evaluates with its qids in plain lexicographic order
        run = jrt.to_run_dict(1)
        _close_dicts(t.evaluate(run, qrels, per_query=per_query),
                     j.evaluate(run, qrels, per_query=per_query), per_query)
    got, want = t.evaluate_runtensor(trt, qrels), j.evaluate_runtensor(jrt, qrels)
    assert list(got) == list(want)
    for name in want:
        _close_dicts(got[name], want[name])
    assert 0 < got["ret0"][t.metric_names[0]] < 1
    for mod in (TIR, JIR):
        with pytest.raises(ValueError):
            mod.IREvaluator(["nDCG@ten"])                 # validated eagerly


def test_run_dict_to_tensor_and_ideal_depth_match_jax(runs_and_qrels):
    runs, _ = runs_and_qrels
    run = JRunTensor.from_run_dicts(runs).to_run_dict(0)
    run["10"] = [("d1", 0.5)]
    run["9"] = []
    ti, tq, tv = TIR._run_dict_to_tensor(run)
    ji, jq, jv = JIR._run_dict_to_tensor(run)
    np.testing.assert_array_equal(ti, ji)
    assert tq == jq == sorted(run) and tv.docnos() == jv.docnos()
    for names, depth in ((["nDCG@10"], 5), (["nDCG@200", "AP", "x@y"], 30), (["AP"], 7)):
        assert TIR._ideal_depth(names, depth) == JIR._ideal_depth(names, depth)


@pytest.mark.parametrize("metric", ["nDCG@10", "RR@5", "R@100", "AP"])
def test_per_query_metric_matches_jax(runs_and_qrels, metric):
    runs, qrels = runs_and_qrels
    got = TIR.per_query_metric(TRunTensor.from_run_dicts(runs), qrels, metric, device="cpu")
    want = JIR.per_query_metric(JRunTensor.from_run_dicts(runs), qrels, metric)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape == (4, 48)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_evaluate_multiple_matches_jax(runs_and_qrels):
    pytest.importorskip("pandas")
    runs, qrels = runs_and_qrels
    jrt = JRunTensor.from_run_dicts(runs)
    t, j = TIR.IREvaluator(device="cpu"), JIR.IREvaluator()
    multi = {"dict": jrt.to_run_dict(0)}
    got = t.evaluate_multiple({**multi, "rt": TRunTensor.from_run_dicts(runs)}, qrels)
    want = j.evaluate_multiple({**multi, "rt": jrt}, qrels)
    assert list(got.index) == list(want.index) and list(got.columns) == list(want.columns)
    np.testing.assert_allclose(got.to_numpy(), want.to_numpy(), rtol=0, atol=1e-6)


def test_compute_ndcg_alias():
    assert TIR.compute_ndcg(["a", "b"], {"b": 1}, k=2) == JIR.compute_ndcg(["a", "b"], {"b": 1}, k=2)


PREDS = ["The Eiffel Tower!", "an apple a day", "", "Paris, France", "the the", "42"]
REFS = [["eiffel tower"], ["An apple", "pear"], ["x"], ["paris"], ["the"], [None, "42.0", "42"]]


def test_qa_metrics_equal_jax():
    for p, refs in zip(PREDS, REFS):
        str_refs = [r for r in refs if isinstance(r, str)]
        for fn in ("normalize_answer",):
            assert getattr(TQA, fn)(p) == getattr(JQA, fn)(p)
        for fn in ("exact_match", "token_f1", "rouge_l", "containment"):
            assert getattr(TQA, fn)(p, str_refs) == getattr(JQA, fn)(p, str_refs), fn
        assert TQA.QAEvaluator().evaluate_single(p, refs) == JQA.QAEvaluator().evaluate_single(p, refs)
    tq, jq = TQA.QAEvaluator(), JQA.QAEvaluator()
    batch = tq.evaluate_batch(PREDS, REFS)
    assert batch == jq.evaluate_batch(PREDS, REFS)
    assert tq.aggregate(batch) == jq.aggregate(batch) and tq.aggregate([]) == jq.aggregate([])
    assert TQA.compute_qa_metrics_batch(PREDS, REFS) == JQA.compute_qa_metrics_batch(PREDS, REFS)
    assert TQA._lcs_len("a b c d".split(), "b d".split()) == JQA._lcs_len("a b c d".split(), "b d".split()) == 2


def test_fact_verification_equals_jax():
    labels = ["supports", "REFUTES", "nei", "Not Enough Info", "maybe", "TRUE", "neutral"]
    for lab in labels:
        assert TB.FactVerificationGoldLabel.normalize_label(lab) == \
            JB.FactVerificationGoldLabel.normalize_label(lab)
    texts = ["Verdict: SUPPORTS\nbecause", "It does not support it", "refuted", "hmm",
             "NOT ENOUGH INFO here", "verdict: nothing\nsupported", "SUPPORT"]
    for text in texts:
        assert TFV.parse_verdict(text) == JFV.parse_verdict(text)
    out = {}
    for mods in ((TB, TFV), (JB, JFV)):
        base, fv = mods
        golds = {str(i): base.FactVerificationGoldLabel(str(i), lab, [f"d{i}", "d0"][: i % 3])
                 for i, lab in enumerate(["SUPPORT", "CONTRADICT", "NOT_ENOUGH_INFO", "SUPPORTS",
                                          "refutes", "SUPPORT"])}
        preds = [base.FactVerificationPrediction(str(i), lab, evidence_doc_ids=["d0", f"d{i}"][: i % 2 + 1])
                 for i, lab in enumerate(["supported", "SUPPORT", "nei", "garbage", "false",
                                          "SUPPORT", "x"])]
        out[base] = fv.FactVerificationEvaluator().evaluate(preds, golds)
    assert out[TB] == out[JB] and out[TB]["n_evaluated"] == 6


def test_fairness_and_tie_breakers_equal_jax(tmp_path):
    rng = np.random.default_rng(7)
    groups = rng.integers(-1, 4, (10, 12))
    groups[3] = -1
    for kw in ({}, {"k": 5}, {"target": np.array([0.4, 0.3, 0.2, 0.1])}, {"k": 40}):
        np.testing.assert_array_equal(TFA.awrf(groups, 4, **kw), JFA.awrf(groups, 4, **kw))
    rel = rng.integers(0, 2, 30)
    scores = np.round(rng.uniform(0, 1, 30), 1)              # many exact ties

    def metric(order):
        return float(rel[order][:10].mean())

    for cls, kw in ((TFA.NoTieBreaker, {}), (TFA.NoisePerturbationTieBreaker, {"delta": 0.05,
                                                                               "n_samples": 12,
                                                                               "seed": 3}),
                    (TFA.SampledPermAggrTieBreaker, {"n_samples": 9, "seed": 5})):
        jcls = getattr(JFA, cls.__name__)
        assert cls(**kw).evaluate(metric, scores) == jcls(**kw).evaluate(metric, scores)
        assert cls(**kw).evaluate(metric, np.arange(30.0)) == jcls(**kw).evaluate(metric, np.arange(30.0))
    path = tmp_path / "pre.tsv"
    path.write_text("qid\tnDCG\tawrf\n1\t0.5\t0.25\n2\tx\t1.0\n\n3,0.1,0.2\n")
    for delim in (None, "\t"):
        t, j = TFA.PreEvaluatedResults(path, delim), JFA.PreEvaluatedResults(path, delim)
        assert t.columns == j.columns and t.per_query == j.per_query
        assert t.query_ids() == j.query_ids()
        for q, m in (("1", "ndcg"), ("2", "NDCG"), ("9", "awrf"), ("2", "awrf")):
            assert t.compute(q, m) == j.compute(q, m)


def test_benchmark_tables_and_task_types_equal_jax():
    assert TBM.BEIR_BENCHMARK == JBM.BEIR_BENCHMARK
    assert TBM.RETRIEVER_CATEGORIES == JBM.RETRIEVER_CATEGORIES
    assert TBM.CLOSEST_PUBLISHED == JBM.CLOSEST_PUBLISHED
    for ds in ("nq", "scifact", "unknown"):
        assert TBM.published_for(ds) == JBM.published_for(ds)
        for r in ("bm25", "splade", "nope", None):
            assert TBM.published_for(ds, r) == JBM.published_for(ds, r)
    for ds in ("nq", "hotpotqa", "scifact", "nope"):
        assert TB.get_task_type(ds).value == JB.get_task_type(ds).value
    assert [m.value for m in TB.TaskType] == [m.value for m in JB.TaskType]
    for cls in ("QAGoldLabel", "QAPrediction", "FactVerificationGoldLabel",
                "FactVerificationPrediction"):
        assert [f.name for f in dataclasses.fields(getattr(TB, cls))] == \
            [f.name for f in dataclasses.fields(getattr(JB, cls))]
    assert TB.FactVerificationGoldLabel.LABEL_MAP == JB.FactVerificationGoldLabel.LABEL_MAP
