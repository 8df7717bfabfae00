"""Port parity, signatures: the port's public functions take the JAX
functions' parameters by the same names and in the same order (the port's
own extras after them), and the calls the JAX package's callers make run on
the port and agree with JAX: bit for bit on integer paths, pools and the
dense kernels' integer-valued inputs, within rtol 4e-6 on the rescore's f32
sums. The ensemble step's sparse_mode defaults to JAX's "sort", and refuses
the presorted layout as JAX does. The dense kernel entry points take JAX's
n_real = 0 as "every doc is real". The index layer and the retrievers take
JAX's parameters and at most a `device` after them."""

import importlib
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qpp_fusion_rag_tpu import retrievers as JRG
from qpp_fusion_rag_tpu import ops as JOPS
from qpp_fusion_rag_tpu.data import loaders as JL
from qpp_fusion_rag_tpu.data import synthetic as JSYN
from qpp_fusion_rag_tpu.data.synthetic import zipf_bm25_csr, zipf_queries
from qpp_fusion_rag_tpu.encoders import heads as JH
from qpp_fusion_rag_tpu.index import autotune as JA
from qpp_fusion_rag_tpu.index import engines as JEN
from qpp_fusion_rag_tpu.index import native as JN
from qpp_fusion_rag_tpu.index import sparse as JIX
from qpp_fusion_rag_tpu.models import base as JMB
from qpp_fusion_rag_tpu.models import gbdt as JMG
from qpp_fusion_rag_tpu.models import interop as JMI
from qpp_fusion_rag_tpu.models import mlp as JMM
from qpp_fusion_rag_tpu.ops import dense as JD
from qpp_fusion_rag_tpu.ops import fusion as JF
from qpp_fusion_rag_tpu.ops import qpp as JQ
from qpp_fusion_rag_tpu.ops import segment as JSEG
from qpp_fusion_rag_tpu.ops import sparse as JSP
from qpp_fusion_rag_tpu.ops import trees as JT
from qpp_fusion_rag_tpu.ops.pallas import dense_topk as JK
from qpp_fusion_rag_tpu.ops.pallas import streaming_topk as JS
from qpp_fusion_rag_tpu.pipeline import engine as JENG
from qpp_fusion_rag_tpu.pipeline import ensemble as JE
from qpp_fusion_rag_tpu.retrievers import base as JBASE
from qpp_fusion_rag_tpu.retrievers import bm25 as JBM
from qpp_fusion_rag_tpu.retrievers import dense as JR
from qpp_fusion_rag_tpu.retrievers import splade as JSPL
from qpp_fusion_rag_tpu.retrievers import two_stage as JTS
from qpp_fusion_rag_tpu_torch import config as TC
from qpp_fusion_rag_tpu_torch import ops as TOPS
from qpp_fusion_rag_tpu_torch import retrievers as TRG
from qpp_fusion_rag_tpu_torch.data import loaders as TL
from qpp_fusion_rag_tpu_torch.data import synthetic as TSYN
from qpp_fusion_rag_tpu_torch.index import autotune as TA
from qpp_fusion_rag_tpu_torch.index import engines as TEN
from qpp_fusion_rag_tpu_torch.index import native as TN
from qpp_fusion_rag_tpu_torch.index import sparse as TIX
from qpp_fusion_rag_tpu_torch.models import base as TMB
from qpp_fusion_rag_tpu_torch.models import gbdt as TMG
from qpp_fusion_rag_tpu_torch.models import interop as TMI
from qpp_fusion_rag_tpu_torch.models import mlp as TMM
from qpp_fusion_rag_tpu_torch.ops import dense as TD
from qpp_fusion_rag_tpu_torch.ops import fusion as TF
from qpp_fusion_rag_tpu_torch.ops import qpp as TQ
from qpp_fusion_rag_tpu_torch.ops import segment as TSEG
from qpp_fusion_rag_tpu_torch.ops import sparse as TSP
from qpp_fusion_rag_tpu_torch.ops import trees as TT
from qpp_fusion_rag_tpu_torch.ops.kernels import dense_topk as TK
from qpp_fusion_rag_tpu_torch.ops.kernels import streaming_topk as TS
from qpp_fusion_rag_tpu_torch.pipeline import engine as TENG
from qpp_fusion_rag_tpu_torch.pipeline import ensemble as TE
from qpp_fusion_rag_tpu_torch.retrievers import base as TBASE
from qpp_fusion_rag_tpu_torch.retrievers import bm25 as TBM
from qpp_fusion_rag_tpu_torch.retrievers import dense as TR
from qpp_fusion_rag_tpu_torch.retrievers import splade as TSPL
from qpp_fusion_rag_tpu_torch.retrievers import two_stage as TTS

JC = importlib.import_module("qpp_fusion_rag_tpu.config")


# The parameters the port names otherwise. Its int8 entry points take the
# corpus as int8 ROWS [N, D], corpus_rows, where JAX takes a [D, N] copy,
# corpus_int: one row-major layout serves the kernels and the rerank gather
# (ops/kernels/dense_topk.py), so the port keeps no second copy. So the float
# rows that JAX's dense_view_rescored calls corpus_rows are the port's
# rerank_rows. The map applies once per name: JAX's corpus_int becomes
# corpus_rows, and JAX's corpus_rows becomes rerank_rows, so a JAX keyword
# call of either fails loudly in the port.
PORT_NAME = {"corpus_int": "corpus_rows", "corpus_rows": "rerank_rows"}
# The one default the port spells otherwise: init_mlp_params' dtype.
PORT_DEFAULT = {jnp.float32: torch.float32}


def _names(fn):
    return list(inspect.signature(fn).parameters)


def _pairs(module, names):
    """(JAX function, port function) for each dotted name of `module`."""
    from operator import attrgetter

    j = importlib.import_module(f"qpp_fusion_rag_tpu.{module}")
    t = importlib.import_module(f"qpp_fusion_rag_tpu_torch.{module}")
    return [(attrgetter(n)(j), attrgetter(n)(t)) for n in names]


# The offline research path: the data layer, the IR metrics, evaluation,
# the QPP stage, fusion and the trainer. The port adds at most `device`.
OFFLINE_PATH = (
    _pairs("data.vocab", ["DocVocab.__init__", "DocVocab.add", "DocVocab.encode",
                          "DocVocab.decode", "DocVocab.id_of", "DocVocab.docno_of",
                          "DocVocab.docnos", "DocVocab.save", "DocVocab.load"])
    + _pairs("data.loaders", [
        "LazyCorpus.__init__", "LazyCorpus.doc_ids", "LazyCorpus.get", "LazyCorpus.get_text",
        "LazyCorpus.get_many", "load_corpus", "iter_corpus", "load_queries", "load_qrels",
        "load_run_file", "load_run_pairs", "load_run_as_dict", "load_qpp_file",
        "load_qpp_scores", "write_qpp_file", "load_gold_answers", "get_gold_answer_for_query"])
    + _pairs("data.runtensor", [
        "RunTensor.from_run_dicts", "RunTensor.from_trec_dir", "RunTensor.from_arrays",
        "RunTensor.minmax_normalized", "RunTensor.select_retrievers",
        "RunTensor.select_queries", "RunTensor.truncate", "RunTensor.to_run_dict",
        "RunTensor.write_trec", "load_runs_dir"])
    + _pairs("ops.metrics", [
        "align_relevance", "_discounts", "ndcg_at", "rr_at", "recall_at", "precision_at",
        "average_precision", "parse_measure", "compute_measures", "aggregate_measures",
        "compute_ndcg"])
    + _pairs("evaluation.ir_evaluator", [
        "_run_dict_to_tensor", "IREvaluator.__init__", "IREvaluator.evaluate",
        "IREvaluator.evaluate_multiple", "IREvaluator.evaluate_runtensor", "_ideal_depth",
        "per_query_metric"])
    + _pairs("evaluation.base", ["get_task_type", "FactVerificationGoldLabel.normalize_label"])
    + _pairs("evaluation.qa_evaluator", [
        "normalize_answer", "exact_match", "token_f1", "_lcs_len", "rouge_l", "containment",
        "QAEvaluator.evaluate_single", "QAEvaluator.evaluate_batch", "QAEvaluator.aggregate",
        "compute_qa_metrics_batch"])
    + _pairs("evaluation.fact_verification", ["FactVerificationEvaluator.evaluate",
                                              "parse_verdict"])
    + _pairs("evaluation.fairness", [
        "awrf", "NoTieBreaker.evaluate", "NoisePerturbationTieBreaker.__init__",
        "NoisePerturbationTieBreaker.evaluate", "SampledPermAggrTieBreaker.__init__",
        "SampledPermAggrTieBreaker.evaluate", "PreEvaluatedResults.__init__",
        "PreEvaluatedResults.compute"])
    + _pairs("evaluation.benchmark", ["published_for"])
    + _pairs("qpp.engine", ["compute_qpp", "compute_qpp_for_res_file",
                            "compute_qpp_for_runtensor", "qpp_tensor_to_dict",
                            "compute_qpp_dir", "_self_test"])
    + _pairs("fusion.engine", [
        "get_qpp_weight", "weights_from_qpp", "_fused_to_runtensor", "_k_out", "combsum",
        "combmnz", "rrf", "weighted_combsum", "weighted_combmnz", "weighted_rrf",
        "learned_fusion", "run_fusion"])
    + _pairs("fusion.oracle", ["oracle_selection", "oracle_run", "oracle_report"])
    + _pairs("fusion.probfuse", ["_segment_index", "ProbFuse.__init__", "ProbFuse.train",
                                 "ProbFuse.fuse", "probfuse_experiment"])
    + _pairs("fusion.argmax_qpp", ["qpp_index_names", "argmax_qpp_run",
                                   "argmax_qpp_experiment"])
    + _pairs("train.fusion_trainer", ["build_training_data", "evaluate_weights",
                                      "train_fusion_models"])
)


@pytest.mark.parametrize("jax_fn,port_fn", [
    (JD.dense_topk, TD.dense_topk),
    (JD.multi_view_topk, TD.multi_view_topk),
    (JR.DenseIndex.search, TR.DenseIndex.search),
    (JR.DenseRetriever.__init__, TR.DenseRetriever.__init__),
    (JSP.sparse_score_topk_q8, TSP.sparse_score_topk_q8),
    (JSP.sparse_score_topk_q8_rescored, TSP.sparse_score_topk_q8_rescored),
    (JSP.sparse_exact_rescore, TSP.sparse_exact_rescore),
    (JSP._exact_rescore_scores, TSP._exact_rescore_scores),
    (JSP._exact_rescore_scores_f32, TSP._exact_rescore_scores_f32),
    (JSP.sparse_score_topk_q8_certified, TSP.sparse_score_topk_q8_certified),
    (JSP.pack_doc_vectors_exact, TSP.pack_doc_vectors_exact),
    (JSP.sparse_score_topk, TSP.sparse_score_topk),
    (JSP.sparse_score_topk_packed, TSP.sparse_score_topk_packed),
    (JSP.sparse_rescore_topk, TSP.sparse_rescore_topk),
    (JSP.sparse_rescore_topk_packed, TSP.sparse_rescore_topk_packed),
    (JSP._rescore_pool, TSP._rescore_pool),
    (JSP._gather_windows, TSP._gather_windows),
    (JE.make_sparse_scorer, TE.make_sparse_scorer),
    (JK.group_max_packed_int8, TK.group_max_packed_int8),
    (JK.group_max_packed, TK.group_max_packed),
    (JK.group_max_scores, TK.group_max_scores),
    (JK.group_max_packed_int8_global, TK.group_max_packed_int8_global),
    (JK.pallas_dense_topk, TK.pallas_dense_topk),
    (JK.pallas_dense_topk_int8, TK.pallas_dense_topk_int8),
    (JK.pallas_dense_topk_int8_global, TK.pallas_dense_topk_int8_global),
    (JK.pallas_multi_view_topk, TK.pallas_multi_view_topk),
    (JK.pallas_multi_view_topk_int8, TK.pallas_multi_view_topk_int8),
    (JS._streaming_group_max, TS.streaming_group_max),
    (JS.streaming_dense_topk, TS.streaming_dense_topk),
    (JSEG.segmented_topk, TSEG.segmented_topk),
    (JSEG.segmented_topk_presorted, TSEG.segmented_topk_presorted),
    (JSEG.segmented_sums_presorted, TSEG.segmented_sums_presorted),
    (JE.dense_view_topk, TE.dense_view_topk),
    (JE.dense_view_rescored, TE.dense_view_rescored),
    (JQ.text_features, TQ.text_features),
    (JQ.text_features_batch, TQ.text_features_batch),
    (JQ.normalize_qpp, TQ.normalize_qpp),
    (JF.fuse, TF.fuse),
    (JSYN.exact_sparse_scores_host, TSYN.exact_sparse_scores_host),
    (JC._expand, TC._expand),
    (JC._expand_tree, TC._expand_tree),
    (JC._deep_merge, TC._deep_merge),
    (JC.detect_dataset, TC.detect_dataset),
    (JC.ConfigDict.__init__, TC.ConfigDict.__init__),
    (JC.ConfigDict.get, TC.ConfigDict.get),
    (JC.ConfigDict.to_dict, TC.ConfigDict.to_dict),
    (JC.Config.__init__, TC.Config.__init__),
    (JC.Config.load, TC.Config.load),
    (JC.Config.get_qpp_index, TC.Config.get_qpp_index),
    (JC.Config.dataset, TC.Config.dataset),
    (JT._traverse, TT._traverse),
    (JT.predict_ensemble, TT.predict_ensemble),
    (JT.stack_trees, TT.stack_trees),
    (JMB.BaseFusionModel.__init__, TMB.BaseFusionModel.__init__),
    (JMB.BaseFusionModel.train, TMB.BaseFusionModel.train),
    (JMB.BaseFusionModel.predict, TMB.BaseFusionModel.predict),
    (JMB.BaseFusionModel.predict_single, TMB.BaseFusionModel.predict_single),
    (JMB.BaseFusionModel.save, TMB.BaseFusionModel.save),
    (JMB.BaseFusionModel.load, TMB.BaseFusionModel.load),
    (JMB.BaseFusionModel._normalize_weights, TMB.BaseFusionModel._normalize_weights),
    (JMB.load_model, TMB.load_model),
    (JMB.build_features, TMB.build_features),
    (JMB.compute_targets, TMB.compute_targets),
    (JMM.init_mlp_params, TMM.init_mlp_params),
    (JMM.mlp_apply, TMM.mlp_apply),
    (JMM.soft_cross_entropy, TMM.soft_cross_entropy),
    (JMM.FusionMLP.__init__, TMM.FusionMLP.__init__),
    (JMM.FusionMLP._filter_features, TMM.FusionMLP._filter_features),
    (JMM.FusionMLP.train, TMM.FusionMLP.train),
    (JMM.FusionMLP.predict, TMM.FusionMLP.predict),
    (JENG.make_train_state, TENG.make_train_state),
    (JENG.learned_fusion_train_step, TENG.learned_fusion_train_step),
    (JMG.make_bins, TMG.make_bins),
    (JMG.bin_data, TMG.bin_data),
    (JMG._best_split, TMG._best_split),
    (JMG.grow_tree, TMG.grow_tree),
    (JMG._predict_tree_host, TMG._predict_tree_host),
    (JMG.Booster.__init__, TMG.Booster.__init__),
    (JMG.Booster.fit, TMG.Booster.fit),
    (JMG.Booster.ensemble, TMG.Booster.ensemble),
    (JMG.Booster.predict, TMG.Booster.predict),
    (JMG.PerRetrieverGBDT.__init__, TMG.PerRetrieverGBDT.__init__),
    (JMG.PerRetrieverGBDT.train, TMG.PerRetrieverGBDT.train),
    (JMG.PerRetrieverGBDT.predict, TMG.PerRetrieverGBDT.predict),
    (JMG.MultiOutputGBDT.__init__, TMG.MultiOutputGBDT.__init__),
    (JMI.parse_lgbm_model_str, TMI.parse_lgbm_model_str),
    (JMI._finish_tree, TMI._finish_tree),
    (JMI.booster_to_ensemble, TMI.booster_to_ensemble),
    (JMI._traverse_host, TMI._traverse_host),
    (JMI._normalize_weights, TMI._normalize_weights),
    (JMI._load_envelope, TMI._load_envelope),
    (JMI._RefUnpickler.find_class, TMI._RefUnpickler.find_class),
    (JMI.ReferenceGBDTFusion.__init__, TMI.ReferenceGBDTFusion.__init__),
    (JMI.ReferenceGBDTFusion.predict, TMI.ReferenceGBDTFusion.predict),
    (JMI.ReferenceMLPFusion.__init__, TMI.ReferenceMLPFusion.__init__),
    (JMI.ReferenceMLPFusion._filter, TMI.ReferenceMLPFusion._filter),
    (JMI.ReferenceMLPFusion.predict, TMI.ReferenceMLPFusion.predict),
    (JMI.load_reference_fusion_model, TMI.load_reference_fusion_model),
] + OFFLINE_PATH, ids=lambda f: getattr(f, "__qualname__", None))
def test_port_takes_jax_parameters_in_jax_order(jax_fn, port_fn):
    j = [PORT_NAME.get(n, n) for n in _names(jax_fn)]
    t = _names(port_fn)
    assert t[:len(j)] == j
    jp, tp = inspect.signature(jax_fn).parameters, inspect.signature(port_fn).parameters
    for name in jp:                                # and their defaults
        if jp[name].default is not inspect.Parameter.empty:
            want = PORT_DEFAULT.get(jp[name].default, jp[name].default)
            assert tp[PORT_NAME.get(name, name)].default == want, name


@pytest.mark.parametrize("jax_fn,port_fn", OFFLINE_PATH,
                         ids=lambda f: getattr(f, "__qualname__", None))
def test_offline_path_adds_at_most_device(jax_fn, port_fn):
    """The offline path's functions take JAX's parameters and at most
    `device` after them (default None: the card); the weighted fusion
    methods take it through their **kw."""
    j, t = _names(jax_fn), _names(port_fn)
    assert t in (j, j + ["device"])
    if t != j:
        assert inspect.signature(port_fn).parameters["device"].default is None


# ------------------------------------------------------------- dense ------

def _dense_inputs(seed=0, n=3000, d=32, b=7):
    rng = np.random.default_rng(seed)   # integer-valued: every score exact
    return (rng.integers(-2, 3, (b, d)).astype(np.float32),
            rng.integers(-3, 4, (n, d)).astype(np.float32))


@pytest.mark.parametrize("exact", [True, False])
def test_dense_topk_jax_style_call_matches_jax(exact):
    """qpp/variants.py's call, dense_topk(..., exact=exact), and the same
    parameters positionally; JAX's exact=False takes approx_max_k, which on
    the CPU returns lax.top_k's result."""
    q, c = _dense_inputs()
    jc = jnp.asarray(c, jnp.bfloat16)
    tc = torch.as_tensor(c).to(torch.bfloat16)
    js, ji = JD.dense_topk(jnp.asarray(q), jc, k=40, chunk=1024, exact=exact)
    ts, ti = TD.dense_topk(torch.as_tensor(q), tc, 40, 1024, exact, JD.DEFAULT_RECALL)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    proj = np.random.default_rng(1).integers(-1, 2, (3, 32, 32)).astype(np.float32)
    js, ji = JD.multi_view_topk(jnp.asarray(q), jnp.asarray(proj), jc, k=20, chunk=512,
                                exact=exact)
    ts, ti = TD.multi_view_topk(torch.as_tensor(q), torch.as_tensor(proj), tc, k=20,
                                chunk=512, exact=exact)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_dense_topk_refuses_a_recall_outside_the_unit_interval():
    q, c = map(torch.as_tensor, _dense_inputs(n=300))
    assert TD.DEFAULT_RECALL == JD.DEFAULT_RECALL
    for recall in (0.0, 1.5):
        with pytest.raises(ValueError, match="recall"):
            TD.dense_topk(q, c, k=5, recall=recall)
    TD.dense_topk(q, c, k=5, recall=1.0)


def test_dense_index_search_jax_style_call_matches_jax():
    """index/autotune.py's call, index.search(q, k=k, engine="stream",
    exact=True), positional exact included; DenseRetriever passes its
    exact on."""
    q, c = _dense_inputs(seed=2, n=1500)
    docnos = [f"d{i}" for i in range(len(c))]
    jidx, tidx = JR.DenseIndex(c, docnos), TR.DenseIndex(c, docnos, device="cpu")
    js, ji = jidx.search(q, k=25, engine="stream", exact=True)
    for ts, ti in (tidx.search(q, k=25, engine="stream", exact=True),
                   tidx.search(q, 25, True, None, "stream")):
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(ts, js)
    jr = JR.DenseRetriever(jidx, None, None, True)
    tr = TR.DenseRetriever(tidx, None, None, True)
    assert tr.exact is True
    for a, b in zip(tr.search_embeddings(q, k=25), jr.search_embeddings(q, k=25)):
        np.testing.assert_array_equal(a, b)


def _bits(x):
    return np.asarray(x).view(np.int32)


def _bf(x):
    return jnp.asarray(x, jnp.bfloat16), torch.as_tensor(x).to(torch.bfloat16)


@pytest.mark.parametrize("stride,tn,n_real", [(1, 256, 1900), (4, 512, 1700), (4, 512, 0),
                                              (2, 768, 0)])
def test_group_max_scores_jax_positional_call_matches_jax(stride, tn, n_real):
    """group_max_scores(q, c, tm, tn, n_real, stride), JAX's order, on a
    corpus of a multiple of tn docs (JAX asserts it): integer-valued bf16
    inputs, so bit for bit. n_real 0: every doc is real, the zero pad docs
    too."""
    rng = np.random.default_rng(stride + tn + n_real)
    q = rng.integers(-2, 3, (16, 64)).astype(np.float32)
    c = rng.integers(-2, 3, (2048 if tn != 768 else 2304, 64)).astype(np.float32)
    if n_real:
        c[n_real:] = 0
    (jq, tq), (jc, tc) = _bf(q), _bf(c)
    rv, ri = JK.group_max_scores(jq, jc, 8, tn, n_real, stride)
    ov, oi = TK.group_max_scores(tq, tc, 8, tn, n_real, stride)
    np.testing.assert_array_equal(_bits(ov.numpy()), _bits(rv))
    np.testing.assert_array_equal(oi.numpy(), np.asarray(ri))


@pytest.mark.parametrize("stride,tn", [(1, 256), (4, 1024)])
def test_pallas_dense_topk_jax_positional_call_matches_jax(stride, tn):
    """pallas_dense_topk(q, c, k, tm, tn, exact_merge, stride, packed), JAX's
    order, the unpacked route (K8) on a ragged corpus."""
    rng = np.random.default_rng(stride)
    q = rng.integers(-4, 5, (16, 64)).astype(np.float32)
    c = rng.integers(-4, 5, (1900, 64)).astype(np.float32)
    jc, tc = _bf(c)
    js, ji = JK.pallas_dense_topk(jnp.asarray(q), jc, 40, None, tn, True, stride, False)
    ts, ti = TK.pallas_dense_topk(torch.as_tensor(q), tc, 40, None, tn, True, stride, False)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("kernel", ["group_max_scores", "group_max_packed",
                                    "group_max_packed_int8", "group_max_packed_int8_global",
                                    "streaming_group_max"])
def test_n_real_zero_means_every_doc_is_real(kernel):
    """JAX's default n_real = 0 is "no padding": every doc of the corpus is
    real and none is masked. The corpora hold a multiple of JAX's tile, as
    JAX asserts; integer-valued inputs, bit for bit."""
    rng = np.random.default_rng(len(kernel))
    if kernel == "streaming_group_max":
        q = rng.integers(-2, 3, (512, 32)).astype(np.float32)    # one 512-row slab
        c = rng.integers(-2, 3, (JS.SUPER, 32)).astype(np.float32)
        (jq, tq), (jc, tc) = _bf(q), _bf(c)
        rv, ri = JS._streaming_group_max(jq, jc, n_real=0)
        ov, oi = TS.streaming_group_max(tq, tc, n_real=0)
        np.testing.assert_array_equal(_bits(ov.numpy()), _bits(rv))
        np.testing.assert_array_equal(oi.numpy(), np.asarray(ri))
        return
    if kernel in ("group_max_scores", "group_max_packed"):
        q = rng.integers(-4, 5, (16, 64)).astype(np.float32)
        c = rng.integers(-4, 5, (512, 64)).astype(np.float32)
        c[:, :8] = np.abs(c[:, :8])           # nonzero group maxima (module note of
        (jq, tq), (jc, tc) = _bf(q), _bf(c)   # test_torch_dense.py on denormals)
        ref = getattr(JK, kernel)(jq, jc, tm=8, tn=256, n_real=0)
        out = getattr(TK, kernel)(tq, tc, tm=8, tn=256, n_real=0)
        if kernel == "group_max_scores":
            np.testing.assert_array_equal(out[1].numpy(), np.asarray(ref[1]))
            ref, out = ref[0], out[0]
        np.testing.assert_array_equal(_bits(out.numpy()), _bits(ref))
        assert (out.numpy() > TK.NEG_FINITE / 2).all()          # no doc masked
        return
    q = rng.integers(-127, 128, (16, 96)).astype(np.int8)
    c = rng.integers(-127, 128, (512, 96)).astype(np.int8)
    jc, tc = jnp.asarray(c.T), torch.as_tensor(c)
    if kernel == "group_max_packed_int8":
        scale = rng.uniform(0.5, 2.0, 512).astype(np.float32)
        ref = JK.group_max_packed_int8(jnp.asarray(q), jc, jnp.asarray(scale[None]), tm=8,
                                       tn=256, n_real=0)
        out = TK.group_max_packed_int8(torch.as_tensor(q), tc, torch.as_tensor(scale), tm=8,
                                       tn=256, n_real=0)
        np.testing.assert_array_equal(_bits(out.numpy()), _bits(ref))
        assert (out.numpy() > TK.NEG_FINITE / 2).all()
    else:
        ref = JK.group_max_packed_int8_global(jnp.asarray(q), jc, tm=8, tn=256, n_real=0)
        out = TK.group_max_packed_int8_global(torch.as_tensor(q), tc, tm=8, tn=256, n_real=0)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
        assert ((out.numpy() >> 7) > TK.INT8_PAD).all()


# ------------------------------------------------------------ sparse ------

CAP, TQ, NB = 256, 8, 8          # M = 2048 keys a row; 8 rows (the Pallas row tile)


@pytest.fixture(scope="module")
def sparse_index():
    bo, bd, bw, _ = zipf_bm25_csr(8000, vocab_size=1500, avg_doc_len=25.0, seed=4,
                                  max_postings=200_000)
    packed, offsets, scales = TSP.pack_postings_presorted(bd, bw, bo, cap=CAP)
    bits = TSP.doc_vector_imp_bits(1500)
    dp, dsc, _ = TSP.pack_doc_vectors(bo, bd, bw, 8000, doc_cap=128, imp_bits=bits)
    qt, qw = zipf_queries(bo, NB, n_terms=TQ, seed=6)
    qt[1, -2:] = -1
    return dict(post=(packed, offsets.astype(np.int32), scales), doc=(dp, dsc), bits=bits,
                qt=qt, qw=qw)


@pytest.mark.parametrize("bitonic", [True, False])
def test_sparse_score_topk_q8_exact_topk_matches_jax(sparse_index, bitonic):
    """index/engines.py's exact_topk=True. With bitonic=True both packages
    take the bitonic pool (JAX's Pallas kernels in interpret mode, the TPU's
    tie order); with bitonic=False both take an exact lax.top_k order. The
    pools agree bit for bit."""
    args = (*sparse_index["post"], sparse_index["qt"], sparse_index["qw"])
    kw = dict(k=100, p_cap=CAP, exact_topk=True, bitonic=bitonic, presorted=True)
    js, ji = JSP.sparse_score_topk_q8(*map(jnp.asarray, args), **kw)
    ts, ti = TSP.sparse_score_topk_q8(*map(torch.as_tensor, args), dma_gather=True, **kw)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert (ti.numpy()[0] >= 0).all()


def _assert_ids_equal_up_to_near_ties(ti, ts, ji, rtol=4e-6):
    for b in range(ti.shape[0]):
        i = 0
        while i < ti.shape[1]:
            if ti[b, i] == ji[b, i]:
                i += 1
                continue
            assert i + 1 < ti.shape[1], (b, i)
            assert ti[b, i] == ji[b, i + 1] and ti[b, i + 1] == ji[b, i], (b, i)
            assert abs(ts[b, i] - ts[b, i + 1]) <= rtol * abs(ts[b, i]), (b, i)
            i += 2


def test_q8r_bitonic_false_takes_jax_off_tpu_pool(sparse_index):
    """bitonic=False: the pool is an exact top-k in lax.top_k's order, JAX's
    route off the TPU (approx_max_k at pool_recall, lax.top_k's result on
    the CPU), for a pool that is a strict part of the row."""
    ix = sparse_index
    args = (*ix["post"], *ix["doc"], ix["qt"], ix["qw"])
    kw = dict(k=50, p_cap=CAP, candidates=256, bitonic=False, imp_bits=ix["bits"],
              presorted=True)
    js, ji = map(np.asarray, JSP.sparse_score_topk_q8_rescored(*map(jnp.asarray, args), **kw))
    ts, ti = TSP.sparse_score_topk_q8_rescored(*map(torch.as_tensor, args), dma_gather=False,
                                               pool_recall=0.999, **kw)
    np.testing.assert_allclose(ts.numpy(), js, rtol=4e-6, atol=0)
    _assert_ids_equal_up_to_near_ties(ti.numpy(), ts.numpy(), ji)


def test_sparse_exact_rescore_term_scales_positional(sparse_index):
    """sparse_exact_rescore with term_scales as its seventh positional
    parameter and k as its eighth, as JAX orders them; _exact_rescore_scores
    with term_scales too."""
    ix = sparse_index
    rng = np.random.default_rng(8)
    cand = rng.integers(0, 8000, (NB, 64)).astype(np.int32)
    cand[2, -4:] = -1
    term_scales = rng.uniform(0.01, 0.5, 1500).astype(np.float32)
    args = (rng.random((NB, 64)).astype(np.float32), cand, *ix["doc"], ix["qt"], ix["qw"],
            term_scales, 30, ix["bits"])
    js, ji = map(np.asarray, JSP.sparse_exact_rescore(
        *map(jnp.asarray, args[:7]), *args[7:]))
    ts, ti = TSP.sparse_exact_rescore(*map(torch.as_tensor, args[:7]), *args[7:])
    assert ts.shape == (NB, 30)
    np.testing.assert_allclose(ts.numpy(), js, rtol=4e-6, atol=0)
    _assert_ids_equal_up_to_near_ties(ti.numpy(), ts.numpy(), ji)
    j_ids, j_s = map(np.asarray, JSP._exact_rescore_scores(
        *map(jnp.asarray, args[1:7]), imp_bits=ix["bits"]))
    t_ids, t_s = TSP._exact_rescore_scores(*map(torch.as_tensor, args[1:7]),
                                           imp_bits=ix["bits"])
    np.testing.assert_array_equal(t_ids.numpy(), j_ids)
    np.testing.assert_allclose(t_s.numpy(), j_s, rtol=4e-6, atol=0)
    with_scales = t_s.numpy()[cand >= 0]
    without = TSP._exact_rescore_scores(*map(torch.as_tensor, args[1:6]),
                                        imp_bits=ix["bits"])[1].numpy()[cand >= 0]
    assert (with_scales != without).any()          # the scales really fold in


def test_unported_rescore_and_sparse_flags_raise(sparse_index):
    """return_unmatched, once unported, now gives JAX's unmatched query
    weight (K6's matched output) beside the same ids and scores; an
    approx_recall outside (0, 1] still raises."""
    ix = sparse_index
    post = [torch.as_tensor(x) for x in (*ix["post"], ix["qt"], ix["qw"])]
    cand = TSP.sparse_score_topk_q8(*post, k=40, p_cap=CAP, presorted=True)[1].numpy()
    cand[:, -4:] = -1                              # and pads
    args = (cand, *ix["doc"], ix["qt"], ix["qw"])
    j = [np.asarray(x) for x in JSP._exact_rescore_scores(
        *map(jnp.asarray, args), imp_bits=ix["bits"], return_unmatched=True)]
    t = [x.numpy() for x in TSP._exact_rescore_scores(
        *map(torch.as_tensor, args), imp_bits=ix["bits"], return_unmatched=True)]
    np.testing.assert_array_equal(t[0], j[0])
    np.testing.assert_allclose(t[1], j[1], rtol=4e-6, atol=0)
    np.testing.assert_allclose(t[2], j[2], rtol=1e-5, atol=1e-5)
    mass = np.where(ix["qt"] >= 0, ix["qw"], 0).sum(axis=1, keepdims=True)
    assert (j[2] > 0).any() and (j[2][:, :-4] < 0.999 * mass).all()   # pooled docs match
    post = [torch.as_tensor(x) for x in (*ix["post"], ix["qt"], ix["qw"])]
    with pytest.raises(ValueError, match="approx_recall"):
        TSP.sparse_score_topk_q8(*post, p_cap=CAP, presorted=True, approx_recall=0.0)


# ---------------------------------------------------------- ensemble ------

def test_ensemble_step_defaults_to_jax_sort_mode_which_raises(sparse_index):
    """F2: the default sparse_mode is JAX's "sort", not a quantized one. The
    port serves it (tests/test_torch_sparse_modes.py), and like JAX raises
    on the presorted layout, which "sort" would read twice."""
    assert (inspect.signature(TE.ensemble_retrieval_step).parameters["sparse_mode"].default
            == inspect.signature(JE._ensemble_retrieval_step).parameters["sparse_mode"].default
            == "sort")
    ix = sparse_index
    packed, offsets, scales = map(torch.as_tensor, ix["post"])
    rows = torch.zeros((8000, 16), dtype=torch.int8)
    idx = TE.EnsembleIndexes(packed, scales, offsets, packed, scales, offsets, rows,
                             torch.ones(8000))
    inputs = (ix["qt"], ix["qw"], ix["qt"], ix["qw"], np.zeros((NB, 16), np.float32),
              np.zeros((2, 16, 16), np.float32), np.zeros((NB, 4), np.float32))
    with pytest.raises(ValueError, match="presorted layout needs"):
        JE.make_sparse_scorer("sort", 0, 10, CAP, presorted=True)
    with pytest.raises(ValueError, match="presorted layout needs"):
        TE.ensemble_retrieval_step(idx, *inputs, k=10, k_out=10, p_cap=CAP,
                                   sparse_presorted=True)


# ------------------------------------------ index layer and retrievers ------

INDEX_LAYER = [
    (JN.NativeIndexBuilder.__init__, TN.NativeIndexBuilder.__init__),
    (JN.NativeIndexBuilder.add_doc, TN.NativeIndexBuilder.add_doc),
    (JN.NativeIndexBuilder.add_docs, TN.NativeIndexBuilder.add_docs),
    (JN.NativeIndexBuilder.finalize, TN.NativeIndexBuilder.finalize),
    (JN.NativeIndexBuilder.export, TN.NativeIndexBuilder.export),
    (JN.NativeIndexBuilder.vocab_dump, TN.NativeIndexBuilder.vocab_dump),
    (JN.NativeIndexBuilder.vocab_load, TN.NativeIndexBuilder.vocab_load),
    (JN.NativeIndexBuilder.query_terms, TN.NativeIndexBuilder.query_terms),
    (JN.NativeIndexBuilder.close, TN.NativeIndexBuilder.close),
    (JEN.PackedEngineMixin._device_packed, TEN.PackedEngineMixin._device_packed),
    (JEN.PackedEngineMixin._device_doc_vectors, TEN.PackedEngineMixin._device_doc_vectors),
    (JEN.PackedEngineMixin._device_doc_vectors_exact,
     TEN.PackedEngineMixin._device_doc_vectors_exact),
    (JEN.PackedEngineMixin._engine_topk, TEN.PackedEngineMixin._engine_topk),
    (JIX.SparseIndex.__init__, TIX.SparseIndex.__init__),
    (JIX.SparseIndex.build_bm25, TIX.SparseIndex.build_bm25),
    (JIX.SparseIndex.quantize, TIX.SparseIndex.quantize),
    (JIX.SparseIndex.save, TIX.SparseIndex.save),
    (JIX.SparseIndex.load, TIX.SparseIndex.load),
    (JIX.SparseIndex.encode_queries, TIX.SparseIndex.encode_queries),
    (JIX.SparseIndex.search, TIX.SparseIndex.search),
    (JIX.SparseIndex.search_certified, TIX.SparseIndex.search_certified),
    (JIX.SparseIndex.docno, TIX.SparseIndex.docno),
    (JIX.SparseIndex.export_doc_vectors, TIX.SparseIndex.export_doc_vectors),
    (JA.autotune_sparse, TA.autotune_sparse),
    (JA.autotune_dense, TA.autotune_dense),
    (JA._recall_at_k, TA._recall_at_k),
    (JL.doc_text, TL.doc_text),
    (JL.qid_sort_key, TL.qid_sort_key),
    (JL.write_run_file, TL.write_run_file),
    (JBASE.write_results_trec, TBASE.write_results_trec),
    (JRG.get_retriever, TRG.get_retriever),
    (JBM.BM25Retriever.__init__, TBM.BM25Retriever.__init__),
    (JBM.BM25Retriever.from_corpus, TBM.BM25Retriever.from_corpus),
    (JBM.BM25Retriever.from_index_dir, TBM.BM25Retriever.from_index_dir),
    (JBM.BM25Retriever.from_terrier, TBM.BM25Retriever.from_terrier),
    (JBM.BM25Retriever.retrieve, TBM.BM25Retriever.retrieve),
    (JBM.BM25Retriever.retrieve_batch, TBM.BM25Retriever.retrieve_batch),
    (JH.pad_sequences, TSPL.pad_sequences),
    (JSPL.SpladeIndex.__init__, TSPL.SpladeIndex.__init__),
    (JSPL.SpladeIndex.from_impacts, TSPL.SpladeIndex.from_impacts),
    (JSPL.SpladeIndex.save, TSPL.SpladeIndex.save),
    (JSPL.SpladeIndex.load, TSPL.SpladeIndex.load),
    (JSPL.SpladeIndex.search_impacts, TSPL.SpladeIndex.search_impacts),
    (JSPL.SpladeRetriever.__init__, TSPL.SpladeRetriever.__init__),
    (JSPL.SpladeRetriever.build, TSPL.SpladeRetriever.build),
    (JSPL.SpladeRetriever.retrieve, TSPL.SpladeRetriever.retrieve),
    (JSPL.SpladeRetriever.retrieve_batch, TSPL.SpladeRetriever.retrieve_batch),
    (JTS.DenseReranker.__init__, TTS.DenseReranker.__init__),
    (JTS.DenseReranker.score, TTS.DenseReranker.score),
    (JTS.CrossEncoderReranker.__init__, TTS.CrossEncoderReranker.__init__),
    (JTS.CrossEncoderReranker.score, TTS.CrossEncoderReranker.score),
    (JTS.TwoStageRetriever.__init__, TTS.TwoStageRetriever.__init__),
    (JTS.TwoStageRetriever.retrieve, TTS.TwoStageRetriever.retrieve),
    (JTS.TwoStageRetriever.retrieve_batch, TTS.TwoStageRetriever.retrieve_batch),
]


@pytest.mark.parametrize("jax_fn,port_fn", INDEX_LAYER,
                         ids=lambda f: getattr(f, "__qualname__", None))
def test_index_layer_takes_jax_parameters_plus_device(jax_fn, port_fn):
    """JAX's parameters in JAX's order with JAX's defaults; the port adds
    at most `device` (default None: the card), after them."""
    j, t = _names(jax_fn), _names(port_fn)
    assert t in (j, j + ["device"])
    jp, tp = inspect.signature(jax_fn).parameters, inspect.signature(port_fn).parameters
    for name in jp:
        assert tp[name].kind == jp[name].kind, name
        if jp[name].default is not inspect.Parameter.empty:
            assert tp[name].default == jp[name].default, name
    if t != j:
        assert tp["device"].default is None


def test_index_layer_registry_and_exports_match_jax():
    import qpp_fusion_rag_tpu.index as JI
    import qpp_fusion_rag_tpu_torch.index as TI

    assert TI.__all__ == JI.__all__
    assert TRG.__all__ == JRG.__all__
    assert list(TRG.RETRIEVER_REGISTRY) == list(JRG.RETRIEVER_REGISTRY)
    for cls in ("TunedConfig", "TunedDenseConfig"):
        assert [f.name for f in __import__("dataclasses").fields(getattr(TA, cls))] == \
            [f.name for f in __import__("dataclasses").fields(getattr(JA, cls))]


# ---------------------------------------------- segment (F7) and records ----

@pytest.mark.parametrize("count_bonus", [False, True])
def test_segmented_topk_takes_jax_exact_topk_keyword(count_bonus):
    """ops/fusion.py's and ops/sparse.py's calls, segmented_topk(...,
    exact_topk=True) and the presorted one, run in the port (F7) and equal
    JAX's vmapped rows: integer-valued contributions, so the f32 run sums
    are exact in any order."""
    rng = np.random.default_rng(7)
    ids = rng.integers(0, 40, (6, 96)).astype(np.int32)
    ids[:, -10:] = JSEG.SENTINEL
    vals = np.where(ids == JSEG.SENTINEL, 0, rng.integers(0, 9, ids.shape)).astype(np.float32)
    kw = dict(count_bonus=count_bonus, exact_topk=True)
    ref = jax.vmap(lambda i, v: JSEG.segmented_topk(i, v, 12, **kw))(jnp.asarray(ids),
                                                                     jnp.asarray(vals))
    out = TSEG.segmented_topk(torch.as_tensor(ids), torch.as_tensor(vals), 12, **kw)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    order = np.argsort(ids, axis=1, kind="stable")
    sids, svals = np.take_along_axis(ids, order, 1), np.take_along_axis(vals, order, 1)
    ref = jax.vmap(lambda i, v: JSEG.segmented_topk_presorted(i, v, 12, **kw))(
        jnp.asarray(sids), jnp.asarray(svals))
    out = TSEG.segmented_topk_presorted(torch.as_tensor(sids), torch.as_tensor(svals), 12,
                                        exact_topk=False, count_bonus=count_bonus)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_records_and_exports_match_jax():
    """The NamedTuple records have JAX's fields in JAX's order, and the
    ops package re-exports JAX's names, the metrics names included."""
    assert TT.TreeEnsemble._fields == JT.TreeEnsemble._fields
    assert TENG.TrainState._fields == JENG.TrainState._fields
    assert TOPS.__all__ == JOPS.__all__
    for name in TOPS.__all__:
        assert getattr(TOPS, name).__name__ == getattr(JOPS, name).__name__
