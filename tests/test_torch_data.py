"""Port parity, the data layer: DocVocab, every loader of data/loaders.py,
RunTensor and its constructors and transformations, and the run and .qpp
files both packages write, against the JAX package on the same seeded
files. The layer is host Python and numpy in both packages, so everything
is held equal: arrays, qids, vocab ids and file bytes."""

import json
import warnings

import numpy as np
import pytest

from qpp_fusion_rag_tpu.data import loaders as JL
from qpp_fusion_rag_tpu.data import runtensor as JRT
from qpp_fusion_rag_tpu.data import vocab as JV
from qpp_fusion_rag_tpu_torch.data import loaders as TL
from qpp_fusion_rag_tpu_torch.data import runtensor as TRT
from qpp_fusion_rag_tpu_torch.data import vocab as TV
from torch_offline_inputs import make_qrels, make_runs, write_beir


def _same_rt(t, j):
    np.testing.assert_array_equal(t.doc_ids, j.doc_ids)
    np.testing.assert_array_equal(t.scores, j.scores)
    assert t.doc_ids.dtype == j.doc_ids.dtype == np.int32
    assert t.scores.dtype == j.scores.dtype == np.float32
    assert t.qids == j.qids and t.retrievers == j.retrievers
    assert t.vocab.docnos() == j.vocab.docnos()


def test_doc_vocab_matches_jax(tmp_path):
    assert TV.PAD_ID == JV.PAD_ID == -1
    docs = ["d3", "d1", "d3", 7, "d9", "d1"]
    t, j = TV.DocVocab(docs[:2]), JV.DocVocab(docs[:2])
    np.testing.assert_array_equal(t.encode(docs), j.encode(docs))
    np.testing.assert_array_equal(t.encode(["d9", "nope"], add=False),
                                  j.encode(["d9", "nope"], add=False))
    assert t.decode([2, -1, 0]) == j.decode([2, -1, 0]) == ["7", "", "d3"]
    assert t.docnos() == j.docnos() and len(t) == len(j) == 4
    assert ("d9" in t) and ("x" not in t)
    assert (t.id_of("d1"), t.id_of("zz"), t.docno_of(1), t.docno_of(-1)) == \
        (j.id_of("d1"), j.id_of("zz"), j.docno_of(1), j.docno_of(-1))
    t.save(tmp_path / "t" / "vocab.json")
    j.save(tmp_path / "j" / "vocab.json")
    assert (tmp_path / "t" / "vocab.json").read_bytes() == (tmp_path / "j" / "vocab.json").read_bytes()
    assert TV.DocVocab.load(tmp_path / "j" / "vocab.json").docnos() == j.docnos()


def _corpus(tmp_path):
    path = tmp_path / "corpus.jsonl"
    lines = [
        {"_id": "a1", "title": "T one", "text": "alpha"},
        {"_id": 'q"x\\y', "title": "", "text": "escaped id"},    # the json fallback
        {"text": "no id first", "_id": "late"},
        {"_id": "b2", "title": "", "text": "beta"},
        {"_id": "c3", "title": "T three", "text": "gamma " * 80},
    ]
    with open(path, "w") as f:
        for rec in lines:
            f.write(json.dumps(rec) + "\n")
        f.write("not json\n")
    return path


def test_corpus_readers_match_jax(tmp_path):
    path = _corpus(tmp_path)
    t, j = TL.LazyCorpus(path), JL.LazyCorpus(path)
    assert t.doc_ids() == j.doc_ids() and len(t) == len(j) == 5
    assert 'q"x\\y' in t and "late" in t
    for d in j.doc_ids() + ["missing"]:
        assert t.get(d) == j.get(d)
        for title in (True, False):
            assert t.get_text(d, include_title=title) == j.get_text(d, include_title=title)
    want = ["c3", "missing", 'q"x\\y', "a1"]
    for title in (True, False):
        got = t.get_many(want, include_title=title)
        assert got == j.get_many(want, include_title=title)
        assert list(got) == ["a1", 'q"x\\y', "c3"]            # offset order
    clean = tmp_path / "clean.jsonl"
    clean.write_text("".join(ln for ln in path.read_text().splitlines(True)
                             if ln.startswith("{")))
    assert TL.load_corpus(clean) == JL.load_corpus(clean)
    assert TL.load_corpus(clean, max_docs=2) == JL.load_corpus(clean, max_docs=2)
    assert list(TL.iter_corpus(clean)) == list(JL.iter_corpus(clean))
    for corpus in (t, TL.load_corpus(clean), {"a1": "plain text"}):
        assert TL.doc_text(corpus, "a1") == JL.doc_text(corpus, "a1")


@pytest.mark.parametrize("layout", ["beir", "trec_header", "trec_plain"])
def test_queries_and_qrels_match_jax(tmp_path, layout):
    qids = [f"test{i}" for i in range(12)]
    qrels = make_qrels(3, qids)
    write_beir(tmp_path, qrels, qids)
    if layout != "beir":
        with open(tmp_path / "qrels" / "test.tsv", "w") as f:
            if layout == "trec_header":
                f.write("qid iter docno rel\n")
            for q, rels in qrels.items():
                for d, g in rels.items():
                    f.write(f"{q}  0 {d}   {g}\n")
    got = TL.load_qrels(tmp_path / "qrels" / "test.tsv")
    assert got == JL.load_qrels(tmp_path / "qrels" / "test.tsv") == qrels
    for split in ("test", "dev"):
        assert TL.load_queries(tmp_path, split) == JL.load_queries(tmp_path, split)
    if layout == "beir":
        assert set(TL.load_queries(tmp_path)) == set(qrels)
        assert len(TL.load_queries(tmp_path, "dev")) == len(qids) + 2   # no split file


def test_qrels_split_without_qids_is_refused(tmp_path):
    write_beir(tmp_path, {}, ["test0"])
    (tmp_path / "qrels" / "test.tsv").write_text("query-id\tcorpus-id\tscore\n\n")
    for mod in (TL, JL):
        with pytest.raises(ValueError, match="contains no qids"):
            mod.load_queries(tmp_path)
    bad = tmp_path / "bad.tsv"
    bad.write_text("q1\td1\t1\nq1 d2\n")
    for mod in (TL, JL):
        with pytest.raises(ValueError):
            mod.load_qrels(bad)


def test_run_loaders_match_jax(tmp_path):
    path = tmp_path / "run.res"
    path.write_text("q2 Q0 d5 2 1.5 tag\nq1 Q0 d1 1 3.0\nq2 Q0 d7 1 2.25 tag\n"
                    "short line\n\nq1 Q0 d9 3 -0.5 x\nq1 Q0 d4 2 1.0 x\n")
    for name in ("load_run_file", "load_run_pairs", "load_run_as_dict"):
        assert getattr(TL, name)(path) == getattr(JL, name)(path)
    assert TL.load_run_file(path)["q1"][0] == ("d1", 3.0, 1)


def test_qpp_files_byte_equal_and_read_back(tmp_path):
    rng = np.random.default_rng(4)
    results = {q: (rng.integers(0, 1000, 13) / 8.0).tolist()
               for q in ["test10", "test2", "5", "abc", "12"]}
    TL.write_qpp_file(results, tmp_path / "t" / "BM25.res.mmnorm.qpp")
    JL.write_qpp_file(results, tmp_path / "j" / "BM25.res.mmnorm.qpp")
    JL.write_qpp_file(results, tmp_path / "j" / "Splade.mmnorm.qpp")
    assert (tmp_path / "t" / "BM25.res.mmnorm.qpp").read_bytes() == \
        (tmp_path / "j" / "BM25.res.mmnorm.qpp").read_bytes()
    assert TL.load_qpp_file(tmp_path / "j" / "BM25.res.mmnorm.qpp") == \
        JL.load_qpp_file(tmp_path / "j" / "BM25.res.mmnorm.qpp") == results
    got = TL.load_qpp_scores(tmp_path / "j")
    assert got == JL.load_qpp_scores(tmp_path / "j")
    assert set(got["abc"]) == {"BM25", "Splade"}
    for mod in (TL, JL):
        with pytest.raises(FileNotFoundError):
            mod.load_qpp_scores(tmp_path / "j", suffix=".nothing")


def test_gold_answers_match_jax(tmp_path):
    qa = {"who wrote it": ["someone", "a writer"]}
    fv = {"7": {"claim": "c", "label": "SUPPORT", "evidence_doc_ids": ["d1"]}}
    for ds, gold in (("nq", qa), ("scifact", fv)):
        cfg = TL.config.dataset(ds)
        path = tmp_path / ds / cfg.corpus_subdir / cfg.gold_answers_file
        path.parent.mkdir(parents=True)
        path.write_text(json.dumps(gold))
        got = TL.load_gold_answers(ds, data_root=tmp_path)
        assert got == JL.load_gold_answers(ds, data_root=str(tmp_path)) == gold
    for args in (("0", "who wrote it", qa, "nq"), ("1", "nobody", qa, "nq"),
                 ("7", "c", fv, "scifact"), ("8", "c", fv, "scifact")):
        assert TL.get_gold_answer_for_query(*args) == JL.get_gold_answer_for_query(*args)
    assert TL.get_gold_answer_for_query("0", "who wrote it", qa, "nq") == {"answers": qa["who wrote it"]}
    for mod in (TL, JL):
        with pytest.raises(FileNotFoundError):
            mod.load_gold_answers("hotpotqa", data_root=tmp_path)


@pytest.mark.parametrize("integer", [True, False])
def test_runtensor_constructors_match_jax(integer):
    runs = make_runs(5, integer=integer)
    t, j = TRT.RunTensor.from_run_dicts(runs), JRT.RunTensor.from_run_dicts(runs)
    _same_rt(t, j)
    assert (t.doc_ids[0, 3] == -1).all() and np.isneginf(t.scores[0, 3]).all()
    np.testing.assert_array_equal(t.valid_counts, j.valid_counts)
    assert (t.R, t.Q, t.K) == (j.R, j.Q, j.K)
    # rank order first, then descending score: every row is non-increasing
    assert (np.diff(np.where(t.valid_mask, t.scores, 0), axis=-1)[t.valid_mask[..., 1:]] <= 0).all()
    qids = [f"test{i}" for i in (7, 2, 40)]
    tv, jv = TV.DocVocab(["d5", "d0"]), JV.DocVocab(["d5", "d0"])
    _same_rt(TRT.RunTensor.from_run_dicts(runs, vocab=tv, qids=qids, k=6),
             JRT.RunTensor.from_run_dicts(runs, vocab=jv, qids=qids, k=6))
    ta = TRT.RunTensor.from_arrays(j.doc_ids, j.scores, j.qids, j.retrievers, TV.DocVocab(j.vocab.docnos()))
    _same_rt(ta, j)


def test_runtensor_transformations_match_jax():
    runs = make_runs(6, R=3, Q=20, K=12)
    runs["ret1"]["test5"] = [("d1", 2.0, 1), ("d2", 2.0, 2)]      # a constant row
    t, j = TRT.RunTensor.from_run_dicts(runs), JRT.RunTensor.from_run_dicts(runs)
    with warnings.catch_warnings():
        warnings.simplefilter("error")                       # the All-NaN row is silent
        tn, jn = t.minmax_normalized(), j.minmax_normalized()
    _same_rt(tn, jn)
    assert np.isneginf(tn.scores[0, 3]).all()
    assert (tn.scores[1, 5, :2] == 0).all()
    names = ["ret2", "ret0"]
    qids = ["test9", "test0", "test3"]
    _same_rt(t.select_retrievers(names), j.select_retrievers(names))
    _same_rt(t.select_queries(qids), j.select_queries(qids))
    _same_rt(t.truncate(4), j.truncate(4))
    for r in (1, "ret2"):
        assert t.to_run_dict(r) == j.to_run_dict(r)


@pytest.mark.parametrize("integer", [True, False])
def test_write_trec_byte_equal_and_round_trips(tmp_path, integer):
    runs = make_runs(7, R=3, Q=16, K=10, integer=integer)
    t, j = TRT.RunTensor.from_run_dicts(runs), JRT.RunTensor.from_run_dicts(runs)
    for rt, d in ((t, "t"), (j, "j")):
        for r, name in enumerate(rt.retrievers):
            rt.write_trec(r, tmp_path / d / f"{name}.res")
            rt.minmax_normalized().write_trec(name, tmp_path / d / f"{name}.norm.res", tag="n")
    for f in sorted((tmp_path / "j").iterdir()):
        assert (tmp_path / "t" / f.name).read_bytes() == f.read_bytes(), f.name
    for norm in (False, True):
        back = TRT.RunTensor.from_trec_dir(tmp_path / "t", use_normalized=norm)
        _same_rt(back, JRT.RunTensor.from_trec_dir(tmp_path / "t", use_normalized=norm))
        _same_rt(TRT.load_runs_dir(tmp_path / "t", use_normalized=norm, k=5),
                 JRT.load_runs_dir(tmp_path / "t", use_normalized=norm, k=5))
        src = t.minmax_normalized() if norm else t
        # the same docnos row for row (ties keep their order), scores to .6f
        assert back.qids == src.qids and back.retrievers == src.retrievers
        np.testing.assert_array_equal(
            np.array(back.vocab.decode(back.doc_ids)), np.array(src.vocab.decode(src.doc_ids)))
        np.testing.assert_allclose(back.scores, src.scores, rtol=0, atol=1e-6)
    for mod in (TRT, JRT):
        with pytest.raises(FileNotFoundError):
            mod.RunTensor.from_trec_dir(tmp_path / "t" / "..", use_normalized=True)
