"""The plain "sort" ensemble cell (nq-ensemble-plain.sort-b1024) at a size the
CPU holds: a root of its own with the benchmark copied and a tiny plain cell
added as new files and a new workload; the program's sort-mode step against
the plain reference, view by view and through the check; the whole run
through run.run_cell with the program's plain kernel versions, the control,
an altered id, a sort engine that sums directly with ties lowest doc id
first, one whose picks fall below the tie band, and a reference without the
band; tie_band.py's readings; the cell's two metric readers on synthetic
trace summaries. The tier-1 suite collects these tests too
(tests/test_bench_ensemble_plain.py)."""

from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import benchmark_torch.control as CONTROL  # noqa: E402
import benchmark_torch.run as RUN  # noqa: E402
from benchmark_torch.harness import check as CHECK  # noqa: E402
from benchmark_torch.harness.bench import Bench  # noqa: E402

CPU = torch.device("cpu")
CELL = "nq-ensemble-plain.sort-b1024"
TINY_CONFIG = {
    "kind": "ensemble_plain", "source": "a CPU-sized copy of nq-ensemble-plain",
    "docs": 6000, "dim": 64,
    "bm25": {"vocab": 3000, "zipf_a": 0.9874, "lognormal_sigma": 0.3957, "avg_doc_len": 30.0,
             "k1": 0.9, "b": 0.4},
    "splade": {"vocab": 1500, "zipf_a": 0.675, "lognormal_sigma": 0.3957, "avg_doc_len": 40.0,
               "k1": 0.9, "b": 0.4},
    "p_cap": 64, "presorted": False, "k": 20, "k_out": 20, "qpp_index": 5,
    "rerank_proj_scale": 0.05, "text_feats": [6, 6, 9, 5]}
TINY_TRAFFIC = {"mode": "sort", "batch": 24, "bm25_terms": 8, "splade_terms": 16, "pool": 2,
                "skip_top": 30, "min_df": 5}
TINY = "tiny-ensemble-plain.sort-tiny"
SEED = 2**31 + 7


def _dump(path: Path, obj) -> None:
    path.write_text(json.dumps(obj, indent=1))


def _root(base: Path) -> Path:
    """BENCHMARK.json and benchmark_torch/ copied under base, with the tiny
    plain cell added as new files and a workload (limits and metric lists
    those of the full-size cell)."""
    bench = base / "benchmark_torch"
    shutil.copytree(ROOT / "benchmark_torch", bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    _dump(bench / "configs" / "tiny-ensemble-plain.json", TINY_CONFIG)
    _dump(bench / "traffic" / "sort-tiny.json", TINY_TRAFFIC)
    spec["workloads"].append({"name": TINY, "config": "tiny-ensemble-plain",
                              "traffic": "sort-tiny", "chips": 1, "why": "CPU-sized"})
    shutil.copy(bench / "limits" / f"{CELL}.json", bench / "limits" / f"{TINY}.json")
    for m in spec["per_layer"]:
        if CELL in m.get("workloads", ()):
            m["workloads"].append(TINY)
    _dump(base / "BENCHMARK.json", spec)
    return base


@pytest.fixture(scope="module")
def plain_root(tmp_path_factory) -> Path:
    return _root(tmp_path_factory.mktemp("bench_plain"))


@pytest.fixture(scope="module")
def plain_step(plain_root):
    """-> (bench, cell, step) of the tiny plain cell, its set-up done once."""
    bench = Bench(plain_root)
    cell = bench.cell(TINY)
    return bench, cell, bench.step(cell["kind"]).build(cell, SEED, CPU, lambda msg: None)


def _run(root, trace=False, seed=SEED):
    """One whole run; its window of 2 s samples every pool batch even on a
    loaded CPU."""
    bench = Bench(root)
    return RUN.run_cell(bench, bench.cell(TINY), seed, 2.0, trace, CPU, time.perf_counter())


def test_cell_is_declared_with_its_files():
    bench = Bench(ROOT)
    cell = bench.cell(CELL)
    assert cell["kind"] == "ensemble_plain" and cell["workload"]["chips"] == 1
    cfg, q8 = cell["config"], bench.config("nq-ensemble")
    assert cfg["reduced"] == ["docs"] and cfg["presorted"] is False and "layout" in cfg
    assert {k: v for k, v in cfg.items() if k not in ("kind", "deployment", "presorted",
                                                      "layout", "precision", "assumed")} == {
        k: v for k, v in q8.items() if k not in ("kind", "deployment", "presorted",
                                                  "precision", "assumed")}
    assert cfg["assumed"][:-1] == q8["assumed"]
    assert cell["traffic"] == dict(bench.traffic("q8-b1024"), mode="sort")
    assert {"kernels_per_step", "sparse_views_ms", "dense_view_ms", "qpp_fusion_ms",
            "k1_roofline", "merge_roofline", "device_idle_share", "host_syncs_per_step",
            "host_blocked_ms", "qpp_fusion_idle_ms", "pair_sums_ms",
            "pair_sums_roofline"} == {m["name"] for m in bench.metrics_of(CELL, "per_layer")}
    names = [e["name"] for e in bench.spans("ensemble_plain")["spans"]]
    assert names[:6] == [e["name"] for e in bench.spans("ensemble")["spans"]]
    assert names[6:] == ["pair_sums"]


def test_sparse_views_and_fused_answers_match_the_reference(plain_step):
    """Each sparse view of the port's sort-mode step is the picks the step
    kept for the reference, and a top k of the reference's own sums: its
    ids are the reference's ties-lowest-id ids up to swaps of docs tied
    with the k-th score (no pick below it, so no swap past the tie band),
    and its scores, rank by rank, lie within 1e-5 of the query's pair mass
    of the reference's: the program's sums are differences of f32 prefix
    sums over the whole row, each off by at most a few dozen roundings of
    the row's total (2^-24 each), the reference's are direct sums. The
    fused answers and QPP pass the cell's check."""
    bench, cell, step = plain_step
    from qpp_fusion_rag_tpu_torch.pipeline import ensemble as E

    from benchmark_torch.reference import ensemble as Q8

    ref = bench.reference(cell["kind"])
    cfg = cell["config"]
    band = cell["limits"]["sparse_tie_band"]
    pairs, swapped = [], 0
    for i, (bt, bq, st, sq, *_) in enumerate(step.batches):
        for name, terms, qw in (("bm25", bt, bq), ("splade", st, sq)):
            scorer = E.make_sparse_scorer("sort", 0, cfg["k"], cfg["p_cap"])
            packed, off, scales = (getattr(step.idx, f"{name}_{f}")
                                   for f in ("packed", "offsets", "scales"))
            p_s, p_i = scorer(packed, off, scales, terms.to(torch.int32), qw)
            assert torch.equal(p_i, step.ref["picks"][i][name])
            grid = Q8.term_grid(step.ref[name])
            r_s, r_i, fall = ref.sparse_view(step.ref[name], grid, terms, qw, cfg["docs"],
                                             cfg["k"], torch.float32, picks=p_i, band=-1.0)
            assert (fall == 0).all()
            same = torch.sort(p_i.long(), 1).values == torch.sort(r_i, 1).values
            swapped += int((~same.all(1)).sum())
            mass = _pair_mass(step.ref[name], grid, terms, qw)
            gap = torch.where(p_i >= 0, (p_s - r_s).abs(), 0.0)
            assert torch.equal(p_i >= 0, r_i >= 0)
            assert (gap <= 1e-5 * mass[:, None]).all()
            s_a, i_a, _ = ref.sparse_view(step.ref[name], grid, terms, qw, cfg["docs"],
                                          cfg["k"], torch.float32, picks=p_i, band=band)
            assert torch.equal(torch.sort(i_a, 1).values, torch.sort(p_i.long(), 1).values)
        out = step(i)
        pairs.append(({"ids": out[0], "scores": out[1], "qpp": out[2]},
                      ref.run(step.ref, i, cell)))
    assert swapped > 0                     # the tiny cell has ties at the k-th rank
    verdict = CHECK.judge(pairs, cell["limits"])
    assert verdict["correct"] and verdict["failed"] == 0


def _pair_mass(csr, grid, terms, qw):
    """Each query's total of its window contributions (the row's mass)."""
    step, imp = grid
    off = csr["offsets"]
    total = torch.zeros(terms.shape[0], dtype=torch.float64)
    for b in range(terms.shape[0]):
        for t, w in zip(terms[b].tolist(), qw[b].tolist()):
            s, e = int(off[t]), int(off[t + 1])
            total[b] += float(imp[s:e].double().sum()) * float(step[t]) * w
    return total.to(torch.float32)


@pytest.mark.parametrize("trace", [False, True])
def test_tiny_plain_run_is_correct(plain_root, trace):
    r = _run(plain_root, trace=trace)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert all(v["value"] <= v["limit"] for v in r["check"].values())
    if not trace:
        assert set(r["metrics"]) == {"qps", "batch_p95_ms", "setup_s"}
    else:
        assert r["metrics"] == {}                  # no device events on the CPU


def test_control_fails_the_check(plain_root):
    bench = Bench(plain_root)
    for seed in (11, 12):
        r = CONTROL.readings(bench, bench.cell(TINY), seed, CPU)
        assert r["program_correct"] is True
        assert r["control_correct"] is False


def test_an_altered_id_is_not_correct(plain_root, monkeypatch):
    """Fusion hands back one query's best doc replaced by another."""
    from qpp_fusion_rag_tpu_torch.ops import fusion as F

    orig = F.fuse_kernel

    def altered(*a, **kw):
        ids, scores = orig(*a, **kw)
        ids = ids.clone()
        ids[0, 0] = ids[0, 0] + 1
        return ids, scores
    monkeypatch.setattr(F, "fuse_kernel", altered)
    r = _run(plain_root)
    assert r["correct"] is False and r["failed"] > 0


def _direct_scores(docs, vals, k):
    """Each doc's contributions summed directly (float64, rounded to f32
    once), the top k by score, ties lowest doc id first: the mode's
    meaning, written apart from the program's prefix sums."""
    from qpp_fusion_rag_tpu_torch.ops.segment import SENTINEL

    out_s, out_i = [], []
    for d, v in zip(docs.long(), vals):
        ok = d != SENTINEL
        uniq, inv = torch.unique(d[ok], return_inverse=True)
        sums = torch.zeros(uniq.numel(), dtype=torch.float64).index_add_(
            0, inv, v[ok].double()).float()
        order = sorted(range(uniq.numel()), key=lambda j: (-float(sums[j]), int(uniq[j])))[:k]
        pad = k - len(order)
        out_s.append(torch.cat([sums[order], torch.full((pad,), float("-inf"))]))
        out_i.append(torch.cat([uniq[order].int(), torch.full((pad,), -1, dtype=torch.int32)]))
    return torch.stack(out_s), torch.stack(out_i)


def test_a_program_summing_directly_with_ties_lowest_id_is_correct(plain_root, monkeypatch):
    """The mode's meaning taken literally, direct sums and ties lowest doc
    id first, meets the reference: its picks are the reference's own."""
    from qpp_fusion_rag_tpu_torch.ops import sparse as SP

    monkeypatch.setattr(SP, "_segmented_scores", _direct_scores)
    r = _run(plain_root)
    assert r["correct"] is True and r["failed"] == 0


def test_a_sparse_pick_below_the_tie_band_is_not_correct(plain_root, monkeypatch):
    """A sort engine whose every top k ends in its query's lowest-scoring
    doc, in the step and in the picks it hands the reference alike: the
    reference refuses the picks, and the fused answers miss its own."""
    from qpp_fusion_rag_tpu_torch.ops import sparse as SP

    orig = SP._segmented_scores

    def wrong(docs, vals, k):
        s, ids = orig(docs, vals, docs.shape[-1])
        n = (ids >= 0).sum(1, keepdim=True) - 1
        return (torch.cat([s[:, :k - 1], s.gather(1, n)], 1),
                torch.cat([ids[:, :k - 1], ids.gather(1, n)], 1))
    monkeypatch.setattr(SP, "_segmented_scores", wrong)
    r = _run(plain_root)
    assert r["correct"] is False and r["failed"] > 0


def test_without_the_tie_band_sound_runs_are_not_correct(tmp_path):
    """With a tie band below 0 the reference never takes the program's
    picks and keeps its own ties-lowest-id top k; the program's prefix sums
    order tied docs by their rounding, which moves docs across BM25's k-th
    rank and so changes the rerank views' candidates: why the band exists."""
    root = _root(tmp_path)
    lim = root / "benchmark_torch" / "limits" / f"{TINY}.json"
    _dump(lim, dict(json.loads(lim.read_text()), sparse_tie_band=-1.0))
    r = _run(root)
    assert r["correct"] is False and r["failed"] > 0


def test_tie_band_readings_bracket_the_limit(plain_root):
    """tie_band.py's readings on the tiny cell: the program's picks lie
    within the band (only exact ties are swapped), the bfloat16 sums' picks
    past it."""
    from benchmark_torch import tie_band as TB

    bench = Bench(plain_root)
    cell = bench.cell(TINY)
    step = bench.step(cell["kind"]).build(cell, SEED, CPU, lambda msg: None)
    r = TB.band_readings(bench, cell, step.ref)
    band = cell["limits"]["sparse_tie_band"]
    assert r["queries"] == 2 * TINY_TRAFFIC["pool"] * TINY_TRAFFIC["batch"]
    assert r["swapped"] > 0
    assert 0.0 <= r["program"] <= band < r["control"]


# ------------------------------------------------- the metric readers ------

def _summary(spans=None, steps=4):
    bench = Bench(ROOT)
    return {"steps": steps, "window_s": 1.0, "busy_s": 0.5, "kernel_count": 0,
            "kernels": {}, "spans": spans or {}, "idle_gaps": {}, "cell": bench.cell(CELL)}


def test_pair_sums_ms_reads_its_span_alone():
    m = Bench(ROOT).metric("pair_sums_ms")
    s = _summary(spans={"pair_sums": {"device_s": 0.064, "kernels": 400},
                        "sparse_view": {"device_s": 0.008, "kernels": 40}})
    assert m.read(s) == pytest.approx(16.0)
    assert m.read(_summary(spans={"sparse_view": {"device_s": 0.008, "kernels": 40}})) is None


def test_pair_sums_roofline_counts_each_pair_once():
    """At the cell's shape: 1024 x (8 + 16) x 2048 pairs of an int32 id and an
    f32 value read, and 100 f32 scores and int32 ids a query and view
    written, 404.3 MB, 0.1207 ms at 3.35 TB/s. Four steps whose span took
    twice that a step read 50 %; without the span, nothing."""
    bench = Bench(ROOT)
    m = bench.metric("pair_sums_roofline")
    nbytes = 1024 * (8 + 16) * 2048 * 8 + 2 * 1024 * 100 * 8
    assert nbytes == 404_291_584
    assert m.work_s(bench.cell(CELL)) == pytest.approx(nbytes / 3.35e12, rel=1e-12)
    assert m.work_s(bench.cell(CELL)) * 1e3 == pytest.approx(0.1207, abs=1e-4)
    secs = 4 * 2 * m.work_s(bench.cell(CELL))
    assert m.read(_summary(spans={"pair_sums": {"device_s": secs, "kernels": 400}})) == (
        pytest.approx(50.0))
    assert m.read(_summary(spans={"sparse_view": {"device_s": 1.0, "kernels": 4}})) is None
