"""Whole runs at a size the CPU holds (the look for a card skipped), the
refusal without a card, the control, and runs with the timed path broken
underneath, which the check has to catch."""

import io
import json
import time
from contextlib import redirect_stdout

import pytest
import torch

import benchmark_torch.control as CONTROL
import benchmark_torch.run as RUN
from benchmark_torch.harness.bench import Bench

CELLS = ("tiny-ensemble.q8-tiny", "tiny-dense5.bf16-tiny", "tiny-dense5.int8-tiny")
CPU = torch.device("cpu")


def _run(root, cell, trace=False, seed=2**31 + 7):
    bench = Bench(root)
    return RUN.run_cell(bench, bench.cell(cell), seed, 0.3, trace, CPU, time.perf_counter())


@pytest.mark.parametrize("cell", CELLS)
def test_untraced_run_line(tiny_root, cell):
    r = _run(tiny_root, cell)
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "check"]
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["metrics"]) == {"qps", "batch_p95_ms", "setup_s"}
    assert all(m["value"] > 0 for m in r["metrics"].values())
    assert set(r["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(r["check"]) == {"fused_score_gap", "fused_id_gap", "qpp_gap"}
    assert all(v["value"] <= v["limit"] for v in r["check"].values())
    json.loads(json.dumps(r))


def test_traced_run_line(tiny_root):
    r = _run(tiny_root, CELLS[0], trace=True)
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                       "check"]
    assert r["correct"] is True
    assert r["metrics"] == {}                  # no device events on the CPU
    assert {"busy_s", "window_s"} <= set(r["device"])
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = RUN.main(["--workload", "nq-ensemble.q8-b1024", "--seed", "1", "--seconds", "1",
                   "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "never runs on the CPU" in out.err


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_check(tiny_root, cell):
    bench = Bench(tiny_root)
    for seed in (11, 12, 13):
        r = CONTROL.readings(bench, bench.cell(cell), seed, CPU)
        assert r["program_correct"] is True
        assert r["control_correct"] is False


def _alter_one_answer(monkeypatch):
    """Fusion hands back one query's best doc replaced by another."""
    from qpp_fusion_rag_tpu_torch.ops import fusion as F

    orig = F.fuse_kernel

    def altered(*a, **kw):
        ids, scores = orig(*a, **kw)
        ids = ids.clone()
        ids[0, 0] = ids[0, 0] + 1
        return ids, scores
    monkeypatch.setattr(F, "fuse_kernel", altered)


def _half_batch(monkeypatch, module, entry, n_batch_args):
    """The step retrieves the first half of the batch only (the QPP
    normalized over that half) and hands its answers out twice."""
    import importlib

    mod = importlib.import_module(module)
    orig = getattr(mod, entry)

    def half(*args, **kw):
        args = list(args)
        B = args[1].shape[0] if entry == "ensemble_retrieval_step" else args[0].shape[0]
        h = B // 2
        for j in n_batch_args:
            args[j] = args[j][:h]
        ids, scores, qpp = orig(*args, **kw)[:3]
        return (torch.cat([ids, ids])[:B], torch.cat([scores, scores])[:B],
                torch.cat([qpp, qpp], dim=1)[:, :B])
    monkeypatch.setattr(mod, entry, half)


def _shift_one_qpp_column(monkeypatch, module, entry):
    """The step hands back WIG (one of the 13 statistics, not snqc) off by
    0.1 for every query; the fused lists stay right."""
    import importlib

    mod = importlib.import_module(module)
    orig = getattr(mod, entry)

    def shifted(*args, **kw):
        ids, scores, qpp = orig(*args, **kw)[:3]
        qpp = qpp.clone()
        qpp[..., 2] += 0.1
        return ids, scores, qpp
    monkeypatch.setattr(mod, entry, shifted)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["altered_answer", "half_batch", "one_qpp_column"])
def test_a_broken_path_is_not_correct(tiny_root, monkeypatch, cell, fault):
    if fault == "altered_answer":
        _alter_one_answer(monkeypatch)
    elif fault == "one_qpp_column":
        if cell.startswith("tiny-ensemble"):
            _shift_one_qpp_column(monkeypatch, "qpp_fusion_rag_tpu_torch.pipeline.ensemble",
                                  "ensemble_retrieval_step")
        else:
            _shift_one_qpp_column(monkeypatch, "qpp_fusion_rag_tpu_torch.pipeline.engine",
                                  "fused_retrieval_step")
    elif cell.startswith("tiny-ensemble"):
        _half_batch(monkeypatch, "qpp_fusion_rag_tpu_torch.pipeline.ensemble",
                    "ensemble_retrieval_step", (1, 2, 3, 4, 5, 7))
    else:
        _half_batch(monkeypatch, "qpp_fusion_rag_tpu_torch.pipeline.engine",
                    "fused_retrieval_step", (0, 3))
    r = _run(tiny_root, cell)
    assert r["correct"] is False and r["failed"] > 0


def test_main_prints_one_line(monkeypatch, tiny_root):
    """main's output is the result and nothing else on stdout."""
    monkeypatch.setattr(RUN, "ROOT", tiny_root)
    monkeypatch.setattr(RUN, "chips_present", lambda n: True)
    monkeypatch.setattr(RUN, "program_home", lambda: tiny_root)
    monkeypatch.setattr(torch, "device", lambda *a: CPU)
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = RUN.main(["--workload", CELLS[2], "--seed", "5", "--seconds", "0.2"])
    lines = buf.getvalue().splitlines()
    assert rc == 0 and len(lines) == 1 and json.loads(lines[0])["correct"] is True


def test_a_checkout_without_the_program_gives_no_result(monkeypatch, tiny_root, capsys):
    """tiny_root holds BENCHMARK.json and the benchmark alone: the program
    this process imports lives elsewhere, so the run refuses."""
    monkeypatch.setattr(RUN, "ROOT", tiny_root)
    monkeypatch.setattr(RUN, "chips_present", lambda n: True)
    rc = RUN.main(["--workload", CELLS[2], "--seed", "5", "--seconds", "0.2"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "not from this checkout" in out.err
