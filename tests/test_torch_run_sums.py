"""The "sort" engine's run totals and their top-k (ops/kernels/run_sums.py,
csrc/run_sums_topk.cu).

On the CPU: run_sums_topk is segmented_topk_presorted (ids and sums, their
dtypes), the wrapper's refusals, the pair-sort scorers' call of it, and the
kernel's caps as its source states them. On the card (marker cuda; they
skip without one): the kernel is bit-equal to segmented_topk_presorted on
the card, scores and ids, over the plain cell's rows (1024 x 16,384 and
1024 x 32,768 pairs of uint8 impacts times f32 query weights, ties
everywhere), all-SENTINEL rows, ragged widths, rows shorter than k, rows
above the staged width (65,552 pairs: a fourth tree level), negative
values and values of a wide dynamic range (where the running maximum of
the prefix sums and the latest run end's differ); one launch a call, and a
k above the cap is refused. The file imports no JAX; on the card run

    python -m pytest --noconftest -m cuda tests/test_torch_run_sums.py
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from qpp_fusion_rag_tpu_torch.ops import sparse as SP
from qpp_fusion_rag_tpu_torch.ops.kernels import LAUNCHES
from qpp_fusion_rag_tpu_torch.ops.kernels.run_sums import MAX_K, run_sums_topk
from qpp_fusion_rag_tpu_torch.ops.segment import (
    SENTINEL,
    cumsum_blocked,
    segmented_topk_presorted,
)

ROOT = Path(__file__).resolve().parents[1]
STAGED = 49_152       # csrc/run_sums_topk.cu kMaxStaged: the widest row staged in shared memory


def _windows(B, Tq, cap, seed, device="cpu"):
    """Pairs as the packed "sort" path makes them: Tq windows of `cap`
    postings a query, each a term's doc ids (drawn from a skewed range, so
    that docs repeat across terms) with SENTINEL past the term's length,
    and uint8 impacts times the term's f32 query weight, 0 on the pads;
    sorted by id as _segmented_scores sorts them. -> (sids, svals)."""
    g = torch.Generator(device=device).manual_seed(seed)
    n_docs = 40 * cap
    u = torch.rand((B, Tq, cap), generator=g, device=device)
    docs = (n_docs * u ** 3).to(torch.int32)
    lens = torch.randint(cap // 8, cap + 1, (B, Tq, 1), generator=g, device=device)
    lens[:, :1] = cap                                  # one full window a query
    pad = torch.arange(cap, device=device) >= lens
    docs = torch.where(pad, SENTINEL, docs)
    imp = torch.randint(0, 256, (B, Tq, cap), generator=g, device=device).float()
    qw = torch.rand((B, Tq, 1), generator=g, device=device) * 2.5 + 0.1
    vals = torch.where(pad, 0.0, imp * qw)
    sids, order = torch.sort(docs.reshape(B, -1), dim=-1, stable=True)
    return sids, torch.gather(vals.reshape(B, -1), -1, order).contiguous()


def _pairs(kind, B, M, seed, device="cpu"):
    """Sorted pairs [B, M] of one kind. -> (sids int32, svals f32)."""
    if kind == "cell":
        return _windows(B, M // 2048, 2048, seed, device)
    rng = np.random.default_rng(seed)
    docs = rng.integers(0, max(2, M // 3), (B, M)).astype(np.int32)
    docs[rng.random((B, M)) < 0.1] = SENTINEL
    if kind == "sentinel":
        docs[0] = SENTINEL                             # a row with no real id
    sids = np.sort(docs, axis=1)
    if kind == "negative":
        svals = rng.normal(0.0, 1.0, (B, M))
    elif kind == "wide":
        svals = np.exp(rng.normal(0.0, 6.0, (B, M)))
    else:                                              # 8-bit impacts, exact ties
        svals = rng.integers(0, 256, (B, M)) * 0.37
    svals = np.where(sids == SENTINEL, 0.0, svals).astype(np.float32)
    return (torch.from_numpy(sids).to(device), torch.from_numpy(svals).to(device))


def _equal(got, sids, svals, k):
    """got (scores, ids) equals segmented_topk_presorted's (sums, ids) bit
    for bit, dtypes included."""
    ids, sums, _ = segmented_topk_presorted(sids, svals, k)
    scores, gids = got
    assert scores.dtype == torch.float32 and gids.dtype == torch.int32
    assert scores.shape == gids.shape == sums.shape
    assert torch.equal(gids, ids)
    assert torch.equal(scores.view(torch.int32), sums.view(torch.int32))


# ---------------------------------------------------------------- CPU -----

@pytest.mark.parametrize("kind,B,M,k", [
    ("impacts", 3, 1, 1), ("impacts", 3, 16, 100), ("impacts", 3, 17, 5), ("impacts", 4, 1001, 100),
    ("sentinel", 3, 300, 100), ("negative", 3, 1000, 100), ("wide", 3, 4097, 100),
    ("cell", 2, 16_384, 100)])
def test_cpu_rows_take_segmented_topk_presorted(kind, B, M, k):
    sids, svals = _pairs(kind, B, M, M + k)
    _equal(run_sums_topk(sids, svals, k), sids, svals, k)


def test_cpu_takes_any_k():
    """The cap is the kernel's: CPU rows take the torch route at any k."""
    sids, svals = _pairs("impacts", 2, 9000, 4)
    _equal(run_sums_topk(sids, svals, MAX_K + 1), sids, svals, MAX_K + 1)


def test_cpu_k_zero_gives_empty_rows():
    sids, svals = _pairs("impacts", 2, 64, 5)
    scores, ids = run_sums_topk(sids, svals, 0)
    assert scores.shape == ids.shape == (2, 0)


_S = torch.zeros(4, 8, dtype=torch.int32)
_V = torch.zeros(4, 8)


@pytest.mark.parametrize("sids,svals,match", [
    (_S.long(), _V, "int32"),
    (_S.float(), _V, "int32"),
    (_S[0], _V[0], "int32"),
    (_S[None], _V[None], "int32"),
    (torch.zeros(8, 4, dtype=torch.int32).T, _V, "contiguous"),
    (_S, _V.double(), "float32"),
    (_S, _V.bfloat16(), "float32"),
    (_S, torch.zeros(4, 9), "shape"),
    (_S, torch.zeros(8, 4).T, "contiguous"),
    (torch.zeros(4, 8, dtype=torch.int32, device="meta"), torch.zeros(4, 8, device="meta"),
     "unsupported devices"),
])
def test_wrapper_refuses(sids, svals, match):
    with pytest.raises(ValueError, match=match):
        run_sums_topk(sids, svals, 2)


def test_wrapper_refuses_a_negative_k():
    with pytest.raises(ValueError, match="k=-1"):
        run_sums_topk(_S, _V, -1)


def test_caps_are_the_kernel_s():
    """MAX_K is the shared selection's kMaxK; STAGED is the kernel's
    kMaxStaged; the kernel includes the selection row_topk.cu includes."""
    csrc = ROOT / "qpp_fusion_rag_tpu_torch" / "csrc"
    src = (csrc / "run_sums_topk.cu").read_text()
    assert f"constexpr int kMaxStaged = {STAGED};" in src
    assert '#include "row_select.cuh"' in src
    sel = (csrc / "row_select.cuh").read_text()
    assert f"constexpr int kSortCap = {MAX_K};" in sel and "constexpr int kMaxK = kSortCap;" in sel


@pytest.mark.parametrize("packed", [True, False])
def test_pair_sort_scorers_take_run_sums_topk(packed, monkeypatch):
    """Both pair-sort scorers sum through one run_sums_topk call on the
    id-sorted pairs of all their windows, at their k."""
    from qpp_fusion_rag_tpu_torch.data.synthetic import zipf_bm25_csr

    off, docs, w, _ = zipf_bm25_csr(500, vocab_size=200, avg_doc_len=20.0, seed=1)
    q_terms = torch.tensor([[3, 7, -1, 11], [0, 1, 2, 5]], dtype=torch.int32)
    q_weights = torch.tensor([[1.0, 0.5, 0.0, 2.0], [0.3, 0.7, 1.1, 0.2]])
    seen = []

    def spy(sids, svals, k):
        seen.append((tuple(sids.shape), k))
        return run_sums_topk(sids, svals, k)

    monkeypatch.setattr(SP, "run_sums_topk", spy)
    offsets = torch.from_numpy(off.astype(np.int32))
    if packed:
        pk, sc = SP.pack_postings(docs, w, off)
        SP.sparse_score_topk_packed(torch.from_numpy(pk), offsets, torch.from_numpy(sc),
                                    q_terms, q_weights, k=10, p_cap=32)
    else:
        SP.sparse_score_topk(torch.from_numpy(docs), torch.from_numpy(w), offsets, q_terms,
                             q_weights, k=10, p_cap=32)
    assert seen == [((2, 4 * 32), 10)]


def test_wide_rows_step_down_across_blocks():
    """The "wide" rows hold run ends whose prefix sum lies below an earlier
    run end's (the blocked cumsum's two associations): the running maximum
    and the latest run end differ there, so the card cases below test the
    kernel's choice of the maximum."""
    sids, svals = _pairs("wide", 3, 4097, 4097 + 100)
    c = cumsum_blocked(svals)
    last = torch.cat([sids[:, 1:] != sids[:, :-1], torch.ones_like(sids[:, :1], dtype=torch.bool)],
                     dim=-1)
    marked = torch.where(last, c, float("-inf"))
    assert bool((marked < torch.cummax(marked, dim=-1).values).any())


# ---------------------------------------------------------------- card ----

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the run sums kernel has no CPU mode")
    return torch.device("cuda")


def _on_card(sids, svals, k):
    """run_sums_topk on the card: one launch, counted."""
    before = dict(LAUNCHES)
    got = run_sums_topk(sids, svals, k)
    torch.cuda.synchronize()
    assert LAUNCHES["run_sums_topk"] == before.get("run_sums_topk", 0) + 1
    assert sum(LAUNCHES.values()) == sum(before.values()) + 1
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("kind,B,M,k", [
    ("cell", 1024, 16_384, 100), ("cell", 1024, 32_768, 100), ("cell", 64, 32_768, MAX_K),
    ("cell", 8, 32_768, 1), ("sentinel", 16, 4096, 100), ("sentinel", 4, 40, 100),
    ("impacts", 3, 1, 1), ("impacts", 5, 16, 100), ("impacts", 5, 17, 100),
    ("impacts", 7, 1000, 100), ("impacts", 7, 1001, 100), ("impacts", 9, 37, 100),
    ("impacts", 3, STAGED, 100), ("impacts", 3, STAGED + 4, 100), ("impacts", 4, 65_552, 100),
    ("cell", 4, 65_536, MAX_K), ("negative", 16, 16_384, 100), ("negative", 4, 65_551, 100),
    ("wide", 16, 32_768, 100), ("wide", 16, 4097, 100), ("wide", 4, 65_552, 100)])
def test_kernel_bit_equal_to_segmented_topk_presorted_on_the_card(cuda, kind, B, M, k):
    """Widths 1001, 37, 17 and 65,551 are no multiple of the 16-byte load
    (four pairs): they take the 4-byte loads; 1000 and 65,552 end in a
    ragged 16-pair block. Rows over STAGED pairs read their values from
    global memory in each pass."""
    sids, svals = _pairs(kind, B, M, B + M + k, cuda)
    _equal(_on_card(sids, svals, k), sids, svals, k)


@pytest.mark.cuda
def test_kernel_takes_rows_not_16_byte_aligned(cuda):
    B, M = 9, 16_384
    sids, svals = _pairs("cell", B, M, 5, cuda)
    s = torch.empty(B * M + 1, dtype=torch.int32, device=cuda)[1:].view(B, M).copy_(sids)
    v = torch.empty(B * M + 1, device=cuda)[1:].view(B, M).copy_(svals)
    assert s.data_ptr() % 16 and v.data_ptr() % 16 and s.is_contiguous() and v.is_contiguous()
    _equal(_on_card(s, v, 100), s, v, 100)


@pytest.mark.cuda
def test_kernel_refuses_a_k_above_its_cap(cuda):
    sids, svals = _pairs("impacts", 4, 3000, 3, cuda)
    launches = LAUNCHES["run_sums_topk"]
    with pytest.raises(ValueError, match=f"k={MAX_K + 1}"):
        run_sums_topk(sids, svals, MAX_K + 1)
    assert LAUNCHES["run_sums_topk"] == launches
    sids, svals = sids[:, :300].contiguous(), svals[:, :300].contiguous()
    _equal(run_sums_topk(sids, svals, MAX_K + 1), sids, svals, 300)


@pytest.mark.cuda
def test_kernel_waits_for_nothing(cuda):
    sids, svals = _pairs("cell", 1024, 16_384, 3, cuda)
    wide = _pairs("impacts", 4, 65_552, 3, cuda)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = run_sums_topk(sids, svals, 100)
        got_wide = run_sums_topk(*wide, 100)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    _equal(got, sids, svals, 100)
    _equal(got_wide, *wide, 100)
