"""The top-k of the q8 run sums (ops/kernels/q8_topk.py, csrc/q8_topk.cu).

On the CPU: q8_topk is topk_first over where(sums >= 0, sums * wmax,
-inf), the ids gathered and the pads masked (the q8 scorer's selection as
it was written before the kernel), at any k and tq; the wrapper's
refusals; the caps as the kernel's source states them; the integer order
being the score order at every sum below 2^22; and the q8 scorer's routes
(q8_topk at any query length, the bitonic pool with exact_topk). On the
card (marker cuda; they skip without one): the kernel is bit-equal, scores
and ids, to the plain version on the card over K2's own sums of cell-like
windows (1024 x 16,384, 32,768 and 65,536, and rows that tie by the
thousand at the k-th value), all-pad rows, rows with fewer runs than k,
k = M, k at the cap, sums at the 15-bit edge, rows wider than the staged
width, ragged and unaligned rows, wmax at the 1e-30 floor and where the
products overflow, and the 32-bit route of more than NARROW_TQ terms (sums
to the 2^22 edge); one launch a call, no wait, the scorer launches it at
any query length, and a k or tq above the caps is refused. The file imports no JAX; on the card run

    python -m pytest --noconftest -m cuda tests/test_torch_q8_topk.py
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from qpp_fusion_rag_tpu_torch.ops import sparse as SP
from qpp_fusion_rag_tpu_torch.ops.kernels import LAUNCHES, _build
from qpp_fusion_rag_tpu_torch.ops.kernels.bitonic import bitonic_segsum_rows
from qpp_fusion_rag_tpu_torch.ops.kernels.q8_topk import (
    MAX_K,
    MAX_TQ,
    NARROW_TQ,
    q8_topk,
    q8_topk_plain,
)
from qpp_fusion_rag_tpu_torch.ops.segment import topk_first

ROOT = Path(__file__).resolve().parents[1]
STAGED = 98_304       # csrc/q8_topk.cu kMaxStaged: the widest row staged in shared memory
BINS = 8192           # csrc/q8_topk.cu kCountBins


def _k2_rows(kind, B, Tq, cap, seed, device="cpu"):
    """K2's run sums of Tq windows of `cap` postings a query, as
    _q8_row_sums makes them: each window a term's distinct doc ids (drawn
    from a skewed range, so that docs repeat across terms), INT32_MAX past
    the term's length, keys (doc << 8 | q8), summed by bitonic_segsum_rows
    (the kernel on the card) and masked to -1 on pads. "cell": q8 values of
    uint8 impacts times a per-term ratio; "ties": q8 1 at 30 % of the
    postings, else 0, and docs spread over 2^22 ids, so that thousands of
    runs share the k-th sum. -> (sums, sids, wmax_col)."""
    g = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand((B, Tq, cap), generator=g, device=device)
    span = (1 << 22) - cap if kind == "ties" else 40 * cap * u ** 2
    raw = torch.sort((span * u).to(torch.int32), dim=-1).values
    docs = raw + torch.arange(cap, dtype=torch.int32, device=device)   # distinct in a window
    lens = torch.randint(cap // 8, cap + 1, (B, Tq, 1), generator=g, device=device)
    lens[:, :1] = cap
    pad = torch.arange(cap, device=device) >= lens
    if kind == "ties":
        q8 = (torch.rand((B, Tq, cap), generator=g, device=device) < 0.3).to(torch.int32)
    else:
        ratio = torch.rand((B, Tq, 1), generator=g, device=device) * 0.98 + 0.02
        ratio[:, :1] = 1.0
        imp = torch.randint(0, 256, (B, Tq, cap), generator=g, device=device).float()
        q8 = torch.round(imp * ratio).to(torch.int32)
    keys = torch.where(pad, SP.INT32_MAX, (docs << 8) | q8).reshape(B, -1).contiguous()
    sums, sids = bitonic_segsum_rows(keys, max_run=Tq)
    sums = torch.where(sids >= SP.SID_INVALID, -1, sums)
    wmax = torch.rand((B, 1), generator=g, device=device) * 3.0 + 0.05
    return sums, sids, wmax


def _direct_rows(kind, B, M, seed, device="cpu"):
    """Run sums drawn directly (no K2): -1 at ~70 % of the columns, ids a
    permutation. "edge": sums in [32,000, 32,640] (128 terms x 255);
    "pads": the first row all -1, the second with 37 runs (M / 2 where
    M < 74); "small": sums in [0, 6); "wide": sums in [0, 40,800) (160
    terms x 255); "wide_edge": sums in [4,190,000, 4,194,240] (MAX_TQ terms
    x 255); "wide_ties": sums in [40,000, 40,006). -> (sums, sids,
    wmax_col)."""
    rng = np.random.default_rng(seed)
    lo, hi = {"edge": (32_000, 32_641), "small": (0, 6), "wide": (0, 40_800),
              "wide_edge": (4_190_000, MAX_TQ * 255 + 1),
              "wide_ties": (40_000, 40_006)}.get(kind, (0, 2000))
    sums = rng.integers(lo, hi, (B, M)).astype(np.int32)
    sums[rng.random((B, M)) < 0.7] = -1
    if kind == "pads":
        sums[0] = -1
        sums[1] = -1
        n = min(37, M // 2)
        sums[1, rng.choice(M, n, replace=False)] = rng.integers(0, 50, n)
    sids = np.argsort(rng.random((B, M)), axis=1).astype(np.int32)
    wmax = (rng.random((B, 1)) * 3.0 + 0.05).astype(np.float32)
    return tuple(torch.from_numpy(x).to(device) for x in (sums, sids, wmax))


def _reference(sums, sids, wmax_col, k):
    """The q8 scorer's selection as written before the kernel."""
    scores = torch.where(sums >= 0, sums.to(torch.float32) * wmax_col, float("-inf"))
    top_vals, top_idx = topk_first(scores, min(k, sums.shape[1]))
    top_ids = torch.gather(sids, -1, top_idx)
    ok = torch.isfinite(top_vals)
    return torch.where(ok, top_vals, float("-inf")), torch.where(ok, top_ids, -1)


def _equal(got, want):
    (gs, gi), (ws, wi) = got, want
    assert gs.dtype == torch.float32 and gi.dtype == torch.int32
    assert gs.shape == gi.shape == ws.shape == wi.shape
    assert torch.equal(gi, wi)
    assert torch.equal(gs.view(torch.int32), ws.view(torch.int32))


# ---------------------------------------------------------------- CPU -----

@pytest.mark.parametrize("kind,B,Tq,cap,k", [
    ("cell", 3, 8, 64, 100), ("cell", 2, 16, 128, 100), ("ties", 2, 32, 64, 100),
    ("cell", 2, 2, 32, 64), ("ties", 3, 1, 16, 1)])
def test_cpu_k2_rows_take_the_scorer_s_selection(kind, B, Tq, cap, k):
    sums, sids, wmax = _k2_rows(kind, B, Tq, cap, B + Tq + cap)
    _equal(q8_topk(sums, sids, wmax, k, Tq), _reference(sums, sids, wmax, k))
    _equal(q8_topk_plain(sums, sids, wmax, min(k, sums.shape[1])), _reference(sums, sids, wmax, k))


@pytest.mark.parametrize("kind,M,k", [("edge", 1000, 100), ("pads", 300, 100), ("small", 4097, 100),
                                      ("random", 17, 17)])
def test_cpu_direct_rows_take_the_scorer_s_selection(kind, M, k):
    sums, sids, wmax = _direct_rows(kind, 3, M, M + k)
    _equal(q8_topk(sums, sids, wmax, k, NARROW_TQ), _reference(sums, sids, wmax, k))


def test_cpu_takes_any_k():
    """The cap is the kernel's: CPU rows take the plain version at any k."""
    sums, sids, wmax = _direct_rows("random", 2, 9000, 4)
    _equal(q8_topk(sums, sids, wmax, MAX_K + 1, 8), _reference(sums, sids, wmax, MAX_K + 1))


def test_cpu_k_zero_gives_empty_rows():
    sums, sids, wmax = _direct_rows("random", 2, 64, 5)
    scores, ids = q8_topk(sums, sids, wmax, 0, 8)
    assert scores.shape == ids.shape == (2, 0)


def test_ties_rows_tie_by_the_thousand_at_the_k_th_sum():
    """The "ties" rows at a card width hold over a thousand runs at their
    100th best sum, so the card cases below test the counting select's
    column-ordered ties (row_select.cuh's threshold admits more than its
    sort buffer there)."""
    for tq in (8, 32):
        sums, _, _ = _k2_rows("ties", 2, tq, 2048, tq)
        kth = torch.sort(sums, dim=-1, descending=True).values[:, 99:100]
        assert bool(((sums == kth).sum(dim=-1) > 1000).all())


_S = torch.zeros(4, 8, dtype=torch.int32)
_W = torch.ones(4, 1)


@pytest.mark.parametrize("sums,sids,wmax,match", [
    (_S.long(), _S, _W, "sums must"),
    (_S.float(), _S, _W, "sums must"),
    (_S[0], _S[0], _W, "sums must"),
    (_S[None], _S[None], _W, "sums must"),
    (torch.zeros(8, 4, dtype=torch.int32).T, _S, _W, "sums must"),
    (_S, _S.long(), _W, "sids must"),
    (_S, torch.zeros(4, 9, dtype=torch.int32), _W, "sids must"),
    (_S, _S, _W.double(), "wmax_col must"),
    (_S, _S, _W[:, 0], "wmax_col must"),
    (_S, _S, torch.ones(4, 2)[:, :1], "wmax_col must"),
    (torch.zeros(4, 8, dtype=torch.int32, device="meta"),
     torch.zeros(4, 8, dtype=torch.int32, device="meta"), torch.ones(4, 1, device="meta"),
     "unsupported devices"),
])
def test_wrapper_refuses(sums, sids, wmax, match):
    with pytest.raises(ValueError, match=match):
        q8_topk(sums, sids, wmax, 2, 8)


def test_wrapper_refuses_a_negative_k():
    with pytest.raises(ValueError, match="k=-1"):
        q8_topk(_S, _S, _W, -1, 8)


def test_wrapper_refuses_a_negative_tq():
    with pytest.raises(ValueError, match="tq=-1"):
        q8_topk(_S, _S, _W, 2, -1)


@pytest.mark.parametrize("kind,tq", [("wide", NARROW_TQ + 1), ("wide_edge", MAX_TQ + 1)])
def test_cpu_takes_any_tq(kind, tq):
    """The caps on tq are the kernel's: CPU rows take the plain version for
    sums past 15 bits and past 2^22."""
    sums, sids, wmax = _direct_rows(kind, 2, 3000, tq)
    _equal(q8_topk(sums, sids, wmax, 100, tq), _reference(sums, sids, wmax, 100))


def test_caps_are_the_kernel_s():
    """MAX_K is the shared selection's kMaxK; STAGED and BINS the kernel's;
    NARROW_TQ is the most terms whose sums stay below 2^15 (so a staged
    key, sum + 1, fits 16 bits), MAX_TQ the most whose sums stay below 2^22;
    the C entry point's arguments are declared."""
    csrc = ROOT / "qpp_fusion_rag_tpu_torch" / "csrc"
    src = (csrc / "q8_topk.cu").read_text()
    assert f"constexpr int kMaxStaged = {STAGED};" in src
    assert f"constexpr int kCountBins = {BINS};" in src
    assert '#include "row_select.cuh"' in src
    sel = (csrc / "row_select.cuh").read_text()
    assert f"constexpr int kSortCap = {MAX_K};" in sel and "constexpr int kMaxK = kSortCap;" in sel
    assert NARROW_TQ * 255 < 2 ** 15 <= (NARROW_TQ + 1) * 255
    assert NARROW_TQ * 255 + 1 <= 0xFFFF
    assert MAX_TQ * 255 < 2 ** 22 <= (MAX_TQ + 1) * 255
    assert len(_build.SIGNATURES["qfr_q8_topk"]) == 11


@pytest.mark.parametrize("wmax", [1e-30, 1.2e-38, 3.7e-7, 0.0123, 1.0, 2.5, 1e30])
def test_the_integer_order_is_the_score_order(wmax):
    """Every sum below 2^22 times a positive normal wmax, in f32: the
    products strictly increase with the sum, so selecting on the integers
    orders as the scores do and never merges two sums into one score."""
    s = torch.arange(2 ** 22, dtype=torch.int32).to(torch.float32) * torch.tensor(wmax)
    assert bool((s[1:] > s[:-1]).all())


def _q8_args(tq, p_cap=32, B=2, n_docs=500):
    from qpp_fusion_rag_tpu_torch.data.synthetic import zipf_bm25_csr, zipf_queries

    off, docs, w, _ = zipf_bm25_csr(n_docs, vocab_size=200, avg_doc_len=20.0, seed=1)
    packed, offsets, scales = SP.pack_postings_presorted(docs, w, off, cap=p_cap)
    qt, qw = zipf_queries(off, B, n_terms=tq, seed=tq)
    return [torch.as_tensor(x) for x in (packed, offsets.astype(np.int32), scales, qt, qw)]


def _spy(monkeypatch, name):
    real, seen = getattr(SP, name), []

    def spy(*a, **kw):
        seen.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(SP, name, spy)
    return seen


@pytest.mark.parametrize("exact_topk,k", [(False, 10), (True, 10 ** 6)])
def test_q8_scorer_selects_through_q8_topk(exact_topk, k, monkeypatch):
    """The q8 scorer's selection is one q8_topk call over its run sums: with
    exact_topk False, and with exact_topk True where kk is the whole row
    (no pool to take)."""
    args = _q8_args(4)
    want = SP.sparse_score_topk_q8(*args, k=k, p_cap=32, exact_topk=exact_topk, presorted=True)
    seen, pool = _spy(monkeypatch, "q8_topk"), _spy(monkeypatch, "_bitonic_pool")
    got = SP.sparse_score_topk_q8(*args, k=k, p_cap=32, exact_topk=exact_topk, presorted=True)
    assert seen == [(2, 4 * 32)] and pool == []
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_q8_scorer_with_exact_topk_keeps_the_bitonic_pool(monkeypatch):
    """exact_topk=True on a row _can_bitonic_pool takes still selects with
    the bitonic pool (highest position first among tied sums), not M3."""
    args = _q8_args(4)
    assert SP._can_bitonic_pool(4 * 32, 4)
    seen, pool = _spy(monkeypatch, "q8_topk"), _spy(monkeypatch, "_bitonic_pool")
    SP.sparse_score_topk_q8(*args, k=10, p_cap=32, exact_topk=True, presorted=True)
    assert seen == [] and pool == [(2, 4 * 32)]


def test_q8_scorer_above_narrow_tq_selects_through_q8_topk(monkeypatch):
    """Over NARROW_TQ query terms the run sums need not fit 15 bits: the
    scorer still selects with one q8_topk call (on the card, its 32-bit
    route), and with the plain version's answer."""
    args = _q8_args(NARROW_TQ + 1, p_cap=4, B=1)
    seen = _spy(monkeypatch, "q8_topk")
    scores, ids = SP.sparse_score_topk_q8(*args, k=10, p_cap=4, presorted=True)
    assert seen == [(1, (NARROW_TQ + 1) * 4)]
    sums, sids, wmax = SP._q8_row_sums(*args, 4, presorted=True)
    _equal((scores, ids), _reference(sums, sids, wmax, 10))


# ---------------------------------------------------------------- card ----

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the q8 top-k kernel has no CPU mode")
    return torch.device("cuda")


def _on_card(sums, sids, wmax, k, tq=32):
    """q8_topk on the card: one launch, counted; bit-equal to the plain
    version on the card."""
    before = dict(LAUNCHES)
    got = q8_topk(sums, sids, wmax, k, tq)
    torch.cuda.synchronize()
    assert LAUNCHES["q8_topk"] == before.get("q8_topk", 0) + 1
    assert sum(LAUNCHES.values()) == sum(before.values()) + 1
    _equal(got, _reference(sums, sids, wmax, k))
    _equal(got, q8_topk_plain(sums, sids, wmax, min(k, sums.shape[1])))


@pytest.mark.cuda
@pytest.mark.parametrize("kind,B,Tq,cap,k", [
    ("cell", 1024, 8, 2048, 100), ("cell", 1024, 16, 2048, 100), ("cell", 1024, 32, 2048, 100),
    ("ties", 1024, 8, 2048, 100), ("ties", 1024, 16, 2048, 100), ("ties", 1024, 32, 2048, 100),
    ("cell", 64, 16, 2048, MAX_K), ("ties", 64, 32, 2048, MAX_K), ("ties", 64, 32, 2048, 513),
    ("cell", 8, 16, 2048, 1), ("cell", 16, 2, 32, 64), ("ties", 16, 1, 16, 16),
    ("cell", 16, 3, 11, 100)])
def test_kernel_bit_equal_on_k2_rows(cuda, kind, B, Tq, cap, k):
    """K2's own sums: the cells' widths (16,384 / 32,768 / 65,536), ties by
    the thousand, k at the cap and just above the threshold's 512, k = 1,
    k = M (64 and 16) and a ragged width (33: 4-byte loads)."""
    sums, sids, wmax = _k2_rows(kind, B, Tq, cap, B + Tq + cap + k, cuda)
    _on_card(sums, sids, wmax, k, Tq)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,B,M,k", [
    ("pads", 4, 300, 100), ("pads", 4, 65_536, 100), ("pads", 3, 16, 16),
    ("edge", 64, 32_768, 100), ("edge", 8, 65_536, MAX_K), ("edge", 4, 1001, 100),
    ("small", 16, 65_536, 100), ("small", 4, STAGED, 100), ("small", 4, STAGED + 8, 100),
    ("edge", 4, STAGED + 5, 100), ("random", 4, 131_072, 100), ("pads", 4, 131_072, 100),
    ("random", 9, 37, 100), ("random", 9, 17, 5)])
def test_kernel_bit_equal_on_direct_rows(cuda, kind, B, M, k):
    """All-pad rows and rows of 37 runs, sums at the 15-bit edge (a range of
    641 keys; k at the cap), a 6-key range (a row's worth of ties), rows at
    and above the staged width (read from global memory on each pass, with
    4-byte loads at STAGED + 5) and the sort route's 131,072."""
    sums, sids, wmax = _direct_rows(kind, B, M, B + M + k, cuda)
    _on_card(sums, sids, wmax, k, NARROW_TQ)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,B,M,k,tq", [
    ("wide", 64, 40_960, 100, 160), ("wide", 4, 131_072, MAX_K, 160),
    ("wide", 9, 37, 100, 160), ("wide_edge", 16, 16_384, 100, MAX_TQ),
    ("wide_edge", 4, 1001, 513, MAX_TQ), ("wide_ties", 16, 32_768, 100, NARROW_TQ + 1),
    ("edge", 16, 32_768, 100, NARROW_TQ + 1), ("pads", 4, 300, 100, MAX_TQ),
    ("small", 4, 65_536, 100, MAX_TQ)])
def test_kernel_bit_equal_past_15_bits(cuda, kind, B, M, k, tq):
    """More than NARROW_TQ terms take the 32-bit route, never staged: sums
    to 40,800 (a coarse histogram pass), at the 2^22 edge, tied six ways,
    15-bit sums and all-pad rows on that route too, ragged widths and k at
    the cap."""
    sums, sids, wmax = _direct_rows(kind, B, M, B + M + k, cuda)
    _on_card(sums, sids, wmax, k, tq)


@pytest.mark.cuda
@pytest.mark.parametrize("wmax", [1e-30, 1e35, 3e34])
def test_kernel_bit_equal_at_extreme_wmax(cuda, wmax):
    """wmax at the scorer's 1e-30 floor, and where the largest products
    overflow to inf (both routes mask those ranks to -inf / -1)."""
    sums, sids, _ = _direct_rows("edge", 16, 16_384, 3, cuda)
    sums[:, ::3] = torch.randint(0, 200, sums[:, ::3].shape, device=cuda, dtype=torch.int32)
    _on_card(sums.contiguous(), sids, torch.full((16, 1), wmax, device=cuda), 100)


@pytest.mark.cuda
def test_kernel_takes_rows_not_16_byte_aligned(cuda):
    B, M = 9, 16_384
    sums, sids, wmax = _k2_rows("cell", B, 8, 2048, 5, cuda)
    s = torch.empty(B * M + 1, dtype=torch.int32, device=cuda)[1:].view(B, M).copy_(sums)
    assert s.data_ptr() % 16 and s.is_contiguous()
    _on_card(s, sids, wmax, 100, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("k,tq,match", [(MAX_K + 1, 8, f"k={MAX_K + 1}"),
                                        (100, MAX_TQ + 1, f"tq={MAX_TQ + 1}")])
def test_kernel_refuses_a_k_above_its_cap(cuda, k, tq, match):
    """On the card a k above MAX_K, or more than MAX_TQ terms, is refused:
    no launch, and no plain selection in its place."""
    sums, sids, wmax = _direct_rows("random", 4, 3000, 3, cuda)
    launches = LAUNCHES["q8_topk"]
    with pytest.raises(ValueError, match=match):
        q8_topk(sums, sids, wmax, k, tq)
    assert LAUNCHES["q8_topk"] == launches


@pytest.mark.cuda
@pytest.mark.parametrize("tq,p_cap,k", [(NARROW_TQ + 1, 4, 10), (8, 512, MAX_K)])
def test_q8_scorer_on_the_card_launches_q8_topk(cuda, tq, p_cap, k):
    """The q8 scorer on the card selects with one M3 launch past NARROW_TQ
    terms and at k = MAX_K, with the plain selection's answer over its run
    sums."""
    args = [a.to(cuda) for a in _q8_args(tq, p_cap=p_cap)]
    sums, sids, wmax = SP._q8_row_sums(*args, p_cap, presorted=True)
    launches = LAUNCHES["q8_topk"]
    got = SP.sparse_score_topk_q8(*args, k=k, p_cap=p_cap, presorted=True)
    assert LAUNCHES["q8_topk"] == launches + 1
    _equal(got, _reference(sums, sids, wmax, k))


@pytest.mark.cuda
def test_kernel_waits_for_nothing(cuda):
    sums, sids, wmax = _k2_rows("cell", 1024, 16, 2048, 3, cuda)
    wide = _direct_rows("small", 4, 131_072, 3, cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = q8_topk(sums, sids, wmax, 100, 16)
        got_wide = q8_topk(*wide, 100, 16)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    _equal(got, _reference(sums, sids, wmax, 100))
    _equal(got_wide, _reference(*wide, 100))
