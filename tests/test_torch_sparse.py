"""Port parity, sparse views: qpp_fusion_rag_tpu_torch's q8 scorer against
the JAX package's, on the dual presorted layout and on the plain
impact-ordered layout, with ids and scores equal bit for bit (integer run
sums, one f32 product each, the same tie order); and the rank-safe q8r
scorer, whose pool is equal bit for bit and whose exact rescore agrees to
rtol 4e-6 (ids equal up to adjacent swaps inside that band).

The q8r pool's tie order is the TPU's: the bitonic pool orders tied q8
sums by position, highest first, where lax.top_k takes the lowest index
first. So the port is compared with JAX called with bitonic=True (Pallas in
interpret mode), and with JAX's default route only where the pool is the
whole row (both sides then take a plain top-k)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qpp_fusion_rag_tpu.data.synthetic import zipf_bm25_csr, zipf_queries
from qpp_fusion_rag_tpu.ops import sparse as JSP
from qpp_fusion_rag_tpu_torch.ops import sparse as TSP


def _index(layout, cap, seed=3):
    bo, bd, bw, _ = zipf_bm25_csr(6000, vocab_size=1500, avg_doc_len=25.0,
                                  seed=seed, max_postings=150_000)
    if layout == "presorted":
        packed, offsets, scales = TSP.pack_postings_presorted(bd, bw, bo, cap=cap)
    else:
        packed, scales = TSP.pack_postings(bd, bw, bo)
        j_packed, j_scales = JSP.pack_postings(bd, bw, bo)
        np.testing.assert_array_equal(packed, j_packed)
        np.testing.assert_array_equal(scales, j_scales)
        offsets = bo
    return bo, packed, offsets.astype(np.int32), scales


def _queries(bo, B, tq, seed):
    qt, qw = zipf_queries(bo, B, n_terms=tq, seed=seed)
    rng = np.random.default_rng(seed)
    qw = (qw * rng.uniform(0.5, 2.0, qw.shape)).astype(np.float32)
    qt[1, -2:] = -1          # padded query terms
    qt[2, :] = -1            # an empty query
    return qt, qw


@pytest.mark.parametrize("layout,cap,tq,k", [
    ("presorted", 64, 8, 32),
    ("presorted", 64, 16, 100),
    ("presorted", 128, 4, 20),
    ("plain", 64, 8, 32),
    ("plain", 100, 6, 50),
])
def test_sparse_score_topk_q8_matches_jax(layout, cap, tq, k):
    bo, packed, offsets, scales = _index(layout, cap)
    qt, qw = _queries(bo, 12, tq, seed=tq)
    presorted = layout == "presorted"
    js, ji = JSP.sparse_score_topk_q8(
        jnp.asarray(packed), jnp.asarray(offsets), jnp.asarray(scales),
        jnp.asarray(qt), jnp.asarray(qw), k=k, p_cap=cap, presorted=presorted)
    ts, ti = TSP.sparse_score_topk_q8(
        torch.as_tensor(packed), torch.as_tensor(offsets), torch.as_tensor(scales),
        torch.as_tensor(qt), torch.as_tensor(qw), k=k, p_cap=cap, presorted=presorted)
    assert ti.dtype == torch.int32 and ts.dtype == torch.float32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert (ti.numpy()[2] == -1).all()


def test_sparse_score_topk_q8_matches_jax_exact_topk():
    """The exact-selection mode of the reference picks the same rows."""
    bo, packed, offsets, scales = _index("presorted", 64)
    qt, qw = _queries(bo, 8, 8, seed=11)
    args = (packed, offsets, scales, qt, qw)
    js, ji = JSP.sparse_score_topk_q8(*map(jnp.asarray, args), k=40, p_cap=64,
                                      presorted=True, exact_topk=True)
    ts, ti = TSP.sparse_score_topk_q8(*map(torch.as_tensor, args), k=40, p_cap=64,
                                      presorted=True)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_q8_row_sums_real_positions_match_jax():
    """The run sums themselves: on the CPU the reference sorts with lax.sort
    and folds INT32_MIN pads into INT32_MAX, so positions shift, but the
    multiset of (doc, sum) pairs on real runs is identical."""
    bo, packed, offsets, scales = _index("presorted", 64)
    qt, qw = _queries(bo, 6, 8, seed=5)
    args = (packed, offsets, scales, qt, qw)
    j_sums, j_sids, j_wmax, _ = JSP._q8_row_sums(
        *map(jnp.asarray, args), p_cap=64, dma_gather=False, bitonic=False,
        presorted=True)
    sums, sids, wmax = TSP._q8_row_sums(*map(torch.as_tensor, args), p_cap=64,
                                        presorted=True)
    np.testing.assert_array_equal(wmax.numpy(), np.asarray(j_wmax))
    for b in range(6):
        j_pairs = sorted(zip(np.asarray(j_sids)[b][np.asarray(j_sums)[b] >= 0],
                             np.asarray(j_sums)[b][np.asarray(j_sums)[b] >= 0]))
        t_pairs = sorted(zip(sids.numpy()[b][sums.numpy()[b] >= 0],
                             sums.numpy()[b][sums.numpy()[b] >= 0]))
        assert j_pairs == t_pairs


def test_q8_row_sums_refuses_unported_flags():
    bo, packed, offsets, scales = _index("presorted", 64)
    qt, qw = _queries(bo, 4, 8, seed=1)
    args = tuple(map(torch.as_tensor, (packed, offsets, scales, qt, qw)))
    for flag in ("plus_one", "return_win_min"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            TSP._q8_row_sums(*args, p_cap=64, presorted=True, **{flag: True})


# ------------------------------------- long rows: M = Tq * p_cap > 32,768 --

@pytest.fixture(scope="module")
def long_rows():
    bo, bd, bw, _ = zipf_bm25_csr(8000, vocab_size=400, avg_doc_len=60.0, seed=9)
    packed, offsets, scales = TSP.pack_postings_presorted(bd, bw, bo, cap=2048)
    return bo, packed, offsets.astype(np.int32), scales


@pytest.mark.parametrize("tq", [32, 64])
def test_sparse_score_topk_q8_long_rows_match_jax(long_rows, tq):
    """Rows of Tq * p_cap = 65,536 keys (a SPLADE query of 32 terms at p_cap
    2048: K2 on a cluster of two CTAs on the card) and 131,072 keys (the
    sort route): ids and scores equal to JAX's default CPU route."""
    bo, packed, offsets, scales = long_rows
    qt, qw = _queries(bo, 4, tq, seed=tq)
    args = (packed, offsets, scales, qt, qw)
    js, ji = JSP.sparse_score_topk_q8(*map(jnp.asarray, args), k=100, p_cap=2048,
                                      presorted=True)
    ts, ti = TSP.sparse_score_topk_q8(*map(torch.as_tensor, args), k=100, p_cap=2048,
                                      presorted=True)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert (ti.numpy()[0] >= 0).all() and (ti.numpy()[2] == -1).all()


def test_q8_row_sums_route_by_row_length(long_rows, monkeypatch):
    """K2 (bitonic_segsum_rows) serves rows of up to 65,536 keys and never a
    longer one, which takes torch.sort + segmented sums; both routes give
    the same run sums on real positions."""
    bo, packed, offsets, scales = long_rows
    seen = []
    k2 = TSP.bitonic_segsum_rows
    monkeypatch.setattr(TSP, "bitonic_segsum_rows",
                        lambda keys, **kw: seen.append(keys.shape[1]) or k2(keys, **kw))
    for tq in (16, 32, 33, 64):
        qt, qw = _queries(bo, 3, tq, seed=tq + 1)
        args = tuple(map(torch.as_tensor, (packed, offsets, scales, qt, qw)))
        sums, sids, _ = TSP._q8_row_sums(*args, p_cap=2048, presorted=True)
        keys = TSP._q8_keys(*args, 2048, presorted=True)[0]
        r_sums, r_sids = TSP._sort_row_sums(keys)
        for b in range(3):
            got = sorted(zip(sids[b][sums[b] >= 0].tolist(), sums[b][sums[b] >= 0].tolist()))
            real = (r_sums[b] >= 0) & (r_sids[b] < TSP.SID_INVALID)
            assert got == sorted(zip(r_sids[b][real].tolist(), r_sums[b][real].tolist()))
    assert seen == [16 * 2048, 32 * 2048]


# ------------------------------------------------ presorted-cap check -----

def _presorted_offsets(cap=64):
    bo, packed, offsets, scales = _index("presorted", cap)
    return torch.as_tensor(offsets)


def test_validate_presorted_cap_caches_on_the_live_tensor(monkeypatch):
    calls = []
    real = TSP._max_dual_window
    monkeypatch.setattr(TSP, "_max_dual_window", lambda off: calls.append(1) or real(off))
    off = _presorted_offsets()
    TSP.validate_presorted_cap(off, 64)
    TSP.validate_presorted_cap(off, 64)
    assert len(calls) == 1                 # the second call does no reduction
    TSP.validate_presorted_cap(off, 128)   # a new p_cap is checked once more
    TSP.validate_presorted_cap(off, 128)
    assert len(calls) == 2


def test_validate_presorted_cap_rechecks_new_tensors(monkeypatch):
    calls = []
    real = TSP._max_dual_window
    monkeypatch.setattr(TSP, "_max_dual_window", lambda off: calls.append(1) or real(off))
    off = _presorted_offsets()
    TSP.validate_presorted_cap(off, 64)
    other = off.clone()                    # equal values, another object
    TSP.validate_presorted_cap(other, 64)
    assert len(calls) == 2
    for t in (off, other, off.clone()):
        with pytest.raises(ValueError, match="build cap"):
            TSP.validate_presorted_cap(t, 32)


# ----------------------------------------------------- q8r: the pool ------

@pytest.mark.parametrize("M,pool", [(2048, 256), (2048, 1024), (4096, 100)])
def test_bitonic_pool_matches_jax(M, pool):
    """Both branches: top-bs (K4) where 2*bs <= M, the full sort (K5) else
    (M 2048, pool 1024: bs 2048)."""
    rng = np.random.default_rng(M + pool)
    B = 8
    sids = np.sort(rng.integers(0, 50_000, (B, M)), axis=1).astype(np.int32)
    sums = rng.integers(0, 30, (B, M)).astype(np.int32)
    sums[rng.random((B, M)) < 0.5] = -1
    sums[3] = -1                                 # a row with no runs at all
    sums[4, : M - pool // 2] = -1                # fewer runs than the pool
    wmax = rng.uniform(0.1, 2.0, (B, 1)).astype(np.float32)
    j = [np.asarray(x) for x in JSP._bitonic_pool(
        jnp.asarray(sums), jnp.asarray(sids), pool, jnp.asarray(wmax))]
    t = [x.numpy() for x in TSP._bitonic_pool(
        torch.as_tensor(sums), torch.as_tensor(sids), pool, torch.as_tensor(wmax))]
    for name, a, b in zip(("cv", "ci", "outside_max"), t, j):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (t[1][3] == -1).all() and np.isneginf(t[2][3])


# --------------------------------------------------- q8r: the scorer ------

QN, QB, QCAP, QK, QBITS = 16_384, 16, 256, 100, 14


@pytest.fixture(scope="module")
def q8r_index():
    bo, bd, bw, _ = zipf_bm25_csr(QN, vocab_size=3000, avg_doc_len=30.0, seed=0)
    scales = TSP.term_scales_from_csr(bw, bo)
    layouts = {
        True: TSP.pack_postings_presorted(bd, bw, bo, cap=QCAP, scales=scales)[:2],
        False: (TSP.pack_postings(bd, bw, bo, scales=scales)[0], bo),
    }
    dp, dsc, _ = TSP.pack_doc_vectors(bo, bd, bw, QN, doc_cap=128, imp_bits=QBITS)
    qt, qw = zipf_queries(bo, QB, n_terms=8, seed=1)
    qt[1, -2:] = -1
    return dict(layouts=layouts, scales=scales, dp=dp, dsc=dsc, qt=qt, qw=qw)


def _assert_ids_equal_up_to_near_ties(ti, ts, ji, rtol=4e-6):
    """Equal ids, except two adjacent positions may swap where their scores
    differ by less than rtol (the rescore's f32 sums run in another order)."""
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


def _q8r(ix, presorted, candidates, jax_bitonic):
    packed, offsets = ix["layouts"][presorted]
    args = (packed, offsets.astype(np.int32), ix["scales"], ix["dp"], ix["dsc"],
            ix["qt"], ix["qw"])
    kw = dict(k=QK, p_cap=QCAP, candidates=candidates, imp_bits=QBITS, presorted=presorted)
    js, ji = map(np.asarray, JSP.sparse_score_topk_q8_rescored(
        *map(jnp.asarray, args), bitonic=jax_bitonic, **kw))
    ts, ti = TSP.sparse_score_topk_q8_rescored(*map(torch.as_tensor, args), **kw)
    return ts.numpy(), ti.numpy(), js, ji


@pytest.mark.parametrize("candidates", [256, 1024])
@pytest.mark.parametrize("presorted", [True, False])
def test_q8r_matches_jax_bitonic_route(q8r_index, presorted, candidates):
    """M = 8 * 256 = 2048: 256 candidates take the top-bs pool (K4), 1024
    the full-sort pool (K5); JAX with bitonic=True takes the same routes."""
    ts, ti, js, ji = _q8r(q8r_index, presorted, candidates, jax_bitonic=True)
    assert ti.shape == (QB, QK) and ti.dtype == np.int32
    np.testing.assert_allclose(ts, js, rtol=4e-6, atol=0)
    _assert_ids_equal_up_to_near_ties(ti, ts, ji)
    assert np.isfinite(ts[0]).all() and (ti[0] >= 0).all()


@pytest.mark.parametrize("presorted", [True, False])
def test_q8r_whole_row_pool_matches_jax_default_route(q8r_index, presorted):
    """candidates >= M: the pool is the whole row and both sides take a
    plain top-k, so JAX's own route (bitonic=False) is the reference."""
    ts, ti, js, ji = _q8r(q8r_index, presorted, 4096, jax_bitonic=False)
    np.testing.assert_allclose(ts, js, rtol=4e-6, atol=0)
    _assert_ids_equal_up_to_near_ties(ti, ts, ji)


def test_q8r_pool_tie_order_differs_from_lax_top_k(q8r_index):
    """The finding behind the comparison design: on tie-dense q8 sums the
    bitonic pool (highest position first) and lax.top_k (lowest index
    first) pick different pools, so the rescored top-k differ."""
    ix = q8r_index
    packed, offsets = ix["layouts"][True]
    args = [jnp.asarray(x) for x in (packed, offsets.astype(np.int32), ix["scales"], ix["dp"],
                                     ix["dsc"], ix["qt"], ix["qw"])]
    kw = dict(k=QK, p_cap=QCAP, candidates=256, imp_bits=QBITS, presorted=True)
    _, j_bit = JSP.sparse_score_topk_q8_rescored(*args, bitonic=True, **kw)
    _, j_top = JSP.sparse_score_topk_q8_rescored(*args, bitonic=False, **kw)
    differ = (np.asarray(j_bit) != np.asarray(j_top)).any(axis=1)
    assert differ.sum() >= 2
