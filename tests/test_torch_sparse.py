"""Port parity, q8 sparse view: qpp_fusion_rag_tpu_torch's
sparse_score_topk_q8 against the JAX package's, on the dual presorted
layout and on the plain impact-ordered layout. Ids and scores are equal
bit for bit (integer run sums, one f32 product each, the same tie order)."""

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
        packed, scales = JSP.pack_postings(bd, bw, bo)
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
