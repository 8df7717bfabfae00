"""Port parity, host side: the numpy generators and packers of
qpp_fusion_rag_tpu_torch are array-equal to the JAX package's, so one built
index serves both packages."""

import numpy as np
import pytest
import torch

from qpp_fusion_rag_tpu.data import synthetic as JS
from qpp_fusion_rag_tpu.ops import sparse as JSP
from qpp_fusion_rag_tpu.ops.pallas.window_gather import pad_for_gather as j_pad
from qpp_fusion_rag_tpu_torch.data import synthetic as TS
from qpp_fusion_rag_tpu_torch.ops import sparse as TSP


def _assert_all_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("kw", [
    dict(n_docs=3000, vocab_size=800, avg_doc_len=25.0, seed=0,
         zipf_a=JS.CALIBRATED_ZIPF_A_BM25,
         lognormal_sigma=JS.CALIBRATED_LOGNORMAL_SIGMA),
    dict(n_docs=2500, vocab_size=500, avg_doc_len=40.0, seed=7,
         zipf_a=JS.CALIBRATED_ZIPF_A_SPLADE,
         lognormal_sigma=JS.CALIBRATED_LOGNORMAL_SIGMA, max_postings=60_000),
    dict(n_docs=1000, seed=3),
])
def test_zipf_bm25_csr_array_equal(kw):
    _assert_all_equal(JS.zipf_bm25_csr(**kw), TS.zipf_bm25_csr(**kw))


def test_calibrated_constants_equal():
    for name in ("CALIBRATED_ZIPF_A_BM25", "CALIBRATED_ZIPF_A_SPLADE",
                 "CALIBRATED_LOGNORMAL_SIGMA"):
        assert getattr(JS, name) == getattr(TS, name)


@pytest.mark.parametrize("n_terms,seed", [(8, 1), (16, 2)])
def test_zipf_queries_array_equal(n_terms, seed):
    bo, _, _, _ = JS.zipf_bm25_csr(3000, vocab_size=800, seed=0)
    _assert_all_equal(JS.zipf_queries(bo, 33, n_terms=n_terms, seed=seed),
                      TS.zipf_queries(bo, 33, n_terms=n_terms, seed=seed))


def _csr():
    return JS.zipf_bm25_csr(3000, vocab_size=700, avg_doc_len=30.0, seed=5)


def test_term_scales_array_equal():
    bo, _, bw, _ = _csr()
    _assert_all_equal([JSP.term_scales_from_csr(bw, bo)],
                      [TSP.term_scales_from_csr(bw, bo)])
    # empty lists and an all-zero list get scale 1.0 in both
    off = np.array([0, 0, 2, 2, 4], np.int64)
    w = np.array([3.0, 1.0, 0.0, 0.0], np.float32)
    _assert_all_equal([JSP.term_scales_from_csr(w, off)],
                      [TSP.term_scales_from_csr(w, off)])


@pytest.mark.parametrize("cap", [16, 64, 2048])
def test_pack_postings_presorted_byte_equal(cap):
    bo, bd, bw, _ = _csr()
    _assert_all_equal(JSP.pack_postings_presorted(bd, bw, bo, cap=cap),
                      TSP.pack_postings_presorted(bd, bw, bo, cap=cap))
    scales = JSP.term_scales_from_csr(bw, bo) * np.float32(1.5)
    _assert_all_equal(
        JSP.pack_postings_presorted(bd, bw, bo, cap=cap, scales=scales),
        TSP.pack_postings_presorted(bd, bw, bo, cap=cap, scales=scales))


@pytest.mark.parametrize("n,cap", [(0, 64), (6000, 1024), (1024, 4096), (5, 1)])
def test_pad_for_gather_equal(n, cap):
    flat = np.arange(n, dtype=np.int32)
    _assert_all_equal([j_pad(flat, cap)], [TSP.pad_for_gather(flat, cap)])


def test_packers_refuse_large_doc_ids():
    docs = np.array([0, (1 << 23) - 1], np.int32)
    w = np.ones(2, np.float32)
    off = np.array([0, 2], np.int64)
    with pytest.raises(ValueError, match="2\\^23"):
        TSP.pack_postings_presorted(docs, w, off, cap=4)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_validate_presorted_cap(as_tensor):
    bo, bd, bw, _ = _csr()
    _, off2, _ = TSP.pack_postings_presorted(bd, bw, bo, cap=64)
    off = torch.as_tensor(off2.astype(np.int32)) if as_tensor else off2
    TSP.validate_presorted_cap(off, 64)
    TSP.validate_presorted_cap(off, 128)     # larger p_cap: slower, still right
    with pytest.raises(ValueError, match="build cap"):
        TSP.validate_presorted_cap(off, 32)
    with pytest.raises(ValueError, match="build cap"):
        JSP.validate_presorted_cap(off2, 32)  # the reference refuses it too


def test_pack_postings_byte_equal():
    bo, bd, bw, _ = _csr()
    _assert_all_equal(JSP.pack_postings(bd, bw, bo), TSP.pack_postings(bd, bw, bo))
    scales = JSP.term_scales_from_csr(bw, bo) * np.float32(0.75)   # clamps at 255
    _assert_all_equal(JSP.pack_postings(bd, bw, bo, scales=scales),
                      TSP.pack_postings(bd, bw, bo, scales=scales))


@pytest.mark.parametrize("return_tail", [False, True])
@pytest.mark.parametrize("imp_bits", [8, 12, 14])
@pytest.mark.parametrize("doc_cap", [0, 16])
def test_pack_doc_vectors_array_equal(doc_cap, imp_bits, return_tail):
    """N=4096; doc_cap 16 truncates the longer docs (tail_max > 0 there)."""
    bo, bd, bw, _ = JS.zipf_bm25_csr(4096, vocab_size=900, avg_doc_len=25.0, seed=4)
    kw = dict(doc_cap=doc_cap, imp_bits=imp_bits, return_tail=return_tail)
    j = JSP.pack_doc_vectors(bo, bd, bw, 4096, **kw)
    t = TSP.pack_doc_vectors(bo, bd, bw, 4096, **kw)
    assert j[2] == t[2] and (doc_cap == 0 or t[2] == doc_cap)
    _assert_all_equal([x for i, x in enumerate(j) if i != 2],
                      [x for i, x in enumerate(t) if i != 2])
    if return_tail and doc_cap:
        assert (t[3] > 0).any()


@pytest.mark.parametrize("n_terms", [0, 1, 255, 30_000, 100_000, 2**20, 2**23 - 2])
def test_doc_vector_imp_bits_equal(n_terms):
    assert JSP.doc_vector_imp_bits(n_terms) == TSP.doc_vector_imp_bits(n_terms)
    assert JSP.doc_vector_imp_bits(n_terms, 12) == TSP.doc_vector_imp_bits(n_terms, 12)


def test_pack_doc_vectors_refuses_term_ids_beyond_the_sentinel():
    off = np.array([0] + [1] * (2**17), np.int64)
    off[-1] = 1
    with pytest.raises(ValueError, match="imp_bits"):
        TSP.pack_doc_vectors(off, np.zeros(1, np.int32), np.ones(1, np.float32), 1,
                             imp_bits=14)
