"""The rank-safe layer of the port: doc vectors packed by
ops.sparse.pack_doc_vectors_device array for array equal, on CPU tensors,
to the JAX package's host packer and, on the card, to the port's packer on
CPU tensors; and the rank-safe ensemble step's spans (sparse.rescore,
dense.rescore). CPU tensors, except the cases marked cuda, which skip
without a card. The file imports no JAX at module level (the CPU cases
import it in their bodies), so the card cases run where only torch is
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_rank_safe.py
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from qpp_fusion_rag_tpu_torch import tracing as T
from qpp_fusion_rag_tpu_torch.data.synthetic import zipf_bm25_csr, zipf_queries
from qpp_fusion_rag_tpu_torch.ops import sparse as SP
from qpp_fusion_rag_tpu_torch.ops.kernels.dense_topk import quantize_rows
from qpp_fusion_rag_tpu_torch.pipeline import ensemble as EM

DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


def _device(name):
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device(name)


@pytest.fixture(scope="module")
def csr():
    """Zipf postings over 3000 docs (the longest doc holds 84 terms)."""
    return zipf_bm25_csr(3000, vocab_size=800, avg_doc_len=40.0, seed=3)[:3]


PACK_CASES = {
    # name: (doc_cap, imp_bits, return_tail, weights, extra docs, max_entries)
    "whole_docs": (0, 8, False, "zipf", 0, None),
    "whole_docs_tail": (0, 12, True, "zipf", 0, None),
    "cap_above_longest": (1000, 12, True, "zipf", 0, None),
    "cut_8_bits": (24, 8, False, "zipf", 0, None),
    "cut_12_bits": (16, 12, True, "zipf", 0, None),
    "cut_14_bits": (16, 14, True, "zipf", 0, None),
    "tied_weights": (16, 12, True, "tied", 0, None),
    "empty_docs": (16, 12, True, "zipf", 500, None),
    "doc_ranges": (16, 12, True, "tied", 500, 1000),
}


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("case", PACK_CASES)
def test_device_packer_equals_host_packer(csr, case, device, monkeypatch):
    """Every output, dtype and shape included, equal bit for bit to an
    independent packing: on the CPU the JAX package's host packer, on the
    card the port's packer run on CPU tensors. A cut cap ranks each doc's
    terms by weight with ties in posting order (the tied case rounds the
    weights to halves, so most docs hold ties at the cut), empty docs keep
    scale 1 and sentinel rows, and ranges of docs cut small give the same
    arrays as one range."""
    dev = _device(device)
    doc_cap, bits, tail, weights, extra, max_entries = PACK_CASES[case]
    off, docs, w = csr
    if weights == "tied":
        w = (np.round(w * 2) / 2).astype(np.float32)
    n = 3000 + extra
    kw = dict(doc_cap=doc_cap, imp_bits=bits, return_tail=tail)
    if dev.type == "cpu":
        from qpp_fusion_rag_tpu.ops.sparse import pack_doc_vectors as reference
        want = reference(off, docs, w, n, **kw)
    else:
        want = SP.pack_doc_vectors(off, docs, w, n, **kw)
    if max_entries is not None:
        monkeypatch.setattr(SP, "DOC_PACK_ENTRIES", max_entries)
    got = SP.pack_doc_vectors_device(torch.from_numpy(off).to(dev),
                                     torch.from_numpy(docs).to(dev),
                                     torch.from_numpy(w).to(dev), n, **kw)
    assert len(got) == len(want) == (4 if tail else 3)
    assert got[2] == want[2]
    for g, h in zip(got[:2] + got[3:], want[:2] + want[3:]):
        assert g.device.type == dev.type
        g = g.cpu().numpy()
        assert g.dtype == h.dtype and g.shape == h.shape
        np.testing.assert_array_equal(g.view(np.int32), h.view(np.int32))
    if tail and 0 < doc_cap < 84:
        assert (want[3] > 0).any()                   # the cap cuts
    if extra:
        assert (want[0][3000:] == ((1 << (31 - bits)) - 1) << bits).all()


def test_device_packer_refuses_what_the_host_refuses(csr):
    off, docs, w = csr
    many = np.arange(1 << 18, dtype=np.int64)         # 2^18 - 1 terms > 2^17 - 1 at 14 bits
    for fn in (SP.pack_doc_vectors, SP.pack_doc_vectors_device):
        args = (many, docs[:0], w[:0]) if fn is SP.pack_doc_vectors else (
            torch.from_numpy(many), torch.from_numpy(docs[:0]), torch.from_numpy(w[:0]))
        with pytest.raises(ValueError, match="imp_bits=14"):
            fn(*args, 10, imp_bits=14)


# --------------------------------------------------- the q8r step ------

N, D, B, K, CAP, CAND, POOL = 4096, 32, 8, 16, 64, 48, 24


def _q8r_kit(device):
    """-> (step, inputs): the rank-safe ensemble step (q8r, a dense pool of
    POOL over bf16 rerank rows) over presorted postings and doc vectors
    packed on `device`; query terms, weights and text features are host
    tensors, as the benchmark hands them over."""
    arrays, inputs = {}, []
    bits = SP.doc_vector_imp_bits(1500)
    for name, vocab, avg, seed, tq in (("bm25", 1500, 30.0, 0, 8),
                                       ("splade", 1000, 40.0, 7, 16)):
        off, docs, w, _ = zipf_bm25_csr(N, vocab_size=vocab, avg_doc_len=avg, seed=seed)
        packed, off2, sc = SP.pack_postings_presorted(docs, w, off, cap=CAP)
        dp, ds, _ = SP.pack_doc_vectors_device(
            torch.from_numpy(off).to(device), torch.from_numpy(docs).to(device),
            torch.from_numpy(w).to(device), N, doc_cap=32, imp_bits=bits)
        arrays.update({f"{name}_packed": torch.from_numpy(packed).to(device),
                       f"{name}_offsets": torch.from_numpy(off2.astype(np.int32)).to(device),
                       f"{name}_scales": torch.from_numpy(sc).to(device),
                       f"{name}_doc_packed": dp, f"{name}_doc_scale": ds})
        qt, qw = zipf_queries(off, B, n_terms=tq, seed=seed + 1)
        inputs += [torch.from_numpy(qt), torch.from_numpy(qw)]
    rng = np.random.default_rng(0)
    corpus = torch.from_numpy(rng.standard_normal((N, D), np.float32))
    rows, d_scale = quantize_rows(corpus)
    idx = EM.EnsembleIndexes(corpus_rows=rows.to(device), d_scale=d_scale.reshape(-1).to(device),
                             rerank_rows=corpus.to(torch.bfloat16).to(device),
                             doc_imp_bits=bits, **arrays)
    q = torch.from_numpy(rng.standard_normal((B, D), np.float32)).to(device)
    proj = torch.from_numpy(rng.standard_normal((2, D, D), np.float32) * 0.05).to(device)
    tf = torch.tensor([[6.0, 6.0, 9.0, 5.0]]).repeat(B, 1)

    def step(*a):
        return EM.ensemble_retrieval_step(
            idx, *a, k=K, k_out=K, p_cap=CAP, sparse_mode="q8r", sparse_candidates=CAND,
            dense_rescore_pool=POOL, sparse_presorted=True)
    return step, (*inputs, q, proj, tf)


@pytest.fixture(scope="module")
def q8r_cpu():
    return _q8r_kit(torch.device("cpu"))


def _children(kept, parent):
    return [s.name for s in sorted(kept, key=lambda s: s.start_ns) if s.parent == parent]


def test_q8r_step_rescore_spans_and_counter(q8r_cpu):
    """Each sparse view's pool rescore runs in sparse.rescore inside its
    sparse_view; the dense pool's in dense.rescore beside dense_view and
    apart from the two rerank views; the outputs are the same bits with
    tracing on and off."""
    step, inputs = q8r_cpu
    off = step(*inputs)
    T.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        on = step(*inputs)
    kept = T.spans()
    assert _children(kept, "ensemble_step") == [
        "sparse_view", "sparse_view", "dense_view", "dense.rescore", "rerank", "qpp",
        "qpp_norm", "fusion"]
    assert _children(kept, "sparse_view") == ["sparse.keys", "sparse.row_sums", "sparse.topk",
                                              "sparse.rescore"] * 2
    assert _children(kept, "dense.rescore") == []
    for a, b in zip(on, off):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_dense_pool_rescore_is_the_rerank_scoring(q8r_cpu):
    """dense_pool_rescore scores a pool as rerank_candidates does, bit for
    bit, on bf16 rows and on int8 rows with their scales."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((500, D), np.float32))
    rows, scale = quantize_rows(x)
    scale = scale.reshape(-1)
    q = torch.from_numpy(rng.standard_normal((B, D), np.float32))
    cand = torch.from_numpy(rng.integers(-1, 500, (B, POOL)))
    for r in (x.to(torch.bfloat16), rows):
        got = EM.dense_pool_rescore(q, cand, r, scale)
        want = EM.rerank_candidates(q, cand, r, scale)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_q8r_step_on_the_card_never_waits_for_the_device():
    """Up to the answers' copy a q8r step with a dense pool makes no call
    that waits for the device, and it gives the CPU's fused ids."""
    dev = _device("cuda")
    step, inputs = _q8r_kit(dev)
    step(*inputs)                       # the kernel build and the presorted cap's read
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = step(*inputs)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert all(o.is_cuda for o in out)
    cpu_step, cpu_inputs = _q8r_kit(torch.device("cpu"))
    ref = cpu_step(*cpu_inputs)
    _assert_same_ranking_up_to_near_ties(out[0].cpu(), out[1].cpu(), ref[0], ref[1])


def _assert_same_ranking_up_to_near_ties(ids, scores, ref_ids, ref_scores, band=1e-4):
    """Rank by rank the same fused scores within band x the query's top, and
    the same ids wherever the reference's score at that rank lies more than
    the band from both its neighbours' (the last rank's follower is not
    returned, so its id may differ). The card's f32 sums run in another
    order than the CPU's, which may swap near-tied docs."""
    top = ref_scores[:, :1].abs().clamp_min(1e-30)
    gap = ((scores - ref_scores).abs() / top).max().item()
    assert gap <= band, gap
    tie = (ref_scores[:, 1:] - ref_scores[:, :-1]).abs() <= band * top
    near = torch.zeros_like(ref_ids, dtype=torch.bool)
    near[:, 1:] |= tie
    near[:, :-1] |= tie
    near[:, -1] = True
    assert torch.equal(ids[~near], ref_ids[~near]), (ids != ref_ids).nonzero().tolist()
    assert near[:, :-1].float().mean() < 0.5
