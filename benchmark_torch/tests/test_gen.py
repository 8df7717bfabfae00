"""The card's posting generator against the port's host generator at a
small size (their random streams differ, so shapes are compared), and the
p_cap cut against the program's packer on the full lists."""

import numpy as np
import torch

from benchmark_torch.harness import gen as G
from qpp_fusion_rag_tpu_torch.data import synthetic as S
from qpp_fusion_rag_tpu_torch.ops.sparse import pack_postings_presorted, term_scales_from_csr

N, V, AVG, A, SIGMA = 20_000, 2_000, 30.0, 0.9874, 0.3957


def _torch_csr(seed=5):
    return G.zipf_csr(N, V, AVG, A, SIGMA, 0.9, 0.4, G.generator("cpu", seed, "bm25"), "cpu")


def test_shape_matches_the_host_generator():
    off, docs, w, lens = S.zipf_bm25_csr(N, vocab_size=V, avg_doc_len=AVG, zipf_a=A,
                                         lognormal_sigma=SIGMA, seed=5)
    c = _torch_csr()
    df_np = np.diff(off)
    df_t = c["df"].numpy()
    assert abs(len(docs) / c["docs"].numel() - 1) < 0.02            # postings
    assert abs(np.bincount(docs, minlength=N).mean()                 # doc length mean
               / np.bincount(c["docs"].numpy(), minlength=N).mean() - 1) < 0.02
    for r in (1, 10, 100, 1000):                                     # the df curve
        assert abs(np.log(df_np[r - 1] + 1) - np.log(df_t[r - 1] + 1)) < 0.35, r
    wt = c["weights"].numpy()
    for q in (0.01, 0.5, 0.99):                                      # impact range
        assert abs(np.quantile(w, q) / np.quantile(wt, q) - 1) < 0.05, q
    assert abs(w.max() / wt.max() - 1) < 0.1


def test_lists_are_impact_ordered_with_ties_by_doc():
    c = _torch_csr()
    off, docs, w = c["offsets"].numpy(), c["docs"].numpy(), c["weights"].numpy()
    for t in range(0, V, 97):
        a, b = off[t], off[t + 1]
        order = np.lexsort((docs[a:b], -w[a:b]))
        assert (order == np.arange(b - a)).all(), t


def test_cut_lists_pack_as_the_full_lists():
    c = _torch_csr()
    cut = G.truncate_csr(c, 64)
    full = [x.numpy() for x in (c["docs"], c["weights"], c["offsets"])]
    part = [x.numpy() for x in (cut["docs"], cut["weights"], cut["offsets"])]
    a = pack_postings_presorted(*full, cap=64)
    b = pack_postings_presorted(*part, cap=64, scales=term_scales_from_csr(part[1], part[2]))
    for x, y in zip(a, b):
        assert np.array_equal(x, y)


def test_same_seed_same_data_and_large_seeds():
    s = 2**31 + 12345
    a = G.zipf_csr(3000, 500, AVG, A, SIGMA, 0.9, 0.4, G.generator("cpu", s, "x"), "cpu")
    b = G.zipf_csr(3000, 500, AVG, A, SIGMA, 0.9, 0.4, G.generator("cpu", s, "x"), "cpu")
    assert torch.equal(a["docs"], b["docs"]) and torch.equal(a["weights"], b["weights"])
    assert G.sub_seed(s, "x") != G.sub_seed(s + 1, "x") != G.sub_seed(s, "y")
    q1 = G.zipf_queries(a["df"].numpy(), 8, 4, np.random.default_rng(G.sub_seed(s, "q")))
    q2 = G.zipf_queries(a["df"].numpy(), 8, 4, np.random.default_rng(G.sub_seed(s, "q")))
    assert np.array_equal(q1, q2) and q1.dtype == np.int32
