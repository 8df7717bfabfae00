"""Port parity, K6: the plain PyTorch version of the doc-vector rescore
match (qpp_fusion_rag_tpu_torch.ops.kernels.row_gather) against the JAX
package's rescore_match_pallas (interpret mode) and _exact_rescore_scores.
The f32 row sums agree to rtol 4e-6: at most Tq non-zero, non-negative
terms are summed, in another order than XLA's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qpp_fusion_rag_tpu.ops import sparse as JSP
from qpp_fusion_rag_tpu.ops.pallas.row_gather import pad_doc_rows, rescore_match_pallas
from qpp_fusion_rag_tpu_torch.ops import sparse as TSP
from qpp_fusion_rag_tpu_torch.ops.kernels import row_gather


def _rescore_inputs(Td, imp_bits, seed, B=8, C=128, N=3000, T=700, Tq=8):
    """Doc rows that hold the query's terms often (with sentinel pads),
    candidates with -1 pads, query terms with repeats and -1 pads."""
    rng = np.random.default_rng(seed)
    sentinel = ((1 << (31 - imp_bits)) - 1) << imp_bits
    terms = rng.integers(0, T, (N, Td))
    doc = ((terms << imp_bits) | rng.integers(0, 1 << imp_bits, (N, Td))).astype(np.int64)
    doc[rng.random((N, Td)) < 0.3] = sentinel
    qt = rng.integers(0, T, (B, Tq)).astype(np.int32)
    qt[:, 1] = qt[:, 0]                       # a repeated query term
    qt[0, -2:] = -1
    qw = rng.uniform(0.1, 4.0, (B, Tq)).astype(np.float32)
    cand = rng.integers(0, N, (B, C)).astype(np.int32)
    for b in range(B):
        for c in range(C):
            cols = rng.choice(Td, min(Tq, Td), replace=False)
            doc[cand[b, c], cols] = ((qt[b, :len(cols)].clip(0) << imp_bits)
                                     | rng.integers(0, 1 << imp_bits, len(cols)))
    cand[1, -5:] = -1
    return doc.astype(np.int32), cand, qt, qw


def test_k6_plain_matches_pallas():
    """One grid step of the Pallas kernel (its interpret mode costs ~20 s
    per call, whatever the size), at the bench's imp_bits."""
    imp_bits = 14
    doc, cand, qt, qw = _rescore_inputs(128, imp_bits, seed=imp_bits, C=16)  # 1 grid step
    ref = np.asarray(rescore_match_pallas(
        jnp.asarray(pad_doc_rows(doc, imp_bits)), jnp.asarray(cand), jnp.asarray(qt),
        jnp.asarray(qw), imp_bits=imp_bits))
    out = row_gather.rescore_match(*map(torch.as_tensor, (doc, cand, qt, qw)), imp_bits)
    assert out.dtype == torch.float32 and out.shape == cand.shape
    assert (ref[cand >= 0] > 0).mean() > 0.9     # the rows really match the queries
    np.testing.assert_allclose(out.numpy(), ref, rtol=4e-6, atol=0)


@pytest.mark.parametrize("Td,sort_ids,imp_bits", [
    (128, False, 14), (128, True, 8), (37, False, 8), (37, True, 14)])
def test_k6_exact_rescore_scores_match_jax(Td, sort_ids, imp_bits):
    """The port's _exact_rescore_scores (K6's plain version, doc_scale, the
    -1 mask) against JAX's."""
    doc, cand, qt, qw = _rescore_inputs(Td, imp_bits, seed=Td + sort_ids + imp_bits)
    rng = np.random.default_rng(1)
    doc_scale = rng.uniform(0.01, 2.0, doc.shape[0]).astype(np.float32)
    j_ids, j_s = map(np.asarray, JSP._exact_rescore_scores(
        jnp.asarray(cand), jnp.asarray(doc), jnp.asarray(doc_scale), jnp.asarray(qt),
        jnp.asarray(qw), imp_bits=imp_bits, sort_ids=sort_ids))
    t_ids, t_s = TSP._exact_rescore_scores(
        *map(torch.as_tensor, (cand, doc, doc_scale, qt, qw)), imp_bits=imp_bits,
        sort_ids=sort_ids)
    np.testing.assert_array_equal(t_ids.numpy(), j_ids)
    assert np.isneginf(t_s.numpy()[j_ids < 0]).all() and (j_ids < 0).any()
    np.testing.assert_allclose(t_s.numpy(), j_s, rtol=4e-6, atol=0)


def test_k6_refuses_bad_inputs():
    doc = torch.zeros((10, 8), dtype=torch.int32)
    ids = torch.zeros((2, 3), dtype=torch.int32)
    qt = torch.zeros((2, 4), dtype=torch.int32)
    qw = torch.ones((2, 4))
    with pytest.raises(ValueError, match="cand_ids"):
        row_gather.rescore_match(doc, ids.long(), qt, qw, 8)
    with pytest.raises(ValueError, match="q_weights"):
        row_gather.rescore_match(doc, ids, qt, qw[:, :3].contiguous(), 8)
    with pytest.raises(ValueError, match="imp_bits"):
        row_gather.rescore_match(doc, ids, qt, qw, 31)
    with pytest.raises(ValueError, match="share a device"):
        row_gather.rescore_match(doc, ids, qt, qw.to("meta"), 8)
