"""The port's CUDA kernels (K1-K10) against their plain PyTorch versions on
an NVIDIA GPU, at small shapes, plus the launch counters and the wrappers'
refusals.

K1, K7, K8, K9 and K10 share one TMA + wgmma main loop
(csrc/dense_wgmma.cuh); K8 and K10 are one kernel there, K10 being K8 at
stride 1 over a corpus padded to a multiple of 16,384 docs. The dense bf16
kernels (K7, K8, K10) are held bit-equal to their plain versions on
integer-valued inputs (every f32 partial sum is then exact in any order),
ties, ragged N and zero scores included; on random inputs only
the summation order differs, and the tolerance is the one of
tests/test_torch_dense.py (2^-15 relative + 1e-6 of the |q|.|c| bound; a
lane or argmax may differ only between docs whose float64 scores lie
within it). K9 is integer arithmetic and is compared bit for bit.

These need the card: each test skips when torch.cuda.is_available() is
False. The file imports neither jax nor the JAX package, so it runs on a
machine with only torch; there run it without the repository's conftest
(which sets up JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from qpp_fusion_rag_tpu_torch.ops.kernels import (
    LAUNCHES,
    bitonic,
    dense_topk,
    row_gather,
    streaming_topk,
    window_gather,
)

pytestmark = pytest.mark.cuda
INT32_MIN, INT32_MAX = -(2**31), 2**31 - 1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    assert not torch.backends.cuda.matmul.allow_tf32
    return torch.device("cuda")


def _counted(kernel, fn):
    before = dict(LAUNCHES)
    out = fn()
    torch.cuda.synchronize()
    assert LAUNCHES[kernel] == before.get(kernel, 0) + 1
    assert sum(LAUNCHES.values()) == sum(before.values()) + 1
    return out


# ---------------------------------------------------------------- K3 ------

@pytest.mark.parametrize("P,cap,offset", [(100_000, 2048, 0), (100_000, 2048, 1),
                                           (50_003, 37, 0), (4096, 4096, 0)])
def test_k3_matches_plain(cuda, P, cap, offset):
    rng = np.random.default_rng(P + cap)
    base = torch.as_tensor(rng.integers(-2**31, 2**31 - 1, P + offset,
                                        dtype=np.int64).astype(np.int32))
    src = base[offset:]     # offset 1: a view 4 bytes past a 16-byte boundary
    starts = rng.integers(0, P - cap + 1, 300).astype(np.int32)
    starts[:4] = np.clip([0, 1, P - cap, P - cap - 3], 0, P - cap)
    st = torch.as_tensor(starts)
    src_d = base.to(cuda)[offset:]
    out = _counted("gather_windows", lambda: window_gather.gather_windows(src_d, st.to(cuda), cap))
    ref = window_gather.gather_windows_plain(src, st, cap)
    assert torch.equal(out.cpu(), ref)


# ---------------------------------------------------------------- K2 ------

def _keys(B, M, cap, rng):
    """Presorted alternating cap-blocks (start_block 2*cap) with both pads."""
    tq = M // cap
    keys = np.empty((B, tq, cap), np.int64)
    for b in range(B):
        for t in range(tq):
            n = int(rng.integers(0, cap + 1))
            d = np.sort(rng.choice(1 << 20, n, replace=False)).astype(np.int64)
            w = (d << 8) | rng.integers(0, 256, n)
            pad = INT32_MIN if t % 2 else INT32_MAX
            keys[b, t] = np.concatenate([w[::-1] if t % 2 else w, np.full(cap - n, pad)])
    return keys.reshape(B, M).astype(np.int32)


@pytest.mark.parametrize("B,M,cap,plus_one", [
    (8, 1024, 128, False), (8, 2048, 128, True), (4, 16384, 2048, False),
    (2, 32768, 2048, True), (3, 12288, 2048, False)])
def test_k2_presorted_matches_plain(cuda, B, M, cap, plus_one):
    rng = np.random.default_rng(M)
    keys = torch.as_tensor(_keys(B, M, cap, rng))
    sums, sids = _counted("bitonic_segsum_rows", lambda: bitonic.bitonic_segsum_rows(
        keys.to(cuda), start_block=2 * cap, plus_one=plus_one, max_run=M // cap))
    r_sums, r_sids = bitonic.bitonic_segsum_rows_plain(keys, plus_one)
    assert torch.equal(sids.cpu(), r_sids)
    assert torch.equal(sums.cpu(), r_sums)       # exact everywhere, pads included


@pytest.mark.parametrize("B,M", [
    (8, 1024), (5, 1000), (2, 32768), (1, 3),
    # just below and above each CTA size of the register network (32 keys a
    # thread): rows up to 1024 keys take 32 threads, 1025-2048 take 64, ...,
    # 8193-16384 take 512, 16385-32768 a cluster of two CTAs of 512
    (3, 1023), (3, 1025), (3, 2047), (3, 2049), (2, 4095), (2, 4097), (2, 8191), (2, 8193),
    (2, 16383), (2, 16385), (2, 32767)])
def test_k2_random_rows_match_plain(cuda, B, M):
    """Unsorted rows (start_block 2) with long pad runs and repeated docs,
    including row lengths that are no power of two."""
    rng = np.random.default_rng(M + 1)
    keys = ((rng.integers(0, 300, (B, M)) << 8) | rng.integers(0, 256, (B, M)))
    keys[:, : M // 5] = INT32_MAX
    keys[:, -(M // 7):] = INT32_MIN
    keys = torch.as_tensor(keys.astype(np.int32))
    sums, sids = _counted("bitonic_segsum_rows", lambda: bitonic.bitonic_segsum_rows(keys.to(cuda)))
    r_sums, r_sids = bitonic.bitonic_segsum_rows_plain(keys)
    assert torch.equal(sids.cpu(), r_sids)
    assert torch.equal(sums.cpu(), r_sums)


def _pattern(name, B, M, rng):
    """Rows that break register layouts: every key equal, every key -1, fewer
    run keys than a top-bs block (300), strictly descending, both pad
    sentinels."""
    if name == "equal":
        return torch.full((B, M), (5 << 16) | 7, dtype=torch.int32)
    if name == "minus_one":
        return torch.full((B, M), -1, dtype=torch.int32)
    if name == "few_runs":
        keys = np.full((B, M), -1, np.int64)
        for b in range(B):
            pos = rng.choice(M, 300, replace=False)
            keys[b, pos] = (rng.integers(0, 60, 300) << 16) | pos
        return torch.as_tensor(keys.astype(np.int32))
    if name == "descending":
        return torch.as_tensor((np.arange(M, 0, -1)[None] * 1000 + np.arange(B)[:, None])
                               .astype(np.int32))
    assert name == "pads"
    return torch.as_tensor(np.where(rng.random((B, M)) < 0.5, INT32_MIN, INT32_MAX)
                           .astype(np.int32))


PATTERNS = ("equal", "minus_one", "few_runs", "descending", "pads")


@pytest.mark.parametrize("M", [16384, 40000])
@pytest.mark.parametrize("pattern", PATTERNS)
def test_k2_register_layout_cases_match_plain(cuda, pattern, M):
    """16,384 keys: one CTA; 40,000: a cluster of four, where one run
    ("equal", "minus_one") spans every part."""
    keys = _pattern(pattern, 2, M, np.random.default_rng(M))
    sums, sids = _counted("bitonic_segsum_rows", lambda: bitonic.bitonic_segsum_rows(keys.to(cuda)))
    r_sums, r_sids = bitonic.bitonic_segsum_rows_plain(keys)
    assert torch.equal(sids.cpu(), r_sids)
    assert torch.equal(sums.cpu(), r_sums)


def test_k2_refuses_rows_beyond_shared_memory(cuda):
    with pytest.raises(ValueError, match="torch.sort"):
        bitonic.bitonic_segsum_rows(torch.zeros((1, 65537), dtype=torch.int32, device=cuda))


@pytest.mark.parametrize("B,M,start_block,plus_one", [
    (3, 65536, 4096, False), (2, 65536, 4096, True), (3, 65536, 2, False),
    (3, 40000, 2, True), (2, 32769, 2, False)])
def test_k2_two_cta_rows_match_plain(cuda, B, M, start_block, plus_one):
    """Rows of more than 16,384 keys: a cluster of CTAs per row (two up to
    32,768 keys, four above). Runs straddle the parts (docs drawn from a few
    hundred ids, so every run is ~100 keys long), pads of both kinds
    included."""
    rng = np.random.default_rng(M + start_block)
    if start_block > 2:
        keys = _keys(B, M, start_block // 2, rng)
    else:
        keys = ((rng.integers(0, 600, (B, M)) << 8) | rng.integers(0, 256, (B, M)))
        keys[:, : M // 9] = INT32_MIN
        keys = keys.astype(np.int32)
    keys = torch.as_tensor(keys)
    sums, sids = _counted("bitonic_segsum_rows", lambda: bitonic.bitonic_segsum_rows(
        keys.to(cuda), start_block=start_block, plus_one=plus_one))
    r_sums, r_sids = bitonic.bitonic_segsum_rows_plain(keys, plus_one)
    assert torch.equal(sids.cpu(), r_sids)
    assert torch.equal(sums.cpu(), r_sums)


def test_k2_one_run_across_both_halves(cuda):
    """One doc over the whole row: each part's carry is the sum of every
    key in the parts below it (four parts of 16,384 keys)."""
    rng = np.random.default_rng(5)
    keys = torch.as_tensor(((7 << 8) | rng.integers(0, 256, (2, 65536))).astype(np.int32))
    sums, sids = bitonic.bitonic_segsum_rows(keys.to(cuda))
    r_sums, r_sids = bitonic.bitonic_segsum_rows_plain(keys)
    assert torch.equal(sids.cpu(), r_sids)
    assert torch.equal(sums.cpu(), r_sums)
    assert int(sums[0, -1]) == int(keys[0].bitwise_and(0xFF).sum())


HOTPOT_DOCS = 5_233_329     # BEIR HotpotQA's passages: ids past 2^22, int8 rows past 2^31 bytes


def _window_keys(B, tq, cap, lo, hi, gen, device):
    """[B, tq * cap] presorted q8 keys as the q8 step forms them: per window
    up to cap postings of doc ids in [lo, hi) (doc << 8 | q8), ascending
    with an INT32_MAX pad in even slots, descending with an INT32_MIN pad
    in odd ones."""
    docs = torch.randint(lo, hi, (B, tq, cap), generator=gen, device=device, dtype=torch.int64)
    q8 = torch.randint(0, 256, (B, tq, cap), generator=gen, device=device, dtype=torch.int64)
    n = torch.randint(0, cap + 1, (B, tq, 1), generator=gen, device=device)
    real = torch.arange(cap, device=device) < n
    odd = (torch.arange(tq, device=device) % 2 == 1)[None, :, None]
    pad = torch.where(odd, INT32_MIN, INT32_MAX)
    keys = torch.where(real, (docs << 8) | q8, pad)
    asc = torch.sort(keys, dim=-1).values
    desc = torch.sort(keys, dim=-1, descending=True).values
    return torch.where(odd, desc, asc).to(torch.int32).reshape(B, tq * cap).contiguous()


@pytest.mark.parametrize("tq,ctas", [(16, 2), (32, 4)])
def test_k2_hotpotqa_rows_with_ids_past_2_22_match_plain(cuda, tq, ctas):
    """K2 at the HotpotQA cell's shapes: 1024 rows of 16 or 32 presorted
    windows of 2048 keys (32,768 and 65,536 keys: clusters of two and four
    CTAs), doc ids in [2^22, 5,233,329), so bit 30 of every real key is
    set, just under the sign bit and the 0x7FFFFF pad id. Half the rows
    draw from the last 3,000 ids, so that runs are long and cross the
    cluster's parts. Bit-equal to the plain version."""
    from qpp_fusion_rag_tpu_torch.tracing import K2_CLUSTERS

    g = torch.Generator(device=cuda).manual_seed(tq)
    wide = _window_keys(512, tq, 2048, 1 << 22, HOTPOT_DOCS, g, cuda)
    narrow = _window_keys(512, tq, 2048, HOTPOT_DOCS - 3000, HOTPOT_DOCS, g, cuda)
    keys = torch.cat([wide, narrow])
    real = (keys != INT32_MAX) & (keys != INT32_MIN)
    assert bool(((keys >> 30) == 1)[real].all())
    before = K2_CLUSTERS[ctas]
    sums, sids = _counted("bitonic_segsum_rows", lambda: bitonic.bitonic_segsum_rows(
        keys, start_block=4096, max_run=tq))
    assert K2_CLUSTERS[ctas] == before + 1
    r_sums, r_sids = bitonic.bitonic_segsum_rows_plain(keys)
    assert torch.equal(sids, r_sids)
    assert torch.equal(sums, r_sums)
    assert int(sids[sids < 0x7FFFFF].max()) == HOTPOT_DOCS - 1


def test_q8_rows_beyond_65536_keys_take_the_sort_route(cuda):
    """sparse_score_topk_q8 at M = 32 x 2048 = 65,536 launches K2; at
    M = 64 x 2048 = 131,072 it launches no K2 (torch.sort + segmented sums).
    Both equal the CPU run."""
    from qpp_fusion_rag_tpu_torch.data.synthetic import zipf_bm25_csr, zipf_queries
    from qpp_fusion_rag_tpu_torch.ops import sparse

    bo, bd, bw, _ = zipf_bm25_csr(8000, vocab_size=400, avg_doc_len=60.0, seed=9)
    packed, offsets, scales = sparse.pack_postings_presorted(bd, bw, bo, cap=2048)
    for tq, k2 in ((32, 1), (64, 0)):
        qt, qw = zipf_queries(bo, 4, n_terms=tq, seed=tq)
        args = [torch.as_tensor(x) for x in (packed, offsets.astype(np.int32), scales, qt, qw)]
        before = LAUNCHES["bitonic_segsum_rows"]
        got = sparse.sparse_score_topk_q8(*[a.to(cuda) for a in args], k=100, p_cap=2048,
                                          presorted=True)
        torch.cuda.synchronize()
        assert LAUNCHES["bitonic_segsum_rows"] - before == k2
        ref = sparse.sparse_score_topk_q8(*args, k=100, p_cap=2048, presorted=True)
        assert all(torch.equal(a.cpu(), b) for a, b in zip(got, ref))


# ------------------------------------------------------------ K4, K5 ------

def _pool_keys(B, M, rng):
    """(sum << 16 | position) keys with many -1 and tied sums."""
    sums = rng.integers(0, 60, (B, M))
    sums[rng.random((B, M)) < 0.6] = -1
    return torch.as_tensor(np.where(sums >= 0, (sums << 16) | np.arange(M), -1)
                           .astype(np.int32))


@pytest.mark.parametrize("B,M", [(8, 1024), (6, 16384), (4, 32768), (5, 3000), (3, 1), (2, 2)])
def test_k5_matches_plain(cuda, B, M):
    keys = _pool_keys(B, M, np.random.default_rng(M))
    out = _counted("bitonic_sort_rows", lambda: bitonic.bitonic_sort_rows(keys.to(cuda)))
    assert torch.equal(out.cpu(), bitonic.bitonic_sort_rows_plain(keys))


@pytest.mark.parametrize("M", [1, 1000, 16384, 32768, 65536])
@pytest.mark.parametrize("pattern", ["random", "equal", "extremes"])
def test_k5_register_network_matches_torch_sort(cuda, M, pattern):
    """The register network's row sizes (one CTA up to 16,384 keys, clusters
    of 2 and 4 above), bit-equal to torch.sort: random keys over the whole
    int32 range, all-equal rows, and rows of INT32_MIN / INT32_MAX with a
    few keys between."""
    rng = np.random.default_rng(M + len(pattern))
    B = 3
    if pattern == "random":
        keys = rng.integers(INT32_MIN, INT32_MAX, (B, M), endpoint=True)
    elif pattern == "equal":
        keys = np.full((B, M), 12345)
    else:
        keys = np.where(rng.random((B, M)) < 0.5, INT32_MIN, INT32_MAX)
        keys[:, ::97] = rng.integers(-5, 5, keys[:, ::97].shape)
    keys = torch.as_tensor(keys.astype(np.int32))
    out = _counted("bitonic_sort_rows", lambda: bitonic.bitonic_sort_rows(keys.to(cuda)))
    assert torch.equal(out.cpu(), torch.sort(keys, dim=-1).values)


@pytest.mark.parametrize("M,cap", [(16384, 2048), (4096, 256), (32768, 4096), (16384, 8192)])
def test_k5_presorted_blocks_match_plain(cuda, M, cap):
    keys = torch.as_tensor(_keys(4, M, cap, np.random.default_rng(M + cap)))
    out = _counted("bitonic_sort_rows", lambda: bitonic.bitonic_sort_rows(
        keys.to(cuda), start_block=2 * cap))
    assert torch.equal(out.cpu(), bitonic.bitonic_sort_rows_plain(keys))


@pytest.mark.parametrize("B,M,bs", [
    (8, 2048, 1024), (6, 16384, 1024), (4, 32768, 1024), (3, 32768, 4096), (5, 5000, 2048),
    (2, 16384, 8192),
    # the warp route's warps per row double at 16, 32 and 64 bs-blocks: just
    # below and above, and rows that are no multiple of 4 (scalar loads)
    (3, 16383, 1024), (3, 16385, 1024), (3, 15359, 1024), (2, 32767, 2048), (2, 32769, 2048),
    (2, 4099, 2048)])
def test_k4_matches_plain(cuda, B, M, bs):
    keys = _pool_keys(B, M, np.random.default_rng(M + bs))
    out = _counted("bitonic_topp_rows", lambda: bitonic.bitonic_topp_rows(
        keys.to(cuda), bs=bs))
    assert torch.equal(out.cpu(), bitonic.bitonic_topp_rows_plain(keys, bs))


@pytest.mark.parametrize("bs", [1024, 2048, 4096])
@pytest.mark.parametrize("pattern", PATTERNS)
def test_k4_register_layout_cases_match_plain(cuda, pattern, bs):
    """bs 1024 and 2048 take the warp route, 4096 the shared-memory one."""
    keys = _pattern(pattern, 3, 16384, np.random.default_rng(bs))
    out = _counted("bitonic_topp_rows", lambda: bitonic.bitonic_topp_rows(keys.to(cuda), bs=bs))
    assert torch.equal(out.cpu(), bitonic.bitonic_topp_rows_plain(keys, bs))


def test_k4_row_four_bytes_past_alignment_matches_plain(cuda):
    """A [B, M] view 4 bytes past a 16-byte boundary with M % 4 == 0: the warp
    route must not take its 16-byte loads."""
    keys = _pool_keys(1, 3 * 4096 + 1, np.random.default_rng(3)).reshape(-1)
    base = keys.to(cuda)
    view = base[1:].view(3, 4096)
    out = _counted("bitonic_topp_rows", lambda: bitonic.bitonic_topp_rows(view, bs=1024))
    assert torch.equal(out.cpu(), bitonic.bitonic_topp_rows_plain(keys[1:].view(3, 4096), 1024))


def test_k4_k5_refuse_rows_beyond_shared_memory(cuda):
    keys = torch.zeros((1, 65537), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="torch.sort"):
        bitonic.bitonic_sort_rows(keys)
    with pytest.raises(ValueError, match="torch.sort"):
        bitonic.bitonic_topp_rows(keys, bs=1024)


@pytest.mark.parametrize("B,M", [(3, 65536), (4, 40000), (2, 32769)])
def test_k5_two_cta_rows_match_plain(cuda, B, M):
    keys = _pool_keys(B, M, np.random.default_rng(M + 7))
    out = _counted("bitonic_sort_rows", lambda: bitonic.bitonic_sort_rows(keys.to(cuda)))
    assert torch.equal(out.cpu(), bitonic.bitonic_sort_rows_plain(keys))


@pytest.mark.parametrize("cap", [2048, 32768])
def test_k5_two_cta_presorted_blocks_match_plain(cuda, cap):
    """start_block 4096, and 65,536: two presorted halves go straight to the
    cross-CTA stage."""
    keys = torch.as_tensor(_keys(2, 65536, cap, np.random.default_rng(cap)))
    out = _counted("bitonic_sort_rows", lambda: bitonic.bitonic_sort_rows(
        keys.to(cuda), start_block=2 * cap))
    assert torch.equal(out.cpu(), bitonic.bitonic_sort_rows_plain(keys))


@pytest.mark.parametrize("B,M,bs", [(3, 65536, 1024), (2, 65536, 32768), (3, 65536, 4096),
                                    (4, 40000, 16384), (2, 40000, 2048), (2, 32769, 1024)])
def test_k4_two_cta_rows_match_plain(cuda, B, M, bs):
    keys = _pool_keys(B, M, np.random.default_rng(M + bs + 1))
    out = _counted("bitonic_topp_rows", lambda: bitonic.bitonic_topp_rows(keys.to(cuda), bs=bs))
    assert torch.equal(out.cpu(), bitonic.bitonic_topp_rows_plain(keys, bs))


def test_k4_two_cta_presorted_matches_plain(cuda):
    keys = torch.as_tensor(_keys(2, 65536, 2048, np.random.default_rng(11)))
    out = _counted("bitonic_topp_rows", lambda: bitonic.bitonic_topp_rows(
        keys.to(cuda), bs=2048, start_block=4096))
    assert torch.equal(out.cpu(), bitonic.bitonic_topp_rows_plain(keys, 2048))


# ---------------------------------------------------------------- K6 ------

def _rescore_inputs(N, Td, B, C, Tq, imp_bits, seed):
    """Rows that hold the query's terms for every other candidate, query
    terms with a repeat and a pad, ids of -1 and >= N (clamped)."""
    rng = np.random.default_rng(seed)
    T = 500
    doc = (rng.integers(0, T, (N, Td)) << imp_bits) | rng.integers(0, 1 << imp_bits, (N, Td))
    qt = rng.integers(0, T, (B, Tq))
    if Tq > 1:
        qt[:, 1] = qt[:, 0]
        qt[0, -1] = -1
    ids = rng.integers(0, N, (B, C))
    for b in range(B):
        for c in range(0, C, 2):
            cols = rng.choice(Td, min(Tq, Td), replace=False)
            doc[ids[b, c], cols] = (qt[b, :len(cols)].clip(0) << imp_bits) | 7
    ids[0, :3] = -1
    ids[-1, -2:] = [N, N + 7]
    return (torch.as_tensor(doc.astype(np.int32)), torch.as_tensor(ids.astype(np.int32)),
            torch.as_tensor(qt.astype(np.int32)),
            torch.as_tensor(rng.uniform(0.1, 3.0, (B, Tq)).astype(np.float32)))


@pytest.mark.parametrize("N,Td,B,C,Tq,imp_bits", [
    (20_000, 128, 64, 256, 8, 14), (20_000, 128, 16, 256, 16, 14),
    (5000, 37, 8, 100, 8, 12), (5000, 256, 4, 33, 4, 8), (3000, 130, 3, 7, 16, 14)])
def test_k6_matches_plain(cuda, N, Td, B, C, Tq, imp_bits):
    doc, ids, qt, qw = _rescore_inputs(N, Td, B, C, Tq, imp_bits, seed=N + Td + C)
    out = _counted("rescore_match", lambda: row_gather.rescore_match(
        doc.to(cuda), ids.to(cuda), qt.to(cuda), qw.to(cuda), imp_bits))
    ref = row_gather.rescore_match_plain(doc, ids, qt, qw, imp_bits)
    assert (ref > 0).float().mean() > 0.4
    torch.testing.assert_close(out.cpu(), ref, rtol=4e-6, atol=0)


@pytest.mark.parametrize("Tq", [1, 8, 16, 17, 32, 40])
@pytest.mark.parametrize("imp_bits", [8, 14])
@pytest.mark.parametrize("Td,C,aligned", [(128, 203, True), (96, 77, True), (96, 77, False),
                                          (130, 41, True), (520, 19, True)])
def test_k6_routes_and_query_buckets_match_plain(cuda, Td, C, aligned, Tq, imp_bits):
    """Both routes of the kernel (Td 128, 96 and 520 in an aligned table:
    16-byte loads, 520 over five chunks; Td 96 four bytes past alignment and
    Td 130: 4-byte loads) with C no multiple of a CTA's 64 candidates, and
    every query bucket (Tq 1 and 8: 8 terms in registers, 16, 17 and 32,
    40: the loop over global memory), repeats and pads included."""
    doc, ids, qt, qw = _rescore_inputs(3000, Td, 5, C, Tq, imp_bits, seed=Td * C + Tq + imp_bits)
    base = torch.zeros(doc.numel() + 4, dtype=torch.int32, device=cuda)
    table = base[(0 if aligned else 1):][:doc.numel()].view(doc.shape)
    table.copy_(doc.to(cuda))
    assert row_gather.vec_loads(table) == (aligned and Td % 4 == 0)
    out = _counted("rescore_match", lambda: row_gather.rescore_match(
        table, ids.to(cuda), qt.to(cuda), qw.to(cuda), imp_bits))
    ref = row_gather.rescore_match_plain(doc, ids, qt, qw, imp_bits)
    assert (ref > 0).any()
    torch.testing.assert_close(out.cpu(), ref, rtol=4e-6, atol=0)


@pytest.mark.parametrize("Tq", [8, 16, 32, 40])
@pytest.mark.parametrize("Td,C,aligned", [(128, 203, True), (96, 77, False), (130, 41, True)])
def test_k6_matched_output_matches_plain(cuda, Td, C, aligned, Tq):
    """The instance with the matched-weight output (the certified scorer's
    unmatched mass): both outputs against the plain version within rtol
    4e-6 (only the order of the row sums differs), on both load routes
    (Td 128: 16-byte loads; Td 96 four bytes past alignment and Td 130:
    4-byte loads), C no multiple of 64, every query bucket (Tq 8, 16, 32
    and 40: the loop), repeated terms and an all-pad query. Its sums equal
    the instance without the output bit for bit where both take the same
    load route; over 32 terms it takes the 4-byte loads whatever the table
    (its 16-byte route spilled), so the order of a row's sum differs there."""
    doc, ids, qt, qw = _rescore_inputs(3000, Td, 5, C, Tq, 14, seed=Td * C + Tq + 1)
    qt[2] = -1                                   # a query of pads only
    base = torch.zeros(doc.numel() + 4, dtype=torch.int32, device=cuda)
    table = base[(0 if aligned else 1):][:doc.numel()].view(doc.shape)
    table.copy_(doc.to(cuda))
    args = (table, ids.to(cuda), qt.to(cuda), qw.to(cuda), 14)
    out, matched = _counted("rescore_match", lambda: row_gather.rescore_match(
        *args, return_matched=True))
    ref, ref_m = row_gather.rescore_match_plain(doc, ids, qt, qw, 14, return_matched=True)
    torch.testing.assert_close(out.cpu(), ref, rtol=4e-6, atol=0)
    torch.testing.assert_close(matched.cpu(), ref_m, rtol=4e-6, atol=0)
    assert (ref_m[2] == 0).all() and (ref_m > 0).float().mean() > 0.3
    alone = row_gather.rescore_match(*args)
    if Tq <= 32 or not row_gather.vec_loads(table):
        assert torch.equal(alone, out)
    else:
        torch.testing.assert_close(alone, out, rtol=4e-6, atol=0)


def test_k6_unaligned_table_takes_scalar_loads(cuda):
    doc, ids, qt, qw = _rescore_inputs(4000, 128, 4, 64, 8, 14, seed=1)
    base = torch.zeros(doc.numel() + 1, dtype=torch.int32, device=cuda)
    shifted = base[1:].view(doc.shape)          # 4 bytes past a 16-byte boundary
    shifted.copy_(doc.to(cuda))
    assert not row_gather.vec_loads(shifted)
    out = _counted("rescore_match", lambda: row_gather.rescore_match(
        shifted, ids.to(cuda), qt.to(cuda), qw.to(cuda), 14))
    torch.testing.assert_close(out.cpu(), row_gather.rescore_match_plain(doc, ids, qt, qw, 14),
                               rtol=4e-6, atol=0)


# ---------------------------------------------------------------- K1 ------

@pytest.mark.parametrize("M,N,D,n_real", [(100, 5000, 64, None), (256, 8192, 768, None),
                                           (130, 4096, 128, 3000), (1, 129, 16, None)])
def test_k1_matches_plain_bits(cuda, M, N, D, n_real):
    g = torch.Generator().manual_seed(M + N + D)
    q_int, _ = dense_topk.quantize_rows(torch.randn(M, D, generator=g))
    rows, scale = dense_topk.quantize_rows(torch.randn(N, D, generator=g))
    scale = scale[:, 0].contiguous()
    rows[7] = 0                               # a zero-score doc: denormal after packing
    out = _counted("group_max_packed_int8", lambda: dense_topk.group_max_packed_int8(
        q_int.to(cuda), rows.to(cuda), scale.to(cuda), n_real=n_real))
    ref = dense_topk.group_max_packed_int8_plain(q_int, rows, scale,
                                                 N if n_real is None else n_real)
    assert torch.equal(out.cpu().view(torch.int32), ref.view(torch.int32))


@pytest.mark.parametrize("M,N,D", [(200, 5000, 768), (200, 4104, 96), (129, 2056, 256),
                                   (1024, 65536, 768)])
def test_k1_wgmma_ragged_matches_plain_bits(cuda, M, N, D):
    """The TMA + wgmma loop at ragged M (not a multiple of 128), ragged N
    (N % 256 != 0) and D below one 128-byte stage: bit-equal, any input."""
    g = torch.Generator().manual_seed(M * N + D)
    q_int, _ = dense_topk.quantize_rows(torch.randn(M, D, generator=g))
    rows, scale = dense_topk.quantize_rows(torch.randn(N, D, generator=g))
    scale = scale[:, 0].contiguous()
    rows[N - 3] = 0
    out = _counted("group_max_packed_int8", lambda: dense_topk.group_max_packed_int8(
        q_int.to(cuda), rows.to(cuda), scale.to(cuda), n_real=N - 1))
    ref = dense_topk.group_max_packed_int8_plain(q_int.to(cuda), rows.to(cuda), scale.to(cuda),
                                                 N - 1)
    assert torch.equal(out.view(torch.int32), ref.view(torch.int32))


def test_dense_topk_int8_matches_cpu(cuda):
    g = torch.Generator().manual_seed(3)
    q = torch.randn(64, 128, generator=g)
    rows, scale = dense_topk.quantize_rows(torch.randn(20_000, 128, generator=g))
    scale = scale[:, 0].contiguous()
    s_d, i_d = dense_topk.pallas_dense_topk_int8(q.to(cuda), rows.to(cuda), scale.to(cuda), k=100)
    s_c, i_c = dense_topk.pallas_dense_topk_int8(q, rows, scale, k=100)
    assert torch.equal(i_d.cpu(), i_c)
    assert torch.equal(s_d.cpu(), s_c)


def test_k1_and_merge_past_byte_2_31_match_plain(cuda):
    """K1 and its merge (pallas_dense_topk_int8) over the HotpotQA cell's
    5,233,329 x 768 int8 rows, 4.02 GB, against the plain version: the
    group maxima bit for bit, and the top-k ids and scores of the CPU
    route. Planted queries copy the row that holds byte 2^31, rows past it,
    the first id past 2^22 and both ends of the last, ragged group of 49
    docs; each finds its own row first. Random queries fill the batch."""
    N, D = HOTPOT_DOCS, 768
    planted = [(1 << 31) // D, (1 << 31) // D + 1, 3_500_001, 1 << 22, N - 49, N - 1]
    g = torch.Generator(device=cuda).manual_seed(31)
    rows = torch.randint(-127, 128, (N, D), generator=g, device=cuda, dtype=torch.int8)
    rows[planted, 0] = 127                    # each planted query quantizes to its row
    scale = torch.rand(N, generator=g, device=cuda) * 1e-3 + 0.01
    q = torch.cat([rows[planted].to(torch.float32),
                   torch.randn(130 - len(planted), D, generator=g, device=cuda)])
    q_int, _ = dense_topk.quantize_rows(q)
    assert torch.equal(q_int[:len(planted)], rows[planted])
    vals = _counted("group_max_packed_int8", lambda: dense_topk.group_max_packed_int8(
        q_int, rows, scale))
    assert vals.shape == (130, -(-N // 128))
    ref = dense_topk.group_max_packed_int8_plain(q_int, rows, scale, N)
    assert torch.equal(vals.view(torch.int32), ref.view(torch.int32))
    del vals, ref
    s_d, i_d = dense_topk.pallas_dense_topk_int8(q, rows, scale, k=100)
    assert i_d[:len(planted), 0].tolist() == planted
    s_c, i_c = dense_topk.pallas_dense_topk_int8(q.cpu(), rows.cpu(), scale.cpu(), k=100)
    assert torch.equal(i_d.cpu(), i_c)
    assert torch.equal(s_d.cpu(), s_c)


def test_wrappers_raise_instead_of_falling_back(cuda):
    q = torch.zeros((4, 24), dtype=torch.int8, device=cuda)   # D % 16 != 0
    rows = torch.zeros((256, 24), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="multiple of 16"):
        dense_topk.group_max_packed_int8(q, rows, torch.ones(256, device=cuda))
    with pytest.raises(ValueError, match="starts on"):
        window_gather.gather_windows(torch.zeros(64, dtype=torch.int32, device=cuda),
                                     torch.zeros(2, dtype=torch.int32), 8)


# ------------------------------------------------------ K7, K8, K9, K10 ----

def _int_bf16(shape, seed, lo=-4, hi=4):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(lo, hi + 1, shape, generator=g).to(torch.bfloat16)


def _rand_bf16(shape, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(torch.bfloat16)


def _tol(q, c):
    """float64 scores [M, N] and the per-entry tolerance (module docstring)."""
    qd, cd = q.double(), c.double()
    return qd @ cd.T, 2.0 ** -15 * (qd @ cd.T).abs() + 1e-6 * (qd.abs() @ cd.abs().T)


def _bits(x):
    return x.cpu().view(torch.int32)


@pytest.mark.parametrize("M,N,D,n_real,transposed", [
    (100, 5000, 64, None, False), (256, 8192, 768, None, False), (130, 4096, 128, 3000, False),
    (3, 77, 32, None, False), (100, 5000, 64, None, True), (256, 8192, 768, None, True),
    (130, 4000, 128, 3001, True), (5, 96, 16, None, True)])
def test_k7_matches_plain_bits(cuda, M, N, D, n_real, transposed):
    q = _int_bf16((M, D), M + N)
    c = _int_bf16((N, D), N + D)
    q[M // 2] = 0                             # zero scores: denormals once packed
    c[7] = 0
    c_in = c.T.contiguous() if transposed else c
    out = _counted("group_max_packed", lambda: dense_topk.group_max_packed(
        q.to(cuda), c_in.to(cuda), n_real=n_real, transposed=transposed))
    ref = dense_topk.group_max_packed_plain(q, c_in, N if n_real is None else n_real,
                                            transposed)
    assert torch.equal(_bits(out), ref.view(torch.int32))


@pytest.mark.parametrize("M,N,D", [(200, 5000, 768), (200, 4104, 96), (129, 2056, 256)])
@pytest.mark.parametrize("transposed", [False, True])
def test_k7_wgmma_ragged_matches_plain_bits(cuda, M, N, D, transposed):
    """The TMA + wgmma loop at ragged M, ragged N (N % 256 != 0, N % 8 == 0)
    and D below one 128-byte stage, both layouts: bit-equal on
    integer-valued inputs."""
    q, c = _int_bf16((M, D), M + D), _int_bf16((N, D), N + D)
    c[N - 5] = 0
    c_in = c.T.contiguous() if transposed else c
    out = _counted("group_max_packed", lambda: dense_topk.group_max_packed(
        q.to(cuda), c_in.to(cuda), n_real=N - 2, transposed=transposed))
    ref = dense_topk.group_max_packed_plain(q, c_in, N - 2, transposed)
    assert torch.equal(_bits(out), ref.view(torch.int32))


@pytest.mark.parametrize("transposed", [False, True])
def test_k7_random_within_tolerance(cuda, transposed):
    q, c = _rand_bf16((192, 768), 1), _rand_bf16((4096, 768), 2)
    c_in = c.T.contiguous() if transposed else c
    out = _bits(dense_topk.group_max_packed(q.to(cuda), c_in.to(cuda), transposed=transposed))
    ref = dense_topk.group_max_packed_plain(q.to(cuda), c_in.to(cuda), 4096,
                                            transposed).cpu().view(torch.int32)
    s64, tol = _tol(q, c)
    rows = torch.arange(192)[:, None]
    grp = torch.arange(out.shape[1])[None, :]
    o_doc, r_doc = grp * 128 + (out & 0x7F), grp * 128 + (ref & 0x7F)
    t = torch.maximum(tol[rows, o_doc], tol[rows, r_doc])
    clean = lambda b: (b & ~0x7F).view(torch.float32).double()
    assert ((clean(out) - clean(ref)).abs() <= t).all()
    assert ((s64[rows, o_doc] - s64[rows, r_doc]).abs() <= t).all()


@pytest.mark.parametrize("M,N,D,stride,tn,n_real", [
    (100, 5000, 64, 1, 2048, None), (256, 8192, 768, 4, 2048, None),
    (130, 4000, 128, 4, 1024, 3001), (3, 77, 32, 1, 256, None), (64, 3000, 64, 2, 512, None)])
def test_k8_matches_plain_bits(cuda, M, N, D, stride, tn, n_real):
    q = _int_bf16((M, D), M + N, -2, 2)       # narrow: ties inside and across blocks
    c = _int_bf16((N, D), N + D, -2, 2)
    vals, ids = _counted("group_max_scores", lambda: dense_topk.group_max_scores(
        q.to(cuda), c.to(cuda), n_real=n_real, stride=stride, tn=tn))
    r_vals, r_ids = dense_topk.group_max_scores_plain(q, c, N if n_real is None else n_real,
                                                      stride, tn)
    assert torch.equal(_bits(vals), r_vals.view(torch.int32))
    assert torch.equal(ids.cpu(), r_ids)


@pytest.mark.parametrize("M,N,D,stride,tn,n_real", [
    (200, 5000, 96, 1, 256, None),        # M and N ragged, stride 1
    (129, 4100, 128, 2, 512, 4000),       # stride 2, n_real inside the last tile
    (256, 8192, 768, 4, 512, None),       # g2 == 1
    (130, 2000, 64, 2, 768, 1999),        # odd g2 (3), all-pad groups, 9 columns
    (64, 700, 64, 3, 1152, None),         # odd g2 (3), N < tn, 3 columns
    (5, 77, 16, 1, 2048, None),           # N < 128, D below one 128-byte stage
    (300, 300, 32, 4, 512, 250),          # one output column
    (1024, 20480, 256, 4, 2048, None)])   # many units per cluster: the carry resets
def test_k8_wgmma_cases_match_plain_bits(cuda, M, N, D, stride, tn, n_real):
    """K8 on the wgmma loop: the stride merge carried across a unit's doc
    tiles, at every shape of its schedule; bit-equal on integer inputs,
    ties inside and across blocks included."""
    q = _int_bf16((M, D), M * N + stride, -2, 2)
    c = _int_bf16((N, D), N + D + tn, -2, 2)
    vals, ids = _counted("group_max_scores", lambda: dense_topk.group_max_scores(
        q.to(cuda), c.to(cuda), n_real=n_real, stride=stride, tn=tn))
    r_vals, r_ids = dense_topk.group_max_scores_plain(q, c, N if n_real is None else n_real,
                                                      stride, tn)
    assert vals.shape == r_vals.shape == (M, -(-N // tn) * tn // (128 * stride))
    assert torch.equal(_bits(vals), r_vals.view(torch.int32))
    assert torch.equal(ids.cpu(), r_ids)


@pytest.mark.parametrize("stride,tn,D", [(1, 2048, 768), (2, 768, 1024), (4, 1024, 1024)])
def test_k8_random_strides_within_tolerance(cuda, stride, tn, D):
    q, c = _rand_bf16((300, D), stride + D), _rand_bf16((6000, D), tn)
    vals, ids = dense_topk.group_max_scores(q.to(cuda), c.to(cuda), stride=stride, tn=tn)
    r_vals, r_ids = dense_topk.group_max_scores_plain(q.to(cuda), c.to(cuda), 6000, stride, tn)
    s64, tol = _tol(q, c)
    rows = torch.arange(300)[:, None]
    real = r_ids.cpu().long() < 6000          # the all-pad columns: -inf, equal
    assert torch.equal(vals.cpu()[~real], r_vals.cpu()[~real])
    assert torch.equal(ids.cpu()[~real], r_ids.cpu()[~real])
    ids, r_ids = ids.cpu().long().clamp(max=5999), r_ids.cpu().long().clamp(max=5999)
    t = torch.maximum(tol[rows, ids], tol[rows, r_ids])
    assert ((vals.cpu().double() - r_vals.cpu().double()).abs() <= t)[real].all()
    assert ((s64[rows, ids] - s64[rows, r_ids]).abs() <= t)[real].all()


def test_k8_random_within_tolerance(cuda):
    q, c = _rand_bf16((192, 768), 3), _rand_bf16((4096, 768), 4)
    vals, ids = dense_topk.group_max_scores(q.to(cuda), c.to(cuda), stride=4)
    r_vals, r_ids = dense_topk.group_max_scores_plain(q.to(cuda), c.to(cuda), 4096, 4, 2048)
    s64, tol = _tol(q, c)
    rows = torch.arange(192)[:, None]
    ids, r_ids = ids.cpu().long(), r_ids.cpu().long()
    t = torch.maximum(tol[rows, ids], tol[rows, r_ids])
    assert ((vals.cpu().double() - r_vals.cpu().double()).abs() <= t).all()
    assert ((s64[rows, ids] - s64[rows, r_ids]).abs() <= t).all()


def _k9_inputs(M, N, D, pattern):
    """int8 q [M, D] and corpus rows [N, D] for K9's tie and pad cases:
      random       entries in [-127, 127], docs 5 and 6 equal;
      same_docs    group 1 is 128 copies of one doc: lane 127 wins every row;
      tg_ties      q in {0, 1}, docs in {-1, 0, 1}; docs 8, 10, 12 and 14 of
                   group 2 are all ones, the row's best score: lanes that
                   differ only in bits 1-2 (four consumer threads of a quad),
                   so the OR of 2tg after the max and the quad reduce decide
                   (lane 14);
      masked_group entries in [-127, 127] (n_real leaves whole groups
                   masked: INT32_MIN | 127);
      extreme      every entry +-127, doc 3 = q[0] and doc 4 = -q[0]: row 0
                   reaches +-D * 127^2, the 2^24 edge at D 1040."""
    if pattern == "random":
        g = torch.Generator().manual_seed(M + N + D)
        q = torch.randint(-127, 128, (M, D), generator=g, dtype=torch.int8)
        c = torch.randint(-127, 128, (N, D), generator=g, dtype=torch.int8)
        c[5] = c[6]                           # tied scores in one group
        return q, c
    rng = np.random.default_rng(M + N + D)
    if pattern == "tg_ties":
        q, c = rng.integers(0, 2, (M, D)), rng.integers(-1, 2, (N, D))
        c[256 + np.array([8, 10, 12, 14])] = 1
    elif pattern == "extreme":
        q, c = rng.choice([-127, 127], (M, D)), rng.choice([-127, 127], (N, D))
        c[3], c[4] = q[0], -q[0]
    else:
        q, c = rng.integers(-127, 128, (M, D)), rng.integers(-127, 128, (N, D))
        if pattern == "same_docs":
            c[128:256] = c[128]
    return torch.as_tensor(q.astype(np.int8)), torch.as_tensor(c.astype(np.int8))


@pytest.mark.parametrize("M,N,D,n_real,pattern", [
    pytest.param(100, 5000, 64, None, "random", id="100-5000-64-None"),
    pytest.param(256, 8192, 768, None, "random", id="256-8192-768-None"),
    pytest.param(130, 4000, 128, 2999, "random", id="130-4000-128-2999"),
    pytest.param(1, 77, 16, None, "random", id="1-77-16-None"),
    (129, 200, 96, None, "random"),       # M ragged, 128 < N < 256: one tile, group 1 partial
    (300, 1000, 848, 700, "random"),      # n_real in a tile's second group, N % 256 != 0
    (1, 100, 16, 37, "random"),           # N < 128, D 16
    (300, 4000, 1040, 3900, "random"),    # n_real inside the last tile, D 1040
    (1024, 65536, 768, None, "random"),   # many units per cluster
    (129, 512, 64, None, "same_docs"),
    (300, 512, 32, None, "tg_ties"),
    (200, 1000, 48, 700, "masked_group"),
    (129, 2000, 1040, None, "extreme")])
def test_k9_matches_plain_bits(cuda, M, N, D, n_real, pattern):
    """K9 on the wgmma loop (int32 PackedIMax epilogue, no scale traffic):
    bit-equal to the plain version at ragged M and N, n_real inside a tile,
    D 16 to 1040, and at every tie and pad rule of the packed int32 max."""
    q, c = _k9_inputs(M, N, D, pattern)
    out = _counted("group_max_packed_int8_global", lambda: (
        dense_topk.group_max_packed_int8_global(q.to(cuda), c.to(cuda), n_real=n_real)))
    ref = dense_topk.group_max_packed_int8_global_plain(q, c, N if n_real is None else n_real)
    assert out.shape == (M, -(-N // 128))
    assert torch.equal(out.cpu(), ref)
    if pattern == "same_docs":
        assert ((ref[:, 1] & 0x7F) == 127).all()
    elif pattern == "tg_ties":
        assert ((ref[:, 2] & 0x7F) == torch.where(q.bool().any(1), 14, 127)).all()
    elif pattern == "masked_group":
        assert (ref[:, 6:] == INT32_MIN | 127).all()
    elif pattern == "extreme":
        assert int(ref[0, 0]) >> 7 == D * 127 * 127


@pytest.mark.parametrize("M,N,D,n_real", [(100, 5000, 64, None), (300, 20_000, 768, None),
                                           (130, 4000, 128, 3001), (3, 77, 32, None)])
def test_k10_matches_plain_bits(cuda, M, N, D, n_real):
    q = _int_bf16((M, D), M + N, -2, 2)
    c = _int_bf16((N, D), N + D, -2, 2)
    vals, ids = _counted("streaming_group_max", lambda: streaming_topk.streaming_group_max(
        q.to(cuda), c.to(cuda), n_real=n_real))
    r_vals, r_ids = streaming_topk.streaming_group_max_plain(q, c, N if n_real is None else n_real)
    assert vals.shape[1] == -(-N // streaming_topk.SUPER) * streaming_topk.SUPER // 128
    assert torch.equal(_bits(vals), r_vals.view(torch.int32))
    assert torch.equal(ids.cpu(), r_ids)


@pytest.mark.parametrize("M,N,D,n_real", [(129, 16384, 848, None), (200, 20000, 1024, 19999),
                                           (1024, 40000, 1024, None), (7, 100, 1024, None)])
def test_k10_takes_any_width_matches_plain_bits(cuda, M, N, D, n_real):
    """D 848 and 1024, above the 832 that the block-resident K10 of the
    mma.sync loop could hold in shared memory: the wgmma loop streams K in
    128-byte stages, so any D of 16-byte rows runs."""
    q = _int_bf16((M, D), M + D, -2, 2)
    c = _int_bf16((N, D), N + D, -2, 2)
    vals, ids = _counted("streaming_group_max", lambda: streaming_topk.streaming_group_max(
        q.to(cuda), c.to(cuda), n_real=n_real))
    r_vals, r_ids = streaming_topk.streaming_group_max_plain(q, c, N if n_real is None else n_real)
    assert torch.equal(_bits(vals), r_vals.view(torch.int32))
    assert torch.equal(ids.cpu(), r_ids)


def test_k10_random_within_tolerance(cuda):
    q, c = _rand_bf16((300, 768), 5), _rand_bf16((16384, 768), 6)
    vals, ids = streaming_topk.streaming_group_max(q.to(cuda), c.to(cuda))
    r_vals, r_ids = streaming_topk.streaming_group_max_plain(q.to(cuda), c.to(cuda), 16384)
    s64, tol = _tol(q, c)
    rows = torch.arange(300)[:, None]
    ids, r_ids = ids.cpu().long(), r_ids.cpu().long()
    t = torch.maximum(tol[rows, ids], tol[rows, r_ids])
    assert ((vals.cpu().double() - r_vals.cpu().double()).abs() <= t).all()
    assert ((s64[rows, ids] - s64[rows, r_ids]).abs() <= t).all()


def test_dense_topk_wrappers_match_cpu(cuda):
    q = _int_bf16((40, 256), 7).float()
    c = _int_bf16((20_000, 256), 8)
    ci = torch.randint(-127, 128, (20_000, 256), generator=torch.Generator().manual_seed(9),
                       dtype=torch.int8)
    calls = [
        lambda x, y: dense_topk.pallas_dense_topk(x, y, k=50),
        lambda x, y: dense_topk.pallas_dense_topk(x, y.T.contiguous(), k=50, transposed=True),
        lambda x, y: dense_topk.pallas_dense_topk(x, y, k=50, packed=False, stride=4),
        lambda x, y: streaming_topk.streaming_dense_topk(x, y, k=50, row_block=16),
    ]
    for call in calls:
        for a, b in zip(call(q.to(cuda), c.to(cuda)), call(q, c)):
            assert torch.equal(a.cpu(), b)
    scale = torch.tensor(0.01)
    for a, b in zip(dense_topk.pallas_dense_topk_int8_global(q.to(cuda), ci.to(cuda), scale),
                    dense_topk.pallas_dense_topk_int8_global(q, ci, scale)):
        assert torch.equal(a.cpu(), b)


def test_dense_wrappers_refuse_bad_inputs(cuda):
    q = torch.zeros((4, 12), dtype=torch.bfloat16, device=cuda)      # 24-byte rows
    c = torch.zeros((256, 12), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        dense_topk.group_max_packed(q, c)
    with pytest.raises(ValueError, match="16-byte"):
        dense_topk.group_max_scores(q, c)
    with pytest.raises(ValueError, match="16-byte"):
        streaming_topk.streaming_group_max(q, c)
    q16 = torch.zeros((4, 16), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="N % 8"):
        dense_topk.group_max_packed(q16, torch.zeros((16, 100), dtype=torch.bfloat16,
                                                     device=cuda), transposed=True)
    with pytest.raises(ValueError, match="bfloat16"):
        dense_topk.group_max_packed(q16.float(), torch.zeros((64, 16), device=cuda))
    with pytest.raises(ValueError, match="share a device"):
        dense_topk.group_max_scores(q16, torch.zeros((64, 16), dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="D <= 1040"):
        dense_topk.group_max_packed_int8_global(
            torch.zeros((2, 1056), dtype=torch.int8, device=cuda),
            torch.zeros((128, 1056), dtype=torch.int8, device=cuda))
    with pytest.raises(ValueError, match="16-byte"):
        dense_topk.group_max_packed_int8_global(
            torch.zeros((2, 24), dtype=torch.int8, device=cuda),
            torch.zeros((128, 24), dtype=torch.int8, device=cuda))
    wide = torch.zeros((2, 848), dtype=torch.bfloat16, device=cuda)   # no D limit
    vals, ids = streaming_topk.streaming_group_max(wide, torch.ones((128, 848),
                                                                    dtype=torch.bfloat16,
                                                                    device=cuda))
    assert (vals[:, 0] == 0).all() and torch.isneginf(vals[:, 1:]).all()   # 127 pad groups
    assert (ids == torch.arange(128, device=cuda) * 128).all()
