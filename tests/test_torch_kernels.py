"""Port parity, kernels: the plain PyTorch versions of K1 (packed int8 group
max), K2 (sort + segmented run sums), K3 (window gather), K4 (top-bs block)
and K5 (row sort) against the JAX package's Pallas kernels, run in
interpret mode on the CPU. Integer and packed-float outputs are compared
bit for bit. K6 is in test_torch_row_gather.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from qpp_fusion_rag_tpu.ops.pallas.bitonic import bitonic_segsum_rows as j_segsum
from qpp_fusion_rag_tpu.ops.pallas.bitonic import bitonic_sort_rows as j_sort
from qpp_fusion_rag_tpu.ops.pallas.bitonic import bitonic_topp_rows as j_topp
from qpp_fusion_rag_tpu.ops.pallas.dense_topk import (
    group_max_packed_int8 as j_group_max,
    pallas_dense_topk_int8,
    quantize_rows as j_quantize_rows,
)
from qpp_fusion_rag_tpu.ops.pallas.window_gather import (
    gather_windows_pallas,
    pad_for_gather,
)
from qpp_fusion_rag_tpu_torch.ops.kernels import bitonic, dense_topk, window_gather
from qpp_fusion_rag_tpu_torch.ops.segment import topk_first

INT32_MIN, INT32_MAX = -(2**31), 2**31 - 1


# ---------------------------------------------------------------- K3 ------

def _gather_src():
    rng = np.random.default_rng(0)
    return pad_for_gather(rng.integers(0, 2**30, 6000).astype(np.int32), 1024)


@pytest.mark.parametrize("which", ["edges", "permuted"])
def test_k3_plain_matches_pallas(which):
    flat = _gather_src()
    if which == "edges":
        # off == 0, off < 128, off across sublanes, near the end
        base = [0, 1, 127, 128, 129, 1023, 1024, 1025, 2048, 3000, 4095, 5000]
        starts = np.resize(np.asarray(base, np.int32), 32)
    else:
        rng = np.random.default_rng(0)
        starts = np.resize(rng.permutation(np.arange(0, 5000, dtype=np.int32)), 96)
    ref = np.asarray(gather_windows_pallas(jnp.asarray(flat), jnp.asarray(starts), 1024))
    out = window_gather.gather_windows(torch.as_tensor(flat), torch.as_tensor(starts), 1024)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)


def test_k3_no_tpu_alignment_rules():
    """Any cap and window count: the TPU's cap % 1024 and G % 32 do not apply."""
    flat = np.arange(1000, dtype=np.int32) * 7
    starts = np.array([0, 3, 500, 963], np.int32)
    out = window_gather.gather_windows(torch.as_tensor(flat), torch.as_tensor(starts), 37)
    np.testing.assert_array_equal(out.numpy(), np.stack([flat[s:s + 37] for s in starts]))


def test_k3_refuses_bad_inputs():
    src = torch.arange(100, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        window_gather.gather_windows(src.long(), torch.zeros(2, dtype=torch.int32), 4)
    with pytest.raises(ValueError, match="starts"):
        window_gather.gather_windows(src, torch.tensor([0, 97], dtype=torch.int32), 4)
    with pytest.raises(ValueError, match="cap"):
        window_gather.gather_windows(src, torch.zeros(2, dtype=torch.int32), 101)


# ---------------------------------------------------------------- K2 ------

def _segsum_keys(M, presorted, rng, lo=0):
    """[8, M] keys: random (start_block 2) or presorted alternating cap-blocks
    of unique docs (from [lo, lo + 3000)) with INT32_MAX / INT32_MIN pads
    (start_block 2*cap). Every real doc run is at most Tq long."""
    B = 8
    if not presorted:
        docs = rng.integers(0, 5000, size=(B, M)).astype(np.int64)
        keys = (docs << 8) | rng.integers(0, 256, (B, M))
        keys[:, -200:] = INT32_MAX
        keys[:, :5] = INT32_MIN
        tq = int(max(np.unique(r, return_counts=True)[1].max() for r in docs[:, 5:-200]))
        return keys.astype(np.int32), 2, tq
    cap = 128
    tq = M // cap
    keys = np.empty((B, tq, cap), np.int64)
    for b in range(B):
        for t in range(tq):
            n = int(rng.integers(0, cap + 1))
            d = lo + np.sort(rng.choice(3000, n, replace=False)).astype(np.int64)
            w = (d << 8) | rng.integers(0, 256, n)
            pad = INT32_MIN if t % 2 else INT32_MAX
            w = np.concatenate([w[::-1] if t % 2 else w, np.full(cap - n, pad)])
            keys[b, t] = w
    return keys.reshape(B, M).astype(np.int32), 2 * cap, tq


@pytest.mark.parametrize("max_run_set", [False, True])
@pytest.mark.parametrize("plus_one", [False, True])
@pytest.mark.parametrize("presorted", [False, True])
@pytest.mark.parametrize("M", [1024, 2048])
def test_k2_plain_matches_pallas(M, presorted, plus_one, max_run_set):
    rng = np.random.default_rng(M + 10 * presorted)
    keys, start_block, tq = _segsum_keys(M, presorted, rng)
    max_run = tq if max_run_set else None
    j_sums, j_sids = map(np.asarray, j_segsum(
        jnp.asarray(keys), start_block=start_block, plus_one=plus_one, max_run=max_run))
    sums, sids = bitonic.bitonic_segsum_rows(
        torch.as_tensor(keys), start_block=start_block, plus_one=plus_one,
        max_run=max_run)
    np.testing.assert_array_equal(sids.numpy(), j_sids)
    real = j_sids < 0x7FFFFF if max_run_set else np.ones_like(j_sids, bool)
    np.testing.assert_array_equal(sums.numpy()[real], j_sums[real])


@pytest.mark.parametrize("plus_one", [False, True])
def test_k2_plain_matches_pallas_on_ids_past_2_22(plus_one):
    """Presorted keys of doc ids up to BEIR HotpotQA's last, 5,233,328: bit
    30 of every real key is set, just under the sign bit and the 0x7FFFFF
    pad id. The plain version equals the Pallas kernel bit for bit."""
    rng = np.random.default_rng(23 + plus_one)
    keys, start_block, tq = _segsum_keys(2048, True, rng, lo=5_233_329 - 3000)
    real = (keys != INT32_MAX) & (keys != INT32_MIN)
    assert ((keys[real] >> 30) == 1).all()
    j_sums, j_sids = map(np.asarray, j_segsum(
        jnp.asarray(keys), start_block=start_block, plus_one=plus_one))
    sums, sids = bitonic.bitonic_segsum_rows(
        torch.as_tensor(keys), start_block=start_block, plus_one=plus_one)
    np.testing.assert_array_equal(sids.numpy(), j_sids)
    np.testing.assert_array_equal(sums.numpy(), j_sums)
    assert j_sids[j_sids < 0x7FFFFF].max() >= 5_233_329 - 3


def test_k2_plain_exact_on_any_row_length():
    """Rows that are no power of two (the CUDA kernel pads them in shared
    memory) against a per-row numpy reference."""
    rng = np.random.default_rng(5)
    keys = ((rng.integers(0, 40, (3, 1000)) << 8)
            | rng.integers(0, 256, (3, 1000))).astype(np.int32)
    keys[0, :7] = INT32_MIN
    sums, sids = bitonic.bitonic_segsum_rows(torch.as_tensor(keys), plus_one=True)
    for b in range(3):
        sk = np.sort(keys[b].astype(np.int64))
        sid = (sk & 0xFFFFFFFF) >> 8
        np.testing.assert_array_equal(sids[b].numpy(), sid)
        want = np.full(1000, -1)
        for d in np.unique(sid):
            pos = np.flatnonzero(sid == d)
            want[pos[-1]] = int(((sk[pos] & 0xFF) + 1).sum())
        np.testing.assert_array_equal(sums[b].numpy(), want)


def test_k2_refuses_bad_arguments():
    keys = torch.zeros((2, 1024), dtype=torch.int32)
    with pytest.raises(ValueError, match="start_block"):
        bitonic.bitonic_segsum_rows(keys, start_block=3)
    with pytest.raises(ValueError, match="start_block"):
        bitonic.bitonic_segsum_rows(keys, start_block=4096)
    with pytest.raises(ValueError, match="multiple of start_block"):
        bitonic.bitonic_segsum_rows(torch.zeros((2, 1000), dtype=torch.int32),
                                    start_block=512)
    with pytest.raises(ValueError, match="int32"):
        bitonic.bitonic_segsum_rows(keys.long())
    with pytest.raises(ValueError, match="max_run"):
        bitonic.bitonic_segsum_rows(keys, max_run=0)


# ------------------------------------------------------------ K4, K5 ------

def _pool_format_keys(B, M, rng):
    """(sum << 16 | position) keys as the rank-safe pool forms them, with
    many -1 (positions off a run) and many tied sums."""
    sums = rng.integers(0, 40, (B, M))
    sums[rng.random((B, M)) < 0.6] = -1
    return np.where(sums >= 0, (sums << 16) | np.arange(M), -1).astype(np.int32)


@pytest.mark.parametrize("presorted", [False, True])
@pytest.mark.parametrize("M", [1024, 2048])
def test_k5_plain_matches_pallas(M, presorted):
    rng = np.random.default_rng(M + presorted)
    if presorted:
        keys, start_block, _ = _segsum_keys(M, True, rng)
    else:
        keys, start_block = _pool_format_keys(8, M, rng), 2
    ref = np.asarray(j_sort(jnp.asarray(keys), start_block=start_block))
    out = bitonic.bitonic_sort_rows(torch.as_tensor(keys), start_block=start_block)
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("M,bs", [(2048, 1024), (4096, 1024), (4096, 2048)])
def test_k4_plain_matches_pallas(M, bs):
    keys = _pool_format_keys(8, M, np.random.default_rng(M + bs))
    ref = np.asarray(j_topp(jnp.asarray(keys), bs=bs))
    out = bitonic.bitonic_topp_rows(torch.as_tensor(keys), bs=bs)
    assert out.shape == (8, bs)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_k4_k5_refuse_bad_arguments():
    keys = torch.zeros((2, 4096), dtype=torch.int32)
    for bs in (512, 3000, 4096):
        with pytest.raises(ValueError, match="bs="):
            bitonic.bitonic_topp_rows(keys, bs=bs)
    with pytest.raises(ValueError, match="2\\*bs"):
        bitonic.bitonic_topp_rows(keys, bs=1024, start_block=4096)
    with pytest.raises(ValueError, match="start_block"):
        bitonic.bitonic_sort_rows(keys, start_block=6)
    with pytest.raises(ValueError, match="int32"):
        bitonic.bitonic_sort_rows(keys.long())


# ---------------------------------------------------------------- K1 ------

def _dense_inputs(M, N, D, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((M, D)).astype(np.float32)
    corpus = rng.standard_normal((D, N)).astype(np.float32)
    c_int, d_scale = map(np.array, j_quantize_rows(jnp.asarray(corpus), axis=0))
    return q, c_int, d_scale.reshape(1, N)


@pytest.mark.parametrize("N,n_real", [(8192, None), (5000, None), (6144, 5000)])
def test_k1_plain_matches_pallas_bits(N, n_real):
    """Packed group maxima equal as int32 bit patterns, with and without
    pad docs (the JAX kernel pads N to its tile; the port masks n >= n_real
    and reports ceil(N/128) groups)."""
    M, D = 16, 64
    q, c_int, d_scale = _dense_inputs(M, N, D)
    q_int = np.array(j_quantize_rows(jnp.asarray(q))[0])
    pad = (-N) % 2048
    j_c = np.pad(c_int, ((0, 0), (0, pad)))
    j_s = np.pad(d_scale, ((0, 0), (0, pad)))
    j_real = n_real if n_real is not None else (N if pad else 0)
    ref = np.asarray(j_group_max(jnp.asarray(q_int), jnp.asarray(j_c), jnp.asarray(j_s),
                                 tn=2048, n_real=j_real))
    out = dense_topk.group_max_packed_int8(
        torch.as_tensor(q_int), torch.as_tensor(np.ascontiguousarray(c_int.T)),
        torch.as_tensor(d_scale[0]), n_real=n_real)
    G = -(-N // 128)
    assert out.shape == (M, G)
    np.testing.assert_array_equal(out.numpy().view(np.int32), ref[:, :G].view(np.int32))


@pytest.mark.parametrize("N,k", [(8192, 32), (5000, 32), (5000, 100)])
def test_dense_topk_int8_matches_exact_merge(N, k):
    M, D = 16, 64
    q, c_int, d_scale = _dense_inputs(M, N, D, seed=1)
    js, ji = map(np.asarray, pallas_dense_topk_int8(
        jnp.asarray(q), jnp.asarray(c_int), jnp.asarray(d_scale), k=k,
        exact_merge=True))
    ts, ti = dense_topk.pallas_dense_topk_int8(
        torch.as_tensor(q), torch.as_tensor(np.ascontiguousarray(c_int.T)),
        torch.as_tensor(d_scale[0]), k=k)
    kk = min(k, -(-N // 128))   # the port has ceil(N/128) groups, JAX N_pad/128
    np.testing.assert_array_equal(ti.numpy()[:, :kk], ji[:, :kk])
    np.testing.assert_array_equal(ts.numpy()[:, :kk], js[:, :kk])
    assert (ti.numpy()[:, kk:] == -1).all() and np.isneginf(ts.numpy()[:, kk:]).all()


@pytest.mark.parametrize("axis", [-1, 0])
def test_quantize_rows_equal(axis):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((40, 24)).astype(np.float32)
    x[3] = 0.0
    x[:, 5] = 0.0
    # jitted, as every JAX caller runs it: XLA turns "/ 127.0" into a multiply
    # by the f32 reciprocal, and the port reproduces the compiled numerics
    jq, js = map(np.asarray, jax.jit(j_quantize_rows, static_argnames="axis")(
        jnp.asarray(x), axis=axis))
    tq, ts = dense_topk.quantize_rows(torch.as_tensor(x), axis=axis)
    np.testing.assert_array_equal(tq.numpy(), jq)
    np.testing.assert_array_equal(ts.numpy(), js)


def test_k1_refuses_bad_inputs():
    q = torch.zeros((4, 64), dtype=torch.int8)
    c = torch.zeros((256, 64), dtype=torch.int8)
    s = torch.ones(256)
    with pytest.raises(ValueError, match="d_scale"):
        dense_topk.group_max_packed_int8(q, c, torch.ones((1, 256)))
    with pytest.raises(ValueError, match="int8"):
        dense_topk.group_max_packed_int8(q.float(), c, s)
    with pytest.raises(ValueError, match="n_real"):
        dense_topk.group_max_packed_int8(q, c, s, n_real=257)
    with pytest.raises(ValueError, match="2\\^24"):
        dense_topk.group_max_packed_int8(torch.zeros((4, 1100), dtype=torch.int8),
                                         torch.zeros((256, 1100), dtype=torch.int8), s)


# ---------------------------------------------------------- selection -----

@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_topk_first_matches_lax_top_k_ties(dtype):
    rng = np.random.default_rng(4)
    x = rng.integers(-3, 4, (6, 300)).astype(dtype)
    if dtype == np.float32:
        x[:, ::7] = -np.inf
    jv, ji = map(np.asarray, lax.top_k(jnp.asarray(x), 50))
    tv, ti = topk_first(torch.as_tensor(x), 50)
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_array_equal(tv.numpy(), jv)
