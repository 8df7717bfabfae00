"""Port parity, dense family: the plain PyTorch versions of K7
(group_max_packed, both layouts), K8 (group_max_scores, stride 1 and 4),
K9 (group_max_packed_int8_global) and K10 (the streaming group max)
against the JAX package's Pallas kernels in interpret mode, the top-k
wrappers built on them against JAX with exact_merge=True, and ops/dense.py
against JAX's XLA path.

Tolerances:
  * integer-valued bf16 inputs (entries in [-4, 4], D <= 768) make every
    f32 partial sum exact in any order, so there K7, K8 and K10 are
    compared bit for bit, ties included; K9 is integer arithmetic and is
    compared bit for bit on any input;
  * on random inputs only the f32 summation order differs: clean scores
    agree within one packing quantum plus the order's rounding
    (2^-15 relative + 1e-6 of the row's |q|.|c| bound), and a lane (or
    argmax) may differ only where the two docs' float64 scores lie within
    that tolerance of each other.
The JAX kernels need N % tn == 0 and are given zero-padded corpora with
n_real; the port's kernels mask the ragged edge themselves."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qpp_fusion_rag_tpu.ops import dense as JD
from qpp_fusion_rag_tpu.ops.pallas import dense_topk as JK
from qpp_fusion_rag_tpu.ops.pallas import streaming_topk as JS
from qpp_fusion_rag_tpu_torch.ops import dense as TD
from qpp_fusion_rag_tpu_torch.ops.kernels import dense_topk as TK
from qpp_fusion_rag_tpu_torch.ops.kernels import streaming_topk as TS

G = TK.GROUP


def _ints(rng, shape, lo=-4, hi=4):
    """Integer-valued f32 (exact in bf16)."""
    return rng.integers(lo, hi + 1, shape).astype(np.float32)


def _bf(x):
    """numpy f32 -> (jax bf16, torch bf16) of the same values."""
    return jnp.asarray(x, jnp.bfloat16), torch.as_tensor(x).to(torch.bfloat16)


def _pad_rows(x, tn):
    return np.pad(x, ((0, (-x.shape[0]) % tn), (0, 0)))


def _bits(x):
    return np.asarray(x).view(np.int32)


def _tol(q, c):
    """Per-(row, doc) score tolerance for random data (module docstring)."""
    bound = np.abs(q.astype(np.float64)) @ np.abs(c.astype(np.float64)).T
    s = q.astype(np.float64) @ c.astype(np.float64).T
    return s, 2.0 ** -15 * np.abs(s) + 1e-6 * bound


# ----------------------------------------------------------------- K7 ------

@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("n", [1024, 1000, 77])
def test_k7_plain_matches_pallas_bits(transposed, n):
    rng = np.random.default_rng(n + transposed)
    q = _ints(rng, (16, 64))
    c = _ints(rng, (n, 64))
    c[:, :8] = np.abs(c[:, :8])              # both signs of score in most groups
    jq, tq = _bf(q)
    jc, tc = _bf(_pad_rows(c, 256))
    if transposed:
        jc = jc.T
        tc = torch.as_tensor(c.T.copy()).to(torch.bfloat16)
    else:
        tc = torch.as_tensor(c).to(torch.bfloat16)
    ref = JK.group_max_packed(jq, jc, tm=8, tn=256, n_real=n, transposed=transposed)
    out = TK.group_max_packed(tq, tc, transposed=transposed)
    g = -(-n // G)
    assert out.shape == (16, g)
    np.testing.assert_array_equal(_bits(out.numpy()), _bits(ref)[:, :g])
    # JAX's extra columns are all-pad groups: the -3e38 pad, lane 0
    assert (_bits(ref)[:, g:] == _bits(np.float32(TK.NEG_FINITE)) & ~0x7F).all()


def test_k7_zero_scores_keep_their_lane():
    """A zero score packs into a denormal. The port keeps it (the CUDA build
    has no flush-to-zero), so among tied +0 scores the highest lane wins;
    XLA's CPU backend flushes denormals, which loses the lane (bits 0), so
    JAX on the CPU is compared on inputs whose group maxima are nonzero."""
    q = torch.zeros((2, 32), dtype=torch.bfloat16)
    q[1, 0] = 1
    c = torch.ones((300, 32), dtype=torch.bfloat16)
    c[:, 0] = -1
    out = TK.group_max_packed(q, c).view(torch.int32)
    assert out[0].tolist() == [127, 127, 300 - 257]      # +0, highest lane
    assert (out[1] < 0).all()                            # -1.0, lowest lane 0
    assert (out[1] & 0x7F).tolist() == [0, 0, 0]


def test_k7_plain_random_within_tolerance():
    rng = np.random.default_rng(5)
    q = rng.standard_normal((16, 96)).astype(np.float32)
    c = rng.standard_normal((1024, 96)).astype(np.float32)
    jq, tq = _bf(q)
    jc, tc = _bf(c)
    qb = np.asarray(jq.astype(jnp.float32))
    cb = np.asarray(jc.astype(jnp.float32))
    ref = np.asarray(JK.group_max_packed(jq, jc, tm=8, tn=256))
    out = TK.group_max_packed(tq, tc).numpy()
    s64, tol = _tol(qb, cb)
    r_clean, r_lane = (_bits(ref) & ~0x7F).view(np.float32), _bits(ref) & 0x7F
    o_clean, o_lane = (_bits(out) & ~0x7F).view(np.float32), _bits(out) & 0x7F
    rows, grp = np.indices(ref.shape)
    r_doc, o_doc = grp * G + r_lane, grp * G + o_lane
    t = np.maximum(tol[rows, r_doc], tol[rows, o_doc])
    assert (np.abs(o_clean - r_clean) <= t).all()
    assert (np.abs(s64[rows, o_doc] - s64[rows, r_doc]) <= t).all()


# ----------------------------------------------------------------- K8 ------

@pytest.mark.parametrize("stride,tn", [(1, 256), (4, 512), (4, 1024), (2, 1024)])
@pytest.mark.parametrize("n", [2048, 1900])
def test_k8_plain_matches_pallas_bits(stride, tn, n):
    rng = np.random.default_rng(stride * tn + n)
    q = _ints(rng, (16, 64), -2, 2)          # narrow range: ties across blocks too
    c = _ints(rng, (n, 64), -2, 2)
    jq, tq = _bf(q)
    jc, _ = _bf(_pad_rows(c, tn))
    _, tc = _bf(c)
    rv, ri = JK.group_max_scores(jq, jc, tm=8, tn=tn, n_real=n, stride=stride)
    ov, oi = TK.group_max_scores(tq, tc, stride=stride, tn=tn)
    np.testing.assert_array_equal(_bits(ov.numpy()), _bits(rv))
    np.testing.assert_array_equal(oi.numpy(), np.asarray(ri))


def test_k8_plain_random_within_tolerance():
    rng = np.random.default_rng(8)
    q = rng.standard_normal((16, 96)).astype(np.float32)
    c = rng.standard_normal((2048, 96)).astype(np.float32)
    jq, tq = _bf(q)
    jc, tc = _bf(c)
    s64, tol = _tol(np.asarray(jq.astype(jnp.float32)), np.asarray(jc.astype(jnp.float32)))
    rv, ri = map(np.asarray, JK.group_max_scores(jq, jc, tm=8, tn=1024, stride=4))
    ov, oi = TK.group_max_scores(tq, tc, stride=4, tn=1024)
    ov, oi = ov.numpy(), oi.numpy()
    rows = np.indices(rv.shape)[0]
    t = np.maximum(tol[rows, ri], tol[rows, oi])
    assert (np.abs(ov - rv) <= t).all()
    assert (np.abs(s64[rows, oi] - s64[rows, ri]) <= t).all()


# ----------------------------------------------------------------- K9 ------

@pytest.mark.parametrize("n,n_real", [(1024, None), (1000, None), (1024, 700), (50, None)])
def test_k9_plain_matches_pallas_bits(n, n_real):
    rng = np.random.default_rng(n + (n_real or 0))
    q = rng.integers(-127, 128, (16, 96)).astype(np.int8)
    c = rng.integers(-127, 128, (n, 96)).astype(np.int8)
    c[5] = c[6]                              # tied scores in one group
    c[:, 0] = np.where(np.arange(n) % 3 == 0, 127, c[:, 0])
    nr = n if n_real is None else n_real
    ref = JK.group_max_packed_int8_global(jnp.asarray(q), jnp.asarray(_pad_rows(c, 256).T),
                                          tm=8, tn=256, n_real=nr)
    out = TK.group_max_packed_int8_global(torch.as_tensor(q), torch.as_tensor(c), n_real=n_real)
    g = -(-n // G)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref)[:, :g])


def test_quantize_global_matches_jitted_reference():
    rng = np.random.default_rng(2)
    for scale in (0.01, 1.0, 37.0):
        x = (rng.standard_normal((64, 48)) * scale).astype(np.float32)
        jq, js = jax.jit(JK.quantize_global)(jnp.asarray(x))
        tq, ts = TK.quantize_global(torch.as_tensor(x))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        assert float(ts) == float(js) and ts.dim() == 0
    tq, ts = TK.quantize_global(torch.zeros(3, 4))
    assert float(ts) == 1.0 and not tq.any()


# ---------------------------------------------------------------- K10 ------

def test_k10_plain_matches_pallas_bits():
    """The JAX kernel's smallest shape: one 512-row slab, one 16384-doc
    super-tile (ragged: 16000 real docs)."""
    rng = np.random.default_rng(10)
    q = _ints(rng, (512, 32), -2, 2)
    c = _ints(rng, (16_000, 32), -2, 2)
    jq, tq = _bf(q)
    jc, _ = _bf(_pad_rows(c, JS.SUPER))
    _, tc = _bf(c)
    rv, ri = JS._streaming_group_max(jq, jc, n_real=16_000)
    ov, oi = TS.streaming_group_max(tq, tc)
    np.testing.assert_array_equal(_bits(ov.numpy()), _bits(rv))
    np.testing.assert_array_equal(oi.numpy(), np.asarray(ri))


# ------------------------------------------------------- top-k wrappers ----

@pytest.mark.parametrize("kw", [dict(), dict(transposed=True), dict(packed=False),
                                dict(packed=False, stride=4, tn=1024)])
def test_pallas_dense_topk_matches_jax(kw):
    rng = np.random.default_rng(len(kw))
    q = _ints(rng, (16, 64))
    c = _ints(rng, (1900, 64))
    jc = jnp.asarray(c.T if kw.get("transposed") else c, jnp.bfloat16)
    tc = torch.as_tensor(c.T.copy() if kw.get("transposed") else c).to(torch.bfloat16)
    tn = kw.get("tn", 256)
    jkw = dict(kw, tn=tn)
    js, ji = JK.pallas_dense_topk(jnp.asarray(q), jc, k=40, tm=8, exact_merge=True, **jkw)
    ts, ti = TK.pallas_dense_topk(torch.as_tensor(q), tc, k=40, **jkw)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_pallas_dense_topk_pads_k_beyond_groups():
    rng = np.random.default_rng(4)
    q, c = _ints(rng, (4, 32)), _ints(rng, (300, 32))
    js, ji = JK.pallas_dense_topk(jnp.asarray(q), jnp.asarray(c, jnp.bfloat16), k=6, tm=8,
                                  tn=256, exact_merge=True)
    ts, ti = TK.pallas_dense_topk(torch.as_tensor(q), torch.as_tensor(c).to(torch.bfloat16),
                                  k=6)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert (ti.numpy()[:, 3:] == -1).all()


def test_multi_view_wrappers_match_jax():
    rng = np.random.default_rng(6)
    q, proj = _ints(rng, (8, 32), -2, 2), _ints(rng, (3, 32, 48), -1, 1)
    c = _ints(rng, (1000, 48))
    js, ji = JK.pallas_multi_view_topk(jnp.asarray(q), jnp.asarray(proj),
                                       jnp.asarray(c, jnp.bfloat16), k=20, tm=8, tn=256,
                                       exact_merge=True)
    ts, ti = TK.pallas_multi_view_topk(torch.as_tensor(q), torch.as_tensor(proj),
                                       torch.as_tensor(c).to(torch.bfloat16), k=20)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))

    cf = rng.standard_normal((48, 1000)).astype(np.float32)
    c_int, d_scale = jax.jit(lambda x: JK.quantize_rows(x, axis=0))(jnp.asarray(cf))
    js, ji = JK.pallas_multi_view_topk_int8(jnp.asarray(q), jnp.asarray(proj), c_int, d_scale,
                                            k=20, tm=8, tn=256, exact_merge=True)
    ts, ti = TK.pallas_multi_view_topk_int8(
        torch.as_tensor(q), torch.as_tensor(proj), torch.as_tensor(np.asarray(c_int).T.copy()),
        torch.as_tensor(np.array(d_scale).reshape(-1)), k=20)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("n", [1024, 1000])
def test_pallas_dense_topk_int8_global_matches_jax(n):
    rng = np.random.default_rng(n)
    q = rng.standard_normal((16, 64)).astype(np.float32)
    cf = rng.standard_normal((n, 64)).astype(np.float32)
    c_int, c_scale = jax.jit(JK.quantize_global)(jnp.asarray(cf))
    js, ji = JK.pallas_dense_topk_int8_global(jnp.asarray(q), c_int.T, c_scale, k=30, tm=8,
                                              tn=256, exact_merge=True)
    ts, ti = TK.pallas_dense_topk_int8_global(torch.as_tensor(q),
                                              torch.as_tensor(np.array(c_int)),
                                              torch.as_tensor(np.array(c_scale)), k=30)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_streaming_dense_topk_matches_jax():
    """JAX merges with approx_max_k, which returns lax.top_k's result on the
    CPU; the port merges exactly. Three rows (JAX pads them to a 512-row
    slab), a ragged corpus, two launches of the port (row_block 2)."""
    rng = np.random.default_rng(11)
    q = _ints(rng, (3, 32), -2, 2)
    c = _ints(rng, (16_000, 32), -2, 2)
    js, ji = JS.streaming_dense_topk(jnp.asarray(q), jnp.asarray(c, jnp.bfloat16), k=25)
    ts, ti = TS.streaming_dense_topk(torch.as_tensor(q), torch.as_tensor(c).to(torch.bfloat16),
                                     k=25, row_block=2)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_wrappers_refuse_bad_inputs():
    q = torch.zeros((4, 32), dtype=torch.bfloat16)
    c = torch.zeros((300, 32), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16"):
        TK.group_max_packed(q.float(), c)
    with pytest.raises(ValueError, match="D=16"):
        TK.group_max_packed(q[:, :16].contiguous(), c)
    with pytest.raises(ValueError, match="contiguous"):
        TK.group_max_scores(q, c.T.contiguous().T)
    with pytest.raises(ValueError, match="multiple of 128"):
        TK.group_max_scores(q, c, stride=4, tn=256)
    with pytest.raises(ValueError, match="n_real"):
        TK.group_max_packed(q, c, n_real=301)
    with pytest.raises(ValueError, match="stride=1 only"):
        TK.pallas_dense_topk(q, c, stride=2)
    with pytest.raises(ValueError, match="packed path only"):
        TK.pallas_dense_topk(q, c, packed=False, transposed=True)
    with pytest.raises(ValueError, match="bf16 corpus"):
        TK.pallas_dense_topk(q, c.float())
    with pytest.raises(ValueError, match="D <= 1040"):
        TK.group_max_packed_int8_global(torch.zeros((2, 1056), dtype=torch.int8),
                                        torch.zeros((128, 1056), dtype=torch.int8))
    with pytest.raises(ValueError, match="bf16 corpus"):
        TS.streaming_dense_topk(q, c.float())


# ----------------------------------------------------------- ops/dense -----

@pytest.mark.parametrize("dtype,chunk,n", [(jnp.float32, 256, 1000), (jnp.bfloat16, 512, 1000),
                                           (jnp.float32, 4096, 700), (jnp.float32, 64, 50)])
def test_dense_topk_matches_jax(dtype, chunk, n):
    rng = np.random.default_rng(chunk + n)
    q = rng.standard_normal((8, 32)).astype(np.float32)
    c = rng.standard_normal((n, 32)).astype(np.float32)
    if dtype == jnp.bfloat16:
        q, c = _ints(rng, (8, 32)), _ints(rng, (n, 32))   # order-exact sums, ties
    jc = jnp.asarray(c, dtype)
    tc = torch.as_tensor(np.array(jc.astype(jnp.float32))).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    js, ji = JD.dense_topk(jnp.asarray(q), jc, k=60, chunk=chunk, exact=True)
    ts, ti = TD.dense_topk(torch.as_tensor(q), tc, k=60, chunk=chunk)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=1e-6)


def test_multi_view_topk_and_merge_match_jax():
    rng = np.random.default_rng(12)
    q, proj = _ints(rng, (6, 32), -2, 2), _ints(rng, (3, 32, 24), -1, 1)
    c = _ints(rng, (900, 24))
    jc = jnp.asarray(c, jnp.bfloat16)
    js, ji = JD.multi_view_topk(jnp.asarray(q), jnp.asarray(proj), jc, k=30, chunk=256,
                                exact=True)
    ts, ti = TD.multi_view_topk(torch.as_tensor(q), torch.as_tensor(proj),
                                torch.as_tensor(c).to(torch.bfloat16), k=30, chunk=256)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jm = JD.merge_topk(js[0], ji[0], js[1], ji[1], 30)
    tm = TD.merge_topk(ts[0], ti[0], ts[1], ti[1], 30)
    for a, b in zip(tm, jm):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
