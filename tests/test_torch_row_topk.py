"""The dense merge's exact row top-k (ops/kernels/row_topk.py,
csrc/row_topk.cu) and the benchmark metric that reads its kernel.

On the CPU: row_topk is topk_first, the wrapper's refusals, each f32
dense merge's call, and the bytes merge_roofline counts in each cell. On
the card (marker cuda; they skip without one): the kernel is bit-equal to
topk_first on the card, values and columns, over rows of 1 to 5,120,
widths 1 to 100,003 (staged in shared memory up to 53,248 columns, read
from global memory above), k 1 to the cap, and rows of planted ties,
signed zeros, infinities, denormals, packed pads and the K1 / K7 maxima of
real inputs; a k above the cap is refused. The file imports no JAX; on the
card run

    python -m pytest --noconftest -m cuda tests/test_torch_row_topk.py
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from qpp_fusion_rag_tpu_torch.ops.kernels import LAUNCHES, dense_topk
from qpp_fusion_rag_tpu_torch.ops.kernels.row_topk import MAX_K, row_topk
from qpp_fusion_rag_tpu_torch.ops.segment import topk_first

ROOT = Path(__file__).resolve().parents[1]
NEG_FINITE = dense_topk.NEG_FINITE
STAGED = 53_248       # csrc/row_topk.cu kMaxG: the widest row staged in shared memory


def _rows(pattern, M, G, k, seed):
    """f32 rows [M, G] of one pattern, from numpy draws."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, G)).astype(np.float32)
    kk = min(k, G)
    if pattern == "ties":          # thousands of columns equal to the k-th value
        kth = -np.sort(-x, axis=1)[:, kk - 1:kk]
        cols = rng.random((M, G)) < 0.4
        x = np.where(cols, kth, x)
    elif pattern == "equal":
        x[:] = 0.25
    elif pattern == "specials":    # +-0.0 (they tie), +-inf, denormals
        pick = rng.integers(0, 6, (M, G))
        x = np.select([pick == 0, pick == 1, pick == 2, pick == 3, pick == 4],
                      [np.float32(0.0), np.float32(-0.0), np.float32(np.inf),
                       np.float32(-np.inf), np.float32(1e-42) * rng.integers(1, 4, (M, G))],
                      x).astype(np.float32)
        x[:, :: 7] = rng.choice(np.array([0.0, -0.0, 3e-45, -3e-45], np.float32), x[:, ::7].shape)
    elif pattern == "pads":        # K1 / K7 pad groups: -3e38 with a lane, few real groups
        lanes = (np.arange(G, dtype=np.int32) & 0x7F)
        pads = ((np.full(G, NEG_FINITE, np.float32).view(np.int32) & ~0x7F) | lanes)
        x = np.where(np.arange(G) < max(1, G // 50), x, pads.view(np.float32)[None, :])
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


def _equal(got, ref):
    gv, gi = got
    rv, ri = ref
    assert gv.shape == rv.shape and gi.dtype == torch.int64
    assert torch.equal(gi, ri)
    assert torch.equal(gv.view(torch.int32), rv.view(torch.int32))


# ---------------------------------------------------------------- CPU -----

def test_cpu_rows_take_topk_first():
    x = _rows("ties", 2, 127, 100, 7)
    _equal(row_topk(x, 100), topk_first(x, 100))


def test_cpu_takes_any_k():
    """The cap is the kernel's: CPU rows take topk_first at any k."""
    x = _rows("random", 2, 3000, MAX_K + 1, 8)
    _equal(row_topk(x, MAX_K + 1), topk_first(x, MAX_K + 1))


@pytest.mark.parametrize("x,match", [
    (torch.zeros(4, 8, dtype=torch.float64), "float32"),
    (torch.zeros(4, 8, dtype=torch.bfloat16), "float32"),
    (torch.zeros(4, 8, dtype=torch.int32), "float32"),
    (torch.zeros(8), "float32"),
    (torch.zeros(2, 4, 8), "float32"),
    (torch.zeros(8, 4).T, "contiguous"),
    (torch.zeros(4, 8, device="meta"), "unsupported device"),
])
def test_wrapper_refuses(x, match):
    with pytest.raises(ValueError, match=match):
        row_topk(x, 2)


def test_wrapper_refuses_a_negative_k():
    with pytest.raises(ValueError, match="k=-1"):
        row_topk(torch.zeros(2, 8), -1)


def test_max_k_is_the_kernel_s():
    """MAX_K is the kernel's kMaxK, the pairs its sort buffer holds (in the
    selection row_topk.cu shares with run_sums_topk.cu)."""
    csrc = ROOT / "qpp_fusion_rag_tpu_torch" / "csrc"
    assert '#include "row_select.cuh"' in (csrc / "row_topk.cu").read_text()
    src = (csrc / "row_select.cuh").read_text()
    assert f"constexpr int kSortCap = {MAX_K};" in src
    assert "constexpr int kMaxK = kSortCap;" in src


def _merge_inputs():
    g = torch.Generator().manual_seed(0)
    q = torch.randn(7, 32, generator=g)
    c = torch.randn(3000, 32, generator=g)
    rows, scale = dense_topk.quantize_rows(c)
    proj = torch.randn(5, 32, 32, generator=g) * 0.05
    return q, c, rows, scale[:, 0].contiguous(), proj


# each f32 dense merge: its call, the rows it merges, the width (groups) and k
MERGES = {
    "int8": (lambda q, c, rows, s, p: dense_topk.pallas_dense_topk_int8(q, rows, s, k=10),
             7, 24, 10),
    "int8.multi_view": (lambda q, c, rows, s, p: dense_topk.pallas_multi_view_topk_int8(
        q, p, rows, s, k=10), 35, 24, 10),
    "bf16.packed": (lambda q, c, rows, s, p: dense_topk.pallas_dense_topk(
        q, c.to(torch.bfloat16), k=40), 7, 24, 24),
    "bf16.multi_view": (lambda q, c, rows, s, p: dense_topk.pallas_multi_view_topk(
        q, p, c.to(torch.bfloat16), k=10), 35, 24, 10),
    "bf16.stride": (lambda q, c, rows, s, p: dense_topk.pallas_dense_topk(
        q, c.to(torch.bfloat16), k=5, tn=512, stride=4, packed=False), 7, 3072 // 512, 5),
}


@pytest.mark.parametrize("merge", MERGES)
def test_dense_merges_take_row_topk(merge, monkeypatch):
    """Each f32 dense merge is one row_topk call over all its rows, at
    min(k, groups), and returns what topk_first in its place returns."""
    call, M, G, k = MERGES[merge]
    inputs = _merge_inputs()
    seen = []

    def spy(x, kk):
        seen.append((tuple(x.shape), kk))
        return row_topk(x, kk)

    monkeypatch.setattr(dense_topk, "row_topk", spy)
    got = call(*inputs)
    assert seen == [((M, G), k)]
    monkeypatch.setattr(dense_topk, "row_topk", topk_first)
    ref = call(*inputs)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def _bench():
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from benchmark_torch.harness.bench import Bench
    return Bench(ROOT)


# bytes a merge: 4 M ceil(docs / 128) read, 12 M k written
@pytest.mark.parametrize("cell,nbytes", [
    ("nq-dense5.bf16-b1024", 4 * 5120 * 20_480 + 12 * 5120 * 100),
    ("nq-dense5.int8-b1024", 4 * 5120 * 20_480 + 12 * 5120 * 100),
    ("nq-ensemble.q8-b1024", 4 * 1024 * 20_480 + 12 * 1024 * 100),
    ("nq-ensemble-rs.q8r-b1024", 4 * 1024 * 20_480 + 12 * 1024 * 128),
])
def test_merge_roofline_counts_each_byte_once(cell, nbytes):
    bench = _bench()
    metric = bench.metric("merge_roofline")
    assert metric.work_s(bench.cell(cell)) == pytest.approx(nbytes / 3.35e12, rel=1e-12)


def test_merge_roofline_reads_the_kernel_time():
    bench = _bench()
    metric = bench.metric("merge_roofline")
    cell = bench.cell("nq-dense5.int8-b1024")
    name = "void (anonymous namespace)::row_topk_kernel(float const*, int, int, int, float*, " \
           "long long*)"
    summary = {"steps": 2, "cell": cell,
               "kernels": {name: {"calls": 2, "device_s": 2 * 0.4e-3},
                           "void at_cuda_detail::cub::DeviceSegmentedRadixSortKernel": {
                               "calls": 4, "device_s": 1.0}}}
    assert metric.read(summary) == pytest.approx(100 * 0.12704 / 0.4, rel=1e-4)
    summary["kernels"] = {}
    assert metric.read(summary) is None


# ---------------------------------------------------------------- card ----

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the row top-k kernel has no CPU mode")
    return torch.device("cuda")


def _on_card(x, k, cuda):
    """row_topk of x on the card (one launch, counted) and topk_first there."""
    xd = x.to(cuda)
    before = dict(LAUNCHES)
    got = row_topk(xd, k)
    torch.cuda.synchronize()
    assert LAUNCHES["row_topk"] == before.get("row_topk", 0) + 1
    assert sum(LAUNCHES.values()) == sum(before.values()) + 1
    return got, topk_first(xd, min(k, x.shape[1]))


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", ["random", "ties", "equal", "specials", "pads"])
@pytest.mark.parametrize("M,G,k", [
    (1, 1, 1), (1, 127, 100), (1024, 127, 1024), (1024, 20_480, 100), (1024, 20_480, 128),
    (5120, 20_480, 100), (64, 20_480, MAX_K), (64, 20_483, 100), (7, 20_482, 513),
    (3, STAGED, 100), (1, 20_480, 1), (3, STAGED + 1, 100), (1024, 69_077, 100),
    (2048, 69_076, 100), (64, 69_076, MAX_K), (7, 69_078, 513), (2, 100_003, 1)])
def test_kernel_bit_equal_to_topk_first_on_the_card(cuda, pattern, M, G, k):
    """Widths 20,483, 20,482, 69,077 and 69,078 are no multiple of the
    16-byte load (four f32): they take the 4-byte loads, as a row not
    16-byte aligned does. Rows over STAGED columns are read from global
    memory on each pass; 69,077 groups are MS MARCO's 8,841,823 docs."""
    x = _rows(pattern, M, G, k, M + G + k)
    got, ref = _on_card(x, k, cuda)
    _equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("G", [20_480, 69_076])
def test_kernel_takes_rows_not_16_byte_aligned(cuda, G):
    x = _rows("random", 9, G + 1, 100, 5).to(cuda)
    rows = x.reshape(-1)[1:1 + 9 * G].view(9, G)   # 4 bytes past the boundary
    assert rows.data_ptr() % 16 and rows.is_contiguous()
    _equal(row_topk(rows, 100), topk_first(rows, 100))


@pytest.mark.cuda
@pytest.mark.parametrize("kind,N", [("int8", 20_480 * 128), ("bf16", 20_480 * 128),
                                    ("int8", 8_841_823)])
def test_kernel_on_real_group_maxima(cuda, kind, N):
    """K1's and K7's packed maxima over 2,621,440 docs (20,480 groups) and
    K1's over 8,841,823 (69,077 groups, the last one ragged) at 1024 query
    rows: the merge's own inputs."""
    g = torch.Generator(device=cuda).manual_seed(11)
    D, M = 64, 1024
    c = torch.randn((N, D), generator=g, device=cuda)
    q = torch.randn((M, D), generator=g, device=cuda)
    if kind == "int8":
        rows, scale = dense_topk.quantize_rows(c)
        q_int, _ = dense_topk.quantize_rows(q)
        vals = dense_topk.group_max_packed_int8(q_int, rows, scale[:, 0].contiguous())
    else:
        vals = dense_topk.group_max_packed(q.to(torch.bfloat16), c.to(torch.bfloat16))
    for k in (100, 128, MAX_K):
        _equal(row_topk(vals, k), topk_first(vals, k))


@pytest.mark.cuda
def test_kernel_refuses_a_k_above_its_cap(cuda):
    x = _rows("random", 4, 3000, MAX_K + 1, 3).to(cuda)
    launches = LAUNCHES["row_topk"]
    with pytest.raises(ValueError, match=f"k={MAX_K + 1}"):
        row_topk(x, MAX_K + 1)
    assert LAUNCHES["row_topk"] == launches
    x = x[:, :300].contiguous()     # a k beyond the width takes the width
    _equal(row_topk(x, MAX_K + 1), topk_first(x, 300))


@pytest.mark.cuda
def test_kernel_waits_for_nothing(cuda):
    x = _rows("random", 1024, 20_480, 100, 3).to(cuda)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = row_topk(x, 100)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    _equal(got, topk_first(x, 100))
