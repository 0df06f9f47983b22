"""The CUDA kernels on the card: each against its plain version, and the
primitives on the ``cuda`` backend against the ``torch`` backend on the
same card. Skipped (with the reason) where no Hopper card is present;
run them on the card with

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import ctypes

import numpy as np
import pytest
import torch

from repro_torch.core import frontier as F
from repro_torch.core import graph as G
from repro_torch.core import operators as O
from repro_torch.core import ref as R
from repro_torch.core.primitives import (bc_batch, bfs_batch,
                                         connected_components,
                                         label_propagation, pagerank,
                                         reach_batch, sssp_batch,
                                         subgraph_match, triangle_count,
                                         triangle_count_full, who_to_follow)
from repro_torch.kernels import ops as K
from repro_torch.kernels import ref as P
from repro_torch.kernels import runtime
from repro_torch.linalg import ops as L
from repro_torch.linalg import semiring as SR

from _k5_cases import K5_CASES, k5_case

pytestmark = pytest.mark.cuda

# the kernels of the graph paths; lb_expand is the kernel API's and the
# tuner's (the primitives expand through K1 and K3)
GRAPH_KERNELS = ("advance_filter_batch", "compact", "advance_batch", "spmv",
                 "spmm", "segment_search", "lb_expand")


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    if torch.cuda.get_device_capability(0)[0] != 9:
        pytest.skip("the kernels are built for Hopper (sm_90a)")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def graph(card):
    return G.rmat(10, 8, seed=3, weighted=True, device=card)


def _frontier(g, b, seed):
    rng = np.random.default_rng(seed)
    mask = torch.from_numpy(rng.random((b, g.num_vertices)) < 0.05)
    return F.compact_indices_batch(mask.to(g.device), g.num_vertices,
                                   backend="torch")


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("cap_out", [512, None])
def test_advance_kernels_match_plain(graph, b, cap_out):
    g = graph
    cap = cap_out or g.num_edges
    front = _frontier(g, b, seed=b)
    base, sizes = O._base_and_sizes(g, front.ids, front.valid_mask, "vertex")
    want = P.advance_batch(g.row_offsets, g.col_indices, base, sizes, cap)
    for threads in (None, 64, 128, 256, 512, 1024):   # K3, every slot
        got = K.advance_batch(g.row_offsets, g.col_indices, base, sizes, cap,
                              threads=threads)
        assert all(torch.equal(x, y) for x, y in zip(got, want)), threads
    visited = torch.rand((b, g.num_vertices), device=g.device) < 0.3
    for _ in range(2):         # the first-slot table is reused clean
        got = K.advance_filter_batch(g.row_offsets, g.col_indices, base,
                                     sizes, visited, cap, 100, g.cache)
        want = P.advance_filter_batch(g.row_offsets, g.col_indices, base,
                                      sizes, visited, cap, 100)
        assert all(torch.equal(x, y) for x, y in zip(got, want))


def test_compact_kernel_matches_plain(card):
    mask = torch.rand((3, 5000), device=card) < 0.4
    vals = torch.randint(0, 99, (3, 5000), dtype=torch.int32, device=card)
    for v in (vals, vals[:1]):
        got = K.compact(v, mask)
        want = P.compact(v, mask)
        assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.parametrize("name", sorted(SR.SEMIRINGS))
def test_spmv_kernel_matches_plain_bitwise(graph, name):
    g = graph
    sr = SR.SEMIRINGS[name]
    x = torch.rand(g.num_vertices, device=g.device)
    mask = torch.rand(g.num_vertices, device=g.device) < 0.5
    for vals in (None, g.edge_values):
        for m in (None, mask):
            args = (g.row_offsets, g.col_indices, vals, x, sr, g.ell_width,
                    m, None, g.over_pos, g.over_row)
            got = K.spmv(*args).cpu()
            # the plain version on the CPU folds the overflow in edge order
            want = P.spmv(*(a.cpu() if torch.is_tensor(a) else a
                            for a in args))
            assert torch.equal(got, want)


def test_kernels_on_edgeless_graph(card):
    """m = 0: every slot is dead, so the kernels never read the columns;
    they run (no fallback) and match the plain versions."""
    g = G.Graph.from_csr(np.zeros(9, np.int32), np.zeros(0, np.int32),
                         np.zeros(0, np.float32), device=card)
    front = _frontier(g, 2, seed=0)
    base, sizes = O._base_and_sizes(g, front.ids, front.valid_mask, "vertex")
    visited = torch.zeros((2, 8), dtype=torch.bool, device=card)
    K.reset_launches()
    for got, want in (
            (K.advance_batch(g.row_offsets, g.col_indices, base, sizes, 512),
             P.advance_batch(g.row_offsets, g.col_indices, base, sizes,
                             512)),
            (K.advance_filter_batch(g.row_offsets, g.col_indices, base,
                                    sizes, visited, 512, 8, g.cache),
             P.advance_filter_batch(g.row_offsets, g.col_indices, base,
                                    sizes, visited, 512, 8))):
        assert all(torch.equal(x, y) for x, y in zip(got, want))
    x = torch.rand(8, device=card)
    args = (g.row_offsets, g.col_indices, None, x, SR.plus_times,
            g.ell_width, None, None, g.over_pos, g.over_row)
    assert torch.equal(K.spmv(*args), P.spmv(*args))
    for run in (lambda bk: bfs_batch(g, [0, 3], backend=bk),
                lambda bk: sssp_batch(g, [0, 3], delta=1.0, backend=bk)):
        a, b = run("cuda"), run("torch")
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    # K5 on the empty haystack reads nothing and finds nothing
    lo = torch.zeros((5000,), dtype=torch.int32, device=card)
    needles = torch.arange(5000, dtype=torch.int32, device=card)
    assert not K.segment_search(g.col_indices, lo, lo + 2, needles).any()
    assert (K.segment_locate(g.col_indices, lo, lo, needles) == -1).all()
    # K4m: every row empty, every output the ⊕-identity
    block = torch.rand((8, 3), device=card)
    args = (g.row_offsets, g.col_indices, None, block, SR.min_plus,
            g.ell_width, None, g.row_seg)
    assert torch.equal(K.spmm(*args), P.spmm(*args))
    # K6 over the edgeless graph's all-zero degrees: no slot is valid
    sizes0 = g.degrees.to(torch.int32)
    got, want = K.lb_expand(sizes0, 700), K.lb_expand(sizes0.cpu(), 700)
    assert all(torch.equal(x.cpu(), y) for x, y in zip(got, want))
    assert all(K.KERNELS[k].launches > 0 for k in GRAPH_KERNELS)
    # segmented_intersect on the edgeless graph: K3, K5 and K2 launch
    fa = F.SparseFrontier(ids=torch.tensor([0, 3, 5, -1], dtype=torch.int32,
                                           device=card),
                          length=torch.tensor(3, dtype=torch.int32,
                                              device=card))
    fb = F.SparseFrontier(ids=torch.tensor([1, 3, 7, -1], dtype=torch.int32,
                                           device=card),
                          length=torch.tensor(3, dtype=torch.int32,
                                              device=card))
    K.reset_launches()
    a = O.segmented_intersect(g, fa, fb, 512, backend="cuda")
    for name in ("advance_batch", "segment_search", "compact"):
        assert K.KERNELS[name].launches > 0, name
    b = O.segmented_intersect(g, fa, fb, 512, backend="torch")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert int(a.total) == 0 and int(a.length) == 0


def test_primitives_cuda_match_torch_backend(graph):
    g = graph
    srcs = [int(torch.argmax(g.degrees)), 5, 77]
    K.reset_launches()
    for run in (lambda bk: bfs_batch(g, srcs, backend=bk),
                lambda bk: sssp_batch(g, srcs, delta=40.0, backend=bk)):
        a, b = run("cuda"), run("torch")
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    # relative per vertex: the plain overflow fold on the card is an
    # atomic index_add_, so the two differ only by the order of its adds
    a, b = pagerank(g, backend="cuda"), pagerank(g, backend="torch")
    assert float(((a.rank - b.rank).abs() / b.rank).max()) <= 1e-5
    a, b = triangle_count(g, backend="cuda"), triangle_count(g,
                                                             backend="torch")
    assert torch.equal(a.per_edge, b.per_edge)
    a, b = (reach_batch(g, srcs, 2, backend="cuda"),
            reach_batch(g, srcs, 2, backend="torch"))
    assert torch.equal(a.reached, b.reached)
    assert all(K.KERNELS[k].launches > 0 for k in GRAPH_KERNELS[:-1])


def _probes(g, count, seed):
    """Whole-row probes of the CSR columns, half of them hits, with
    empty segments and -1 padding lanes."""
    rng = np.random.default_rng(seed)
    ro = g.row_offsets.cpu().numpy()
    ci = g.col_indices.cpu().numpy()
    rows = rng.integers(0, g.num_vertices, size=count)
    lo, hi = ro[rows], ro[rows + 1]
    pick = lo + (rng.random(count) * np.maximum(hi - lo, 1)).astype(np.int64)
    needles = np.where(rng.random(count) < 0.5,
                       ci[np.minimum(pick, len(ci) - 1)],
                       rng.integers(0, g.num_vertices, size=count))
    hi = np.where(rng.random(count) < 0.05, lo, hi)
    lo[-100:], hi[-100:], needles[-100:] = 0, 0, -1
    return [torch.from_numpy(a.astype(np.int32)).to(g.device)
            for a in (lo, hi, needles)]


def test_segment_search_kernel_matches_plain(graph):
    g = graph
    lo, hi, needles = _probes(g, 300_000, seed=7)
    K.reset_launches()
    found = K.segment_search(g.col_indices, lo, hi, needles)
    pos = K.segment_locate(g.col_indices, lo, hi, needles)
    assert K.KERNELS["segment_search"].launches == 2
    assert found.dtype == torch.bool and pos.dtype == torch.int32
    assert torch.equal(found, P.segment_search(g.col_indices, lo, hi,
                                               needles))
    assert torch.equal(pos, P.segment_locate(g.col_indices, lo, hi,
                                             needles))
    assert torch.equal(found, pos >= 0) and int(found.sum()) > 1000


def test_mxm_tc_intersect_cuda_match_torch_backend(graph):
    g = graph
    ro = g.row_offsets.cpu().numpy()
    mask = (np.repeat(np.arange(g.num_vertices, dtype=np.int32),
                      np.diff(ro)), g.col_indices.cpu().numpy())
    K.reset_launches()
    for kw in (dict(semiring="plus_and", b_transpose=True,
                    structural=True), dict(semiring="min_plus")):
        a = L.mxm(g, g, mask, backend="cuda", **kw)
        b = L.mxm(g, g, mask, backend="torch", **kw)
        assert torch.equal(a, b)
    a, b = triangle_count(g, backend="cuda"), triangle_count(g,
                                                             backend="torch")
    assert torch.equal(a.per_edge, b.per_edge)
    assert int(a.total) == R.tc_ref(g)
    assert int(triangle_count_full(g, backend="cuda")) == int(a.total)
    fa = F.compact_indices(torch.rand(g.num_vertices, device=g.device)
                           < 0.3, 200, backend="torch")
    fb = F.SparseFrontier(ids=torch.where(fa.valid_mask,
                                          (fa.ids * 7 + 3)
                                          % g.num_vertices, -1),
                          length=fa.length)
    a = O.segmented_intersect(g, fa, fb, 1 << 16, backend="cuda")
    b = O.segmented_intersect(g, fa, fb, 1 << 16, backend="torch")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert K.KERNELS["segment_search"].launches > 0
    assert K.KERNELS["advance_batch"].launches > 0


def test_cc_bc_on_the_card_match_oracles(graph):
    g = graph
    r = connected_components(g, backend="cuda")
    assert np.array_equal(r.labels.cpu().numpy(), R.cc_ref(g))
    srcs = [int(torch.argmax(g.degrees)), 5, 77]
    r = bc_batch(g, srcs, backend="cuda")
    for i, s in enumerate(srcs):
        np.testing.assert_allclose(r.bc[i].cpu().numpy(), R.bc_ref(g, s),
                                   rtol=1e-3, atol=1e-3)


@pytest.fixture(scope="module")
def heavy_graph(card):
    """rmat scale 14: rows above and below K4m's split threshold
    (SPMM_SPLIT edges)."""
    return G.rmat(14, 16, seed=1, weighted=True, device=card)


@pytest.mark.parametrize("name", sorted(SR.SEMIRINGS))
@pytest.mark.parametrize("k", [1, 4, 5, 32, 33])
def test_spmm_kernel_matches_plain_bitwise(heavy_graph, name, k):
    """Integer-valued X and integer weights: every semiring's fold is
    exact, so the kernel's fixed order and the plain version's (atomic
    adds on the card) give the same bits, on light rows and on the rows
    split over a block."""
    g = heavy_graph
    sr = SR.SEMIRINGS[name]
    gen = torch.Generator(device=g.device).manual_seed(k)
    x = torch.randint(0, 4, (g.num_vertices, k), generator=gen,
                      device=g.device).to(torch.float32)
    mask = torch.rand(g.num_vertices, generator=gen, device=g.device) < 0.5
    K.reset_launches()
    for vals in (None, g.edge_values):
        for m in (None, mask):
            args = (g.row_offsets, g.col_indices, vals, x, sr, g.ell_width,
                    m, g.row_seg)
            assert torch.equal(K.spmm(*args), P.spmm(*args))
    assert K.KERNELS["spmm"].launches == 4


@pytest.mark.parametrize("k", [1, 3, 4, 5, 32, 33, 64])
def test_spmm_kernel_float_plus_times(heavy_graph, k):
    """General floats: a row of at most SPMM_SPLIT edges is folded by one
    group, each column in ascending edge order, the plain version's order
    on the CPU, so the two are bit-equal there at every k; a longer row's
    shares regroup the sum (rtol 1e-5, the reference's own limit between
    its providers)."""
    g = heavy_graph
    unsplit = (g.degrees <= K.SPMM_SPLIT).cpu()
    assert 0 < int((~unsplit).sum()) < g.num_vertices
    x = torch.rand((g.num_vertices, k), device=g.device)
    args = (g.row_offsets, g.col_indices, g.edge_values, x, SR.plus_times,
            g.ell_width, None, g.row_seg)
    got = K.spmm(*args).cpu()
    want = P.spmm(*(a.cpu() if torch.is_tensor(a) else a for a in args))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got[unsplit], want[unsplit])
    # an X that is no 16-byte aligned view takes the scalar gathers
    if k % 4 == 0:
        xv = torch.rand(g.num_vertices * k + 1, device=g.device)[1:].view(
            g.num_vertices, k)
        args = args[:3] + (xv,) + args[4:]
        got = K.spmm(*args).cpu()
        want = P.spmm(*(a.cpu() if torch.is_tensor(a) else a for a in args))
        assert torch.equal(got[unsplit], want[unsplit])


def test_spmm_long_rows_fresh_after_inplace_edit(card):
    """K4m's long-row list is keyed on the offsets' version: after an
    in-place edit that moves a long row, the kernel gets a fresh list and
    writes every row as the plain version does."""
    rng = np.random.default_rng(4)
    n = 3000
    deg = rng.integers(0, 20, n)
    deg[0], deg[7] = 5000, 300
    offsets = torch.from_numpy(np.concatenate([[0], np.cumsum(deg)])
                               .astype(np.int32)).to(card)
    m = int(deg.sum())
    cols = torch.from_numpy(rng.integers(0, n, m).astype(np.int32)).to(card)
    x = torch.randint(0, 5, (n, 32), device=card).to(torch.float32)
    args = (cols, None, x, SR.plus_times, 1, None)
    rows, nsplit = K.heavy_rows(offsets, K.SPMM_LONG, K.SPMM_SPLIT)
    assert rows[:2].tolist() == [0, 7] and nsplit == 2
    assert torch.equal(K.spmm(offsets, *args).cpu(),
                       P.spmm(offsets.cpu(), *(a.cpu() if torch.is_tensor(a)
                                               else a for a in args)))
    offsets[1] = 0                  # row 0 empties into row 1
    fresh, nsplit = K.heavy_rows(offsets, K.SPMM_LONG, K.SPMM_SPLIT)
    assert fresh is not rows and fresh[:2].tolist() == [1, 7]
    assert torch.equal(K.spmm(offsets, *args).cpu(),
                       P.spmm(offsets.cpu(), *(a.cpu() if torch.is_tensor(a)
                                               else a for a in args)))


def test_spmm_kernel_refusals(graph):
    g = graph
    x = torch.ones((g.num_vertices, 2), device=g.device)
    with pytest.raises(ValueError, match="x has shape"):
        K.spmm(g.row_offsets, g.col_indices, None, x[:, 0], SR.or_and,
               g.ell_width, None)
    with pytest.raises(ValueError, match="mask"):
        K.spmm(g.row_offsets, g.col_indices, None, x, SR.or_and,
               g.ell_width, torch.ones(3, dtype=torch.bool,
                                       device=g.device))
    # (2^21 + 1) empty rows x 1024 columns: n*k passes int32
    offsets = torch.zeros(2 ** 21 + 2, dtype=torch.int32, device=g.device)
    with pytest.raises(ValueError, match="beyond int32"):
        K.spmm(offsets, g.col_indices[:0], None,
               torch.ones((1, 1024), device=g.device), SR.or_and, 1, None)


def test_third_slice_primitives_cuda_match_torch_backend(graph):
    g = graph
    srcs = [int(torch.argmax(g.degrees)), 5, 77, 5]
    K.reset_launches()
    a, b = reach_batch(g, srcs, 3, backend="cuda"), reach_batch(
        g, srcs, 3, backend="torch")
    assert torch.equal(a.reached, b.reached)
    for i, s in enumerate(srcs):
        assert np.array_equal(a.reached[i].cpu().numpy(),
                              R.reach_ref(g, s, 3))
    a = label_propagation(g, max_iter=8, backend="cuda")
    b = label_propagation(g, max_iter=8, backend="torch")
    assert torch.equal(a.labels, b.labels) and a.iterations == b.iterations
    labels, iters = R.label_propagation_ref(g, max_iter=8)
    assert np.array_equal(a.labels.cpu().numpy(), labels)
    assert a.iterations == iters
    assert K.KERNELS["spmm"].launches > 0
    u = srcs[0]
    w = who_to_follow(g, u, k=50, backend="cuda")
    np.testing.assert_allclose(w.ppr.cpu().numpy(), R.ppr_ref(g, u),
                               rtol=0, atol=1e-5)
    K.reset_launches()
    tri = subgraph_match(g, 3, [(0, 1), (0, 2), (1, 2)], cap=1 << 20,
                         backend="cuda")
    assert tri.count == 6 * R.tc_ref(g) and not tri.truncated
    assert K.KERNELS["segment_search"].launches > 0
    assert K.KERNELS["compact"].launches > 0
    ref = subgraph_match(g, 3, [(0, 1), (0, 2), (1, 2)], cap=1 << 20,
                         backend="torch")
    assert torch.equal(tri.embeddings, ref.embeddings)


# ---- the fourth slice: K6-K8, block sizes, the tuner ----------------------

@pytest.mark.parametrize("cap_in,cap_out", [(0, 5), (1, 8), (17, 100),
                                            (500, 513), (3000, 70_000),
                                            (40, 7), (20_000, 9_000),
                                            (0, 0)])
def test_lb_expand_kernel_matches_plain_on_every_slot(card, cap_in,
                                                      cap_out):
    """K6 at every block size, every slot (past the total too): zero-size
    segments, totals past cap_out, a segment spanning many tiles, tiles
    spanning many segments, a trailing empty segment."""
    rng = np.random.default_rng(cap_in + cap_out)
    sizes = torch.from_numpy(rng.integers(0, 40, cap_in).astype(np.int32))
    sizes[::7] = 0                              # zero-size segments
    if cap_in == 20_000:
        sizes = (torch.rand(cap_in, generator=torch.Generator().manual_seed(
            1)) < 0.05).to(torch.int32)         # tiles spanning many
        sizes[5] = 3 * K.LB_TILE_SLOTS + 11     # a segment spanning many
        sizes[-1] = 0
    want = K.lb_expand(sizes, cap_out)
    K.reset_launches()
    for threads in (None, 64, 128, 256, 512, 1024):
        got = K.lb_expand(sizes.to(card), cap_out, threads=threads)
        assert all(torch.equal(x.cpu(), y) for x, y in zip(got, want)), \
            threads
    assert K.KERNELS["lb_expand"].launches == 6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("sq,sk,d,causal", [
    (64, 64, 32, True), (128, 128, 64, True), (100, 37, 16, True),
    (16, 256, 64, False), (300, 700, 112, True), (77, 700, 256, True),
    (130, 129, 128, False), (700, 300, 8, True)])
def test_flash_attention_kernel_matches_plain(card, dtype, sq, sk, d,
                                              causal):
    gen = torch.Generator(device=card).manual_seed(sq * d)
    q, k, v = (torch.randn((n, d), generator=gen, device=card).to(dtype)
               for n in (sq, sk, sk))
    got = K.flash_attention(q, k, v, causal=causal)
    want = P.flash_attention(q, k, v, causal=causal)
    assert got.dtype == dtype
    # both compute in fp32: fp32 within the reference's 3e-5, bf16 and
    # fp16 within one rounding of the output (an ulp is at most 2^-7 and
    # 2^-10 of the value)
    rtol, atol = {torch.float32: (3e-5, 3e-5), torch.bfloat16: (8e-3, 1e-4),
                  torch.float16: (1e-3, 1e-5)}[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)
    if causal and sq > sk:                      # rows that see no key
        assert (got[:sq - sk] == 0).all()


def test_flash_attention_kernel_refusals(card):
    q = torch.randn((16, 264), device=card)
    with pytest.raises(ValueError, match="head width"):
        K.flash_attention(q, q, q)
    q = torch.randn((16, 12), device=card)
    with pytest.raises(ValueError, match="head width"):
        K.flash_attention(q, q, q)
    q = torch.randn((16, 16), device=card)
    with pytest.raises(ValueError, match="dtype"):
        K.flash_attention(q, q.half(), q)
    # the split form's one C call refuses what K7 or K7c cannot take (a
    # head width that is no multiple of 8 or past 256, fewer than 2
    # parts), and the wrapper's launch raises on the refusal
    ws = torch.empty((4 * 16 * 272,), device=card)
    for d, nsplit in ((12, 4), (264, 4), (6, 4), (16, 1)):
        with pytest.raises(RuntimeError, match="launch failed"):
            K._launch("flash_attention", "attention",
                      "flash_attention_split", 0, q, q, q, q, ws, ws, 16,
                      16, d, ctypes.c_float(0.25), 1, nsplit,
                      runtime.stream_ptr(card))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("t,d,s", [(10, 8, 30), (128, 64, 128), (50, 7, 9),
                                   (300, 7168, 1000), (33, 5, 70)])
def test_moe_gather_kernel_matches_plain_bitwise(card, dtype, t, d, s):
    gen = torch.Generator(device=card).manual_seed(t + d)
    x = torch.randn((t, d), generator=gen, device=card).to(dtype)
    slot = torch.randint(-1, t + 3, (s,), generator=gen, device=card,
                         dtype=torch.int32)       # some ids past the end
    slot[::5] = -1
    got = K.moe_gather(x, slot)
    assert torch.equal(got, P.moe_gather(x, slot))
    assert torch.equal(got.cpu(), K.moe_gather(x.cpu(), slot.cpu()))
    # an unaligned view of x takes the narrow copy
    xv = x.reshape(-1)[1:1 + (t - 1) * d].view(t - 1, d)
    assert torch.equal(K.moe_gather(xv, slot), P.moe_gather(xv, slot))


@pytest.mark.parametrize("case", ["unsorted_repeated", "all_empty",
                                  "odd_width"])
def test_moe_gather_kernel_slot_orders(card, case):
    """K8 orders the slots by token (a counting sort) and copies each row
    to its slots: an unsorted slot_token with repeated ids, one that is
    all -1, and rows of an odd bf16 width (the 2-byte copies), bit-equal
    to the plain version."""
    gen = torch.Generator(device=card).manual_seed(len(case))
    t, d = 200, 7 if case == "odd_width" else 512
    x = torch.randn((t, d), generator=gen, device=card).to(torch.bfloat16)
    if case == "all_empty":
        slot = torch.full((333,), -1, dtype=torch.int32, device=card)
    else:
        slot = torch.randint(0, 6, (500,), generator=gen, device=card,
                             dtype=torch.int32)
        slot[::7] = -1
        slot[::11] = t + 5
        slot = slot[torch.randperm(500, generator=gen, device=card)]
    K.reset_launches()
    got = K.moe_gather(x, slot)
    assert K.KERNELS["moe_gather"].launches == 1
    assert torch.equal(got, P.moe_gather(x, slot))
    if case == "all_empty":
        assert not got.any()


@pytest.mark.parametrize("threads", [64, 128, 256, 512, 1024])
def test_tuned_kernels_are_block_size_invariant(graph, threads):
    """Every tuned kernel gives its plain version's bits at every
    candidate block size."""
    g = graph
    front = _frontier(g, 3, seed=4)
    base, sizes = O._base_and_sizes(g, front.ids, front.valid_mask, "vertex")
    ro, ci = g.row_offsets, g.col_indices
    cap = g.num_edges
    got = K.advance_batch(ro, ci, base, sizes, cap, threads=threads)
    assert all(torch.equal(x, y) for x, y in
               zip(got, P.advance_batch(ro, ci, base, sizes, cap)))
    visited = torch.rand((3, g.num_vertices), device=g.device) < 0.3
    got = K.advance_filter_batch(ro, ci, base, sizes, visited, cap, 100,
                                 g.cache, threads=threads)
    assert all(torch.equal(x, y) for x, y in zip(got, P.advance_filter_batch(
        ro, ci, base, sizes, visited, cap, 100)))
    mask = torch.rand((3, 5000), device=g.device) < 0.4
    vals = torch.randint(0, 99, (3, 5000), dtype=torch.int32,
                         device=g.device)
    assert all(torch.equal(x, y) for x, y in zip(
        K.compact(vals, mask, threads=threads), P.compact(vals, mask)))
    x = torch.rand(g.num_vertices, device=g.device)
    args = (g.row_offsets, g.col_indices, g.edge_values, x, SR.min_plus,
            g.ell_width, None, g.row_seg, g.over_pos, g.over_row)
    assert torch.equal(K.spmv(*args, threads=threads), P.spmv(*args))
    lo, hi, needles = _probes(g, 20_000, seed=threads)
    assert torch.equal(K.segment_search(ci, lo, hi, needles,
                                        threads=threads),
                       P.segment_search(ci, lo, hi, needles))
    assert torch.equal(K.segment_locate(ci, lo, hi, needles,
                                        threads=threads),
                       P.segment_locate(ci, lo, hi, needles))
    got = K.lb_expand(g.degrees.to(torch.int32), cap + 999, threads=threads)
    want = K.lb_expand(g.degrees.to(torch.int32).cpu(), cap + 999)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))


def test_autotune_on_the_card(card, tmp_path):
    from repro_torch.kernels import tuner
    path = tmp_path / "tune.json"
    tuner.set_cache(path)
    try:
        picked = tuner.autotune_all([512, 4096])
        assert sorted({op for op, _, _ in picked}) == sorted(tuner.PROBES)
        assert ("advance", 512, "delta") in picked
        for (op, cap, enc), tile in picked.items():
            assert tile in tuner.candidates(cap)
            assert tuner.tile_for(op, cap, encoding=enc, device=card) == tile
            assert tuner.entry(op, cap, card, encoding=enc)["ms"] > 0
        assert tuner.tier_floor("advance", 512, device=card) >= 512
    finally:
        tuner.set_cache(None)
    assert tuner.tile_for("advance", 4096, device=card) == 256


# ---- K4 and K7 redesigned: heavy rows first, tensor cores ------------------

def _star_csr(seed: int):
    """A CSR whose row 0 has 120,000 edges, 40 rows 2,100-5,000 (past the
    kernel's very-heavy threshold at width <= 33), 3,000 rows 5-300, rows of exactly 16 and
    17 edges and the rest 0-6; weights and x of both signs."""
    rng = np.random.default_rng(seed)
    n = 130_001
    deg = rng.integers(0, 7, n)
    deg[0] = 120_000
    rest = rng.permutation(np.arange(1, n))
    deg[rest[:40]] = rng.integers(2100, 5000, 40)
    deg[rest[40:3040]] = rng.integers(5, 300, 3000)
    deg[rest[3040:3240]] = 16
    deg[rest[3240:3440]] = 17
    ro = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    ci = rng.integers(0, n, int(ro[-1])).astype(np.int32)
    vals = rng.standard_normal(int(ro[-1])).astype(np.float32)
    x = rng.standard_normal(n).astype(np.float32)
    return ro, ci, vals, x


def _over_lists(ro: np.ndarray, width: int):
    seg = np.repeat(np.arange(len(ro) - 1, dtype=np.int32), np.diff(ro))
    return tuple(torch.from_numpy(a) for a in
                 G._overflow_edges(ro, seg, width))


@pytest.mark.parametrize("name", sorted(SR.SEMIRINGS))
def test_spmv_kernel_heavy_rows_bitwise(card, name):
    """K4 bit for bit with its plain version on the CPU on a star graph
    (one row of 120,000 edges, rows past the very-heavy threshold, rows of
    exactly width and width + 1 edges), negative weights and x, masked
    heavy rows, at widths 1 ... 1024 and block sizes 64 ... 1024."""
    sr = SR.SEMIRINGS[name]
    ro, ci, vals, x = _star_csr(7)
    cpu = {"ro": torch.from_numpy(ro), "ci": torch.from_numpy(ci),
           "vals": torch.from_numpy(vals), "x": torch.from_numpy(x)}
    dev = {k: t.to(card) for k, t in cpu.items()}
    mask = torch.from_numpy(np.random.default_rng(8).random(len(x)) < 0.5)
    for width in (1, 16, 33, 100, 1024):
        opos, orow = _over_lists(ro, width)
        for use_vals in (False, True):
            for m in (None, mask, ~mask):
                want = P.spmv(cpu["ro"], cpu["ci"],
                              cpu["vals"] if use_vals else None, cpu["x"],
                              sr, width, m, None, opos, orow)
                for threads in (64, 256, 1024):
                    got = K.spmv(dev["ro"], dev["ci"],
                                 dev["vals"] if use_vals else None,
                                 dev["x"], sr, width,
                                 None if m is None else m.to(card), None,
                                 None, None, threads=threads)
                    assert torch.equal(got.cpu(), want), (width, use_vals,
                                                          threads)


def test_spmv_heavy_rows_schedule(card):
    """The heavy-row list: rows of degree > width by degree, largest
    first, ties in row order; those past the very-heavy threshold lead."""
    ro, _, _, _ = _star_csr(7)
    offsets = torch.from_numpy(ro).to(card)
    heavy, nvery = K.spmv_heavy_rows(offsets, 16)
    deg = np.diff(ro)
    want = np.nonzero(deg > 16)[0]
    want = want[np.argsort(-deg[want], kind="stable")]
    assert np.array_equal(heavy.cpu().numpy(), want)
    assert nvery == int((deg - 16 > K.SPMV_BLOCK_OVER).sum()) == 41
    assert K.spmv_heavy_rows(offsets, 16)[0] is heavy     # made once


ATTN_TOL = {torch.float32: (3e-5, 3e-5), torch.bfloat16: (8e-3, 1e-4),
            torch.float16: (1e-3, 1e-5)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("sq", [1, 16, 128])
@pytest.mark.parametrize("sk", [4096, 8192])
@pytest.mark.parametrize("d", [128, 112])
def test_flash_attention_split_kv_matches_plain(card, dtype, sq, sk, d):
    """Few queries against many keys: the kv axis split over blocks and
    merged by the combine kernel (one C call: K7, then K7c as its
    programmatic dependent launch), within the unchanged limits; one
    launch of each, and repeated calls bit-equal."""
    gen = torch.Generator(device=card).manual_seed(sq + sk + d)
    q, k, v = (torch.randn((n, d), generator=gen, device=card).to(dtype)
               for n in (sq, sk, sk))
    assert K.attention_splits(sq, sk, dtype, K.sm_count(card)) > 1
    K.reset_launches()
    got = K.flash_attention(q, k, v, causal=True)
    assert K.KERNELS["flash_attention"].launches == 1
    assert K.KERNELS["attention_combine"].launches == 1
    rtol, atol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(),
                               P.flash_attention(q, k, v, True).float(),
                               rtol=rtol, atol=atol)
    assert torch.equal(got, K.flash_attention(q, k, v, causal=True))


def _combine_parts(card, nsplit, sq, d, seed):
    """Split-form parts (acc (nsplit, Sq, D), ml (nsplit, Sq, 2)) drawn
    at random: about 30 % of the parts see no key (m = -1e30, l = 0, acc
    = 0), and so do all parts of the last 3 rows."""
    gen = torch.Generator(device=card).manual_seed(seed)
    m = 3 * torch.randn((nsplit, sq), generator=gen, device=card)
    l = 1 + 50 * torch.rand((nsplit, sq), generator=gen, device=card)
    acc = l[..., None] * torch.randn((nsplit, sq, d), generator=gen,
                                     device=card)
    empty = torch.rand((nsplit, sq), generator=gen, device=card) < 0.3
    empty[:, -3:] = True
    m = m.masked_fill(empty, P.ATTN_NEG)
    l = l.masked_fill(empty, 0.0)
    acc = acc.masked_fill(empty[..., None], 0.0)
    return acc, torch.stack([m, l], dim=-1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("nsplit", [2, 7, 12, 30, 64, 128, 2100])
@pytest.mark.parametrize("d", [8, 24, 40, 112, 128, 256, 10, 50])
def test_attention_combine_kernel_matches_plain(card, dtype, nsplit, d):
    """K7c against its plain version: 1, 2, 4 and 8 warps a row (up to 8,
    16, 32 parts and more; 37 rows leave a block part empty), float4
    columns (D % 4 = 0), float2 columns (D = 10, 50), more parts than one
    chunk of staged weights (2,100 > 2,048); within ATTN_TOL, rows that
    see no key exactly 0, repeated calls bit-equal."""
    acc, ml = _combine_parts(card, nsplit, 37, d, seed=nsplit * 1000 + d)
    K.reset_launches()
    out = K.attention_combine(acc, ml, dtype)
    assert K.KERNELS["attention_combine"].launches == 1
    assert out.dtype == dtype and out.shape == (37, d)
    assert torch.equal(out, K.attention_combine(acc, ml, dtype))
    rtol, atol = ATTN_TOL[dtype]
    torch.testing.assert_close(out.float(),
                               P.attention_combine(acc, ml, dtype).float(),
                               rtol=rtol, atol=atol)
    assert (out[-3:] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("d", [8, 24, 40, 112, 256])
def test_flash_attention_head_widths_match_plain(card, dtype, d):
    """Head widths padded with zeros in shared memory, causal and not."""
    gen = torch.Generator(device=card).manual_seed(d)
    q, k, v = (torch.randn((n, d), generator=gen, device=card).to(dtype)
               for n in (333, 517, 517))
    rtol, atol = ATTN_TOL[dtype]
    for causal in (True, False):
        got = K.flash_attention(q, k, v, causal=causal)
        torch.testing.assert_close(
            got.float(), P.flash_attention(q, k, v, causal).float(),
            rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_flash_attention_parts_that_see_no_key(card, dtype):
    """Causal Sq > Sk: whole q tiles and whole parts see no key. Their
    parts carry m = -1e30, l = 0, acc = 0, the combine gives exactly 0
    on the rows that see none, and each kernel agrees with its plain
    version."""
    gen = torch.Generator(device=card).manual_seed(11)
    sq, sk, d = 1000, 300, 64
    q, k, v = (torch.randn((n, d), generator=gen, device=card).to(dtype)
               for n in (sq, sk, sk))
    rtol, atol = ATTN_TOL[dtype]
    assert K.attention_splits(sq, sk, dtype, K.sm_count(card)) > 1
    got = K.flash_attention(q, k, v, causal=True)
    assert (got[:sq - sk] == 0).all()
    torch.testing.assert_close(got.float(),
                               P.flash_attention(q, k, v, True).float(),
                               rtol=rtol, atol=atol)
    acc, ml = K.attention_partials(q, k, v, True, 7)
    pacc, pml = P.attention_partials(q, k, v, True, 7)
    empty = pml[..., 1] == 0
    assert bool(empty.any()) and bool((~empty).any())
    assert torch.equal(ml[..., 0][empty], pml[..., 0][empty])
    assert (ml[..., 1][empty] == 0).all() and (acc[empty] == 0).all()
    torch.testing.assert_close(ml[..., 0], pml[..., 0], rtol=1e-5,
                               atol=1e-5)
    den = pml[..., 1:].clamp_min(1e-30)
    torch.testing.assert_close(acc / ml[..., 1:].clamp_min(1e-30),
                               pacc / den, rtol=1e-4, atol=1e-5)
    out = K.attention_combine(acc, ml, dtype)
    assert torch.equal(out, K.attention_combine(acc, ml, dtype))
    torch.testing.assert_close(out.float(),
                               P.attention_combine(acc, ml, dtype).float(),
                               rtol=rtol, atol=atol)
    assert (out[:sq - sk] == 0).all()


# ---- storage plans: K1 / K3 column variants, K4 / K4m in bf16, K5 at the
# plan's index dtype -------------------------------------------------------

PLANS = {"int16": {}, "int32": {"index_dtype": "int32"},
         "int64": {"index_dtype": "int64"}, "delta": {"encoding": "delta"}}


@pytest.fixture(scope="module")
def plan_graphs(card):
    """One weighted grid (escape-free under delta) and one rmat whose
    delta stream has escapes (n > 2^16, ids permuted), under each plan."""
    out = {}
    for kind, make in (("grid", lambda **kw: G.grid2d(40, weighted=True,
                                                      seed=3, device=card,
                                                      **kw)),
                       ("rmat", lambda **kw: G.rmat(17, 2, seed=5,
                                                    weighted=True,
                                                    device=card, **kw))):
        for plan, kw in PLANS.items():
            if kind == "rmat" and plan == "int16":
                continue
            out[kind, plan] = make(**kw)
    return out


@pytest.mark.parametrize("kind,plan", [("grid", p) for p in PLANS]
                         + [("rmat", "delta"), ("rmat", "int64")])
def test_advance_kernels_column_variants(plan_graphs, kind, plan):
    """K1 and K3 read every column store as their plain versions do; the
    launch lands in its variant's counter (an escaped delta stream runs
    the decoded dense view)."""
    g = plan_graphs[kind, plan]
    store = g.col_store
    want_variant = plan
    if plan == "delta" and store.num_escapes:
        want_variant = "dense_fallback"
    front = _frontier(g, 3, seed=1)
    base, sizes = O._base_and_sizes(g, front.ids, front.valid_mask, "vertex")
    visited = torch.rand((3, g.num_vertices), device=g.device) < 0.3
    K.reset_launches()
    for cap in (512, g.num_edges):
        got = K.advance_batch(g.row_offsets, store, base, sizes, cap,
                              g.cache)
        want = P.advance_batch(g.row_offsets, store, base, sizes, cap)
        assert all(torch.equal(x, y) for x, y in zip(got, want))
        for threads in (64, 128, 512, 1024):     # K3 at every block size
            assert all(torch.equal(x, y) for x, y in zip(K.advance_batch(
                g.row_offsets, store, base, sizes, cap, g.cache,
                threads=threads), want)), threads
        got = K.advance_filter_batch(g.row_offsets, store, base, sizes,
                                     visited, cap, 100, g.cache)
        want = P.advance_filter_batch(g.row_offsets, store, base, sizes,
                                      visited, cap, 100)
        assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert K.KERNELS["advance_batch"].variants == {want_variant: 10}
    assert K.KERNELS["advance_filter_batch"].variants == {want_variant: 2}


def test_delta_grid_is_escape_free_and_rmat_is_not(plan_graphs):
    assert plan_graphs["grid", "delta"].col_store.num_escapes == 0
    assert plan_graphs["rmat", "delta"].col_store.num_escapes > 0


@pytest.mark.parametrize("plan", ["int16", "int64", "delta"])
def test_primitives_cuda_storage_plans_match_int32(plan_graphs, plan):
    """bfs (push, pull, auto), sssp and pagerank on the cuda backend equal
    the int32 graph's bit for bit under every plan."""
    g, g32 = plan_graphs["grid", plan], plan_graphs["grid", "int32"]
    srcs = [0, 777, 1599]
    K.reset_launches()
    for run in (lambda gg: bfs_batch(gg, srcs, backend="cuda"),
                lambda gg: bfs_batch(gg, srcs, direction=False,
                                     backend="cuda"),
                lambda gg: sssp_batch(gg, srcs, delta=40.0,
                                      backend="cuda"),
                lambda gg: (pagerank(gg, max_iter=10,
                                     backend="cuda").rank,)):
        a, b = run(g), run(g32)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert K.KERNELS["advance_filter_batch"].variants.get(plan, 0) > 0
    assert K.KERNELS["advance_batch"].variants.get(plan, 0) > 0


@pytest.mark.parametrize("name", ["plus_times", "plus_and"])
def test_spmv_kernel_bf16_bitwise(graph, name):
    """K4 at bf16 precision bit for bit with its plain version on the CPU,
    structural and weighted (bf16 values too), masked and not."""
    g = graph
    sr = SR.with_precision(name, "bf16")
    x = torch.rand(g.num_vertices, device=g.device) * 3.0
    mask = torch.rand(g.num_vertices, device=g.device) < 0.5
    K.reset_launches()
    for vals in (None, g.edge_values * 1.37,
                 (g.edge_values * 1.37).to(torch.bfloat16)):
        for m in (None, mask):
            args = (g.row_offsets, g.col_indices, vals, x, sr, g.ell_width,
                    m, None, g.over_pos, g.over_row)
            got = K.spmv(*args).cpu()
            want = P.spmv(*(a.cpu() if torch.is_tensor(a) else a
                            for a in args))
            assert torch.equal(got, want)
    assert K.KERNELS["spmv"].variants == {"bf16": 6}
    # the rounding shows: fp32 and bf16 sweeps differ
    args = (g.row_offsets, g.col_indices, None, x)
    rest = (g.ell_width, None, None, g.over_pos, g.over_row)
    assert not torch.equal(K.spmv(*args, sr, *rest),
                           K.spmv(*args, SR.get(name), *rest))


@pytest.mark.parametrize("k", [1, 4, 32, 33])
def test_spmm_kernel_bf16(heavy_graph, k):
    """K4m at bf16 (plus_times and plus_and, structural, fp32 and bf16
    values): bit for bit with the plain version on the CPU on the rows of
    at most SPMM_SPLIT edges (the same fold order), elsewhere within the
    shares' regrouping."""
    g = heavy_graph
    unsplit = (g.degrees <= K.SPMM_SPLIT).cpu()
    x = torch.rand((g.num_vertices, k), device=g.device) * 3.0
    for name in ("plus_times", "plus_and"):
        sr = SR.with_precision(name, "bf16")
        for vals in (None, g.edge_values * 1.37,
                     (g.edge_values * 1.37).to(torch.bfloat16)):
            args = (g.row_offsets, g.col_indices, vals, x, sr, g.ell_width,
                    None, g.row_seg)
            got = K.spmm(*args).cpu()
            want = P.spmm(*(a.cpu() if torch.is_tensor(a) else a
                            for a in args))
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
            assert torch.equal(got[unsplit], want[unsplit])


@pytest.mark.parametrize("dtype", [torch.int16, torch.int64])
def test_segment_search_kernel_index_dtypes(graph, dtype):
    """K5 over a haystack at the plan's index dtype equals the int32
    haystack's answers."""
    g = graph
    lo, hi, needles = _probes(g, 100_000, seed=3)
    hay = g.cols().to(dtype)
    K.reset_launches()
    assert torch.equal(K.segment_search(hay, lo, hi, needles),
                       P.segment_search(g.cols(), lo, hi, needles))
    assert torch.equal(K.segment_locate(hay, lo, hi, needles),
                       P.segment_locate(g.cols(), lo, hi, needles))
    assert K.KERNELS["segment_search"].variants == {
        str(dtype).replace("torch.", ""): 2}


def test_spmv_heavy_rows_fresh_after_inplace_edit(card):
    """The schedule is keyed on the offsets' version: an in-place edit of
    the offsets gets a fresh one, and K4 writes every row."""
    ro, ci, vals, x = _star_csr(7)
    offsets = torch.from_numpy(ro).to(card)
    cols = torch.from_numpy(ci).to(card)
    xs = torch.from_numpy(x).to(card)
    heavy, _ = K.spmv_heavy_rows(offsets, 16)
    # move row 0's edges to row 1: row 0 empty, row 1 the hub
    offsets[1] = 0
    heavy2, _ = K.spmv_heavy_rows(offsets, 16)
    assert heavy2 is not heavy and int(heavy2[0]) == 1
    got = K.spmv(offsets, cols, None, xs, SR.plus_times, 16, None, None,
                 None, None).cpu()
    ro2 = offsets.cpu().numpy()
    want = P.spmv(offsets.cpu(), cols.cpu(), None, xs.cpu(), SR.plus_times,
                  16, None, None, *_over_lists(ro2, 16))
    assert torch.equal(got, want)


# ---- K1 and K2 redesigned: live slots, block-level LB partition, one
# ordered single-pass emit (decoupled look-back) -------------------------

INT32_MAX = 2 ** 31 - 1


def _first_clean(cache) -> bool:
    return all(bool((t == INT32_MAX).all()) for k, t in cache.items()
               if isinstance(k, tuple) and k[0] == "advance_filter_first")


def _k1_inputs(g, case, seed):
    """(base, sizes, visited, cap_out, cap_front) for K1 on ``g``."""
    rng = np.random.default_rng(seed)
    n, m = g.num_vertices, g.num_edges
    deg = g.degrees.cpu().numpy()
    b, cap_in, cap_out, cap_front = 3, 400, m, n
    base = rng.integers(0, n, (b, cap_in))
    live = rng.random((b, cap_in)) < 0.6
    if case == "duplicates":       # one vertex twice in a lane, one frontier
        base[:, 1::2] = base[:, ::2]                 # in every lane
        base[1:] = base[0]
        live[:] = True
    elif case == "cap_in_0":
        base, live = base[:, :0], live[:, :0]
    elif case == "clamped":        # totals past cap_out, survivors past front
        cap_out, cap_front = 500, 30
    elif case == "many_lanes":     # tiles spanning thousands of lanes
        cap_in = 3 * K.SCAN_TILE + 77
        base = rng.integers(0, n, (b, cap_in))
        live = rng.random((b, cap_in)) < 0.05
        live[1, 2000:9000] = False
    sizes = np.where(live, deg[base], 0)
    if case == "many_lanes":
        sizes = np.minimum(sizes, 1)
    elif case == "long_lane":      # a lane spanning many tiles (K3: its
        sizes[0, 7] = 5 * K.LB_TILE_SLOTS + 3        # edge ids run on)
        cap_out = int(sizes.sum(axis=1).max()) + 5
    visited = rng.random((b, n)) < 0.3
    dev = g.device

    def t(a, dtype=torch.int32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dtype).to(dev)
    return (t(base), t(sizes), t(visited, torch.bool), cap_out, cap_front)


@pytest.mark.parametrize("case", ["duplicates", "zero_lanes", "cap_in_0",
                                  "clamped", "many_lanes"])
@pytest.mark.parametrize("plan", ["int16", "int32", "int64", "delta"])
def test_advance_filter_kernel_cases(plan_graphs, plan, case):
    """K1 under every column kind at every block size equals its plain
    version (at cap_in = 0, where the plain version refuses the shape,
    nothing survives), and leaves ``first`` all INT32_MAX."""
    g = plan_graphs["grid", plan]
    store = g.col_store
    base, sizes, visited, cap_out, cap_front = _k1_inputs(g, case, 7)
    b = base.shape[0]
    if case == "cap_in_0":
        want = (torch.full((b, cap_front), -1, dtype=torch.int32),
                torch.full((b, cap_front), -1, dtype=torch.int32),
                torch.zeros(b, dtype=torch.int32),
                torch.zeros(b, dtype=torch.int32))
    else:
        want = tuple(x.cpu() for x in P.advance_filter_batch(
            g.row_offsets, store, base, sizes, visited, cap_out, cap_front))
    if case == "clamped":
        assert (want[3] > cap_front).any()
        assert (sizes.sum(dim=1) > cap_out).any()
    for threads in (64, 128, 256, 512, 1024):
        got = K.advance_filter_batch(g.row_offsets, store, base, sizes,
                                     visited, cap_out, cap_front, g.cache,
                                     threads=threads)
        assert all(torch.equal(x.cpu(), y) for x, y in zip(got, want)), \
            threads
        assert _first_clean(g.cache), threads


@pytest.mark.parametrize("case", ["duplicates", "zero_lanes", "cap_in_0",
                                  "clamped", "many_lanes", "long_lane"])
@pytest.mark.parametrize("plan", ["int16", "int32", "int64", "delta"])
def test_advance_kernel_cases(plan_graphs, plan, case):
    """K3 under every column kind at every block size equals its plain
    version on every slot, dead ones included (at cap_in = 0, where the
    plain version refuses the shape, every slot is dead with in_pos 0)."""
    g = plan_graphs["grid", plan]
    store = g.col_store
    base, sizes, _, cap_out, _ = _k1_inputs(g, case, 11)
    b = base.shape[0]
    if case == "cap_in_0":
        want = tuple(torch.full((b, cap_out), v, dtype=torch.int32)
                     for v in (-1, -1, -1, 0, 0)) + (
            torch.zeros((b, cap_out), dtype=torch.bool),
            torch.zeros(b, dtype=torch.int32))
    else:
        want = tuple(x.cpu() for x in P.advance_batch(
            g.row_offsets, store, base, sizes, cap_out))
    if case == "clamped":
        assert (sizes.sum(dim=1) > cap_out).any()
    for threads in (64, 128, 256, 512, 1024):
        got = K.advance_batch(g.row_offsets, store, base, sizes, cap_out,
                              g.cache, threads=threads)
        assert all(torch.equal(x.cpu(), y) for x, y in zip(got, want)), \
            threads


@pytest.mark.parametrize("threads", [64, 128, 256, 512, 1024])
def test_compact_kernel_cases(card, threads):
    """K2 at every block size: all-true, all-false and random masks,
    lengths that are no multiple of 16, rows that are not 16-byte
    aligned, a shared values row, cap = 0."""
    gen = torch.Generator(device=card).manual_seed(threads)
    for b, cap, p in ((3, 5000, 0.4), (2, 4099, 1.0), (4, 13, 0.5),
                      (3, 70_000, 0.0), (5, 16 * 1024 + 1, 0.9), (2, 0, 0.5),
                      (1, 1, 1.0)):
        mask = torch.rand((b, cap), generator=gen, device=card) < p
        vals = torch.randint(-9, 10 ** 6, (b, cap), generator=gen,
                             device=card, dtype=torch.int32)
        for v in (vals, vals[:1]):
            got = K.compact(v, mask, threads=threads)
            want = P.compact(v, mask)
            assert all(torch.equal(x, y) for x, y in zip(got, want)), (
                b, cap, p)
    flat = torch.rand(3 * 4096 + 1, generator=gen, device=card) < 0.5
    mask = flat[1:].view(3, 4096)            # every row 1 byte off
    vals = torch.arange(4096, dtype=torch.int32, device=card)[None]
    assert all(torch.equal(x, y) for x, y in zip(
        K.compact(vals, mask, threads=threads), P.compact(vals, mask)))


def test_lookback_state_across_calls(plan_graphs):
    """Calls in a row with other batch sizes and capacities, K1 and K2
    taking turns, each equal to its plain version: no call reads the
    tile flags or counters an earlier one left."""
    g = plan_graphs["grid", "int32"]
    gen = torch.Generator(device=g.device).manual_seed(5)
    for i, (case, cap) in enumerate((("zero_lanes", 70_000), ("clamped", 9),
                                     ("many_lanes", 300),
                                     ("duplicates", 5000))):
        base, sizes, visited, cap_out, cap_front = _k1_inputs(g, case, i)
        keep = 1 + i % 3
        base, sizes, visited = base[:keep], sizes[:keep], visited[:keep]
        got = K.advance_filter_batch(g.row_offsets, g.col_store, base, sizes,
                                     visited, cap_out, cap_front, g.cache,
                                     threads=(64, 1024, 256, 128)[i])
        want = P.advance_filter_batch(g.row_offsets, g.col_store, base,
                                      sizes, visited, cap_out, cap_front)
        assert all(torch.equal(x, y) for x, y in zip(got, want)), case
        assert _first_clean(g.cache)
        mask = torch.rand((5 - i, cap), generator=gen, device=g.device) < 0.5
        vals = torch.randint(0, 99, (5 - i, cap), generator=gen,
                             device=g.device, dtype=torch.int32)
        assert all(torch.equal(x, y) for x, y in zip(
            K.compact(vals, mask, threads=(1024, 64, 512, 256)[i]),
            P.compact(vals, mask)))


def test_advance_filter_kernel_launches(plan_graphs):
    """One K1 call is three device operations (the offsets scan, the
    expand pass, the emit pass) and one K2 call one, with no memset or
    PyTorch kernel beside them."""
    from torch.profiler import ProfilerActivity, profile
    g = plan_graphs["grid", "int32"]
    base, sizes, visited, cap_out, cap_front = _k1_inputs(g, "zero_lanes", 3)
    mask = torch.rand((3, 5000), device=g.device) < 0.5
    vals = torch.arange(5000, dtype=torch.int32, device=g.device)[None]
    calls = {"k1": lambda: K.advance_filter_batch(
        g.row_offsets, g.col_store, base, sizes, visited, cap_out,
        cap_front, g.cache), "k2": lambda: K.compact(vals, mask)}
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ops = {e.key: e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0}
        want = (("lb_offsets", "af_expand", "af_emit") if name == "k1"
                else ("cp_kernel",))
        assert sum(ops.values()) == len(want), ops
        assert all(any(k in o for o in ops) for k in want), ops


def test_advance_and_lb_expand_kernel_launches(plan_graphs):
    """One K3 call and one K6 call are each exactly two device operations
    (the offsets scan and the expand pass), with no memset or PyTorch
    kernel beside them."""
    from torch.profiler import ProfilerActivity, profile
    g = plan_graphs["grid", "delta"]
    base, sizes, _, cap_out, _ = _k1_inputs(g, "zero_lanes", 3)
    calls = {"k3": lambda: K.advance_batch(g.row_offsets, g.col_store, base,
                                           sizes, cap_out, g.cache),
             "k6": lambda: K.lb_expand(sizes[0], cap_out)}
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ops = {e.key: e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0}
        assert sum(ops.values()) == 2, (name, ops)
        assert all(any(k in o for o in ops)
                   for k in ("lb_offsets", "lb_expand_tiles")), (name, ops)


# ---- K5 redesigned: one block a tile of lanes, each run's segment (or
# its top levels) read once into shared memory --------------------------

BLOCKS = (64, 128, 256, 512, 1024)


def _k5_equal(hay, lo, hi, needles):
    """K5 in both modes at every block size against its plain version on
    the same card tensors, every lane."""
    want_f = P.segment_search(hay, lo, hi, needles)
    want_l = P.segment_locate(hay, lo, hi, needles)
    for t in BLOCKS:
        assert torch.equal(K.segment_search(hay, lo, hi, needles,
                                            threads=t), want_f), t
        assert torch.equal(K.segment_locate(hay, lo, hi, needles,
                                            threads=t), want_l), t
    return want_f


@pytest.mark.parametrize("dtype", ["int16", "int32", "int64"])
@pytest.mark.parametrize("case", K5_CASES)
def test_segment_search_kernel_model_cases(card, case, dtype):
    """The tile model's cases (tests/test_torch_kernel_models.py): runs
    sharing a segment, broken runs, a run over many tiles, a hub past the
    budget, short and empty segments, unsorted segments, lo / hi outside
    the haystack, an empty haystack, needles past every value."""
    hay, lo, hi, nd = k5_case(case)
    if dtype == "int16" and case == "hub":
        hay, nd = hay // 32, (nd // 32).astype(np.int32)
    t = [torch.from_numpy(a).to(card) for a in
         (hay.astype(dtype), lo, hi, nd)]
    _k5_equal(*t)
    # unaligned views take the kernel's scalar loads and stores
    _k5_equal(t[0], *(a[1:] for a in t[1:]))


def test_segment_search_kernel_real_probes(graph):
    """TC's mxm probes (every [lo, hi) a row of the oriented graph, the
    needles a row's sorted columns) and segmented_intersect's probes of
    edge pairs, at every block size, bit for bit."""
    from repro_torch.core.primitives import tc as TC
    g = graph
    sub, ssrc, sdst = TC._orient(g)
    (a_off, a_idx, _), (bt_off, bt_idx, _), base, probe, cap = L.mxm_plan(
        sub, sub, (ssrc, sdst), b_transpose=True)
    sizes = (a_off[base.long() + 1] - a_off[base.long()]).to(torch.int32)
    _, needles, _, pair, _, _, _ = K.advance(a_off, a_idx, base, sizes, cap)
    rows = torch.index_select(probe, 0, pair)
    pos = _k5_equal(bt_idx, torch.index_select(bt_off, 0, rows),
                    torch.index_select(bt_off, 0, rows + 1), needles)
    assert int(pos.sum()) > 0
    rng = np.random.default_rng(4)
    e = torch.from_numpy(rng.integers(0, g.num_edges, 4000)).to(g.device)
    length = torch.tensor(4000, dtype=torch.int32, device=g.device)
    fa = F.SparseFrontier(ids=torch.index_select(g.row_seg, 0, e),
                          length=length)
    fb = F.SparseFrontier(ids=torch.index_select(g.col_indices, 0, e),
                          length=length)
    need = int(torch.minimum(g.degrees[fa.ids.long()],
                             g.degrees[fb.ids.long()]).sum())
    needles, lo, hi, _, _ = O._intersect_probes(g, fa, fb, need, "cuda")
    assert int(_k5_equal(g.col_indices, lo, hi, needles).sum()) > 0


def test_segment_search_kernel_launches(graph):
    """One K5 call, in either mode, is one device operation: the row
    kernel, with no memset or PyTorch kernel beside it. A profiler
    session of one short call can lose its device records, so each mode
    gets up to three device-only sessions, the host idle around the call;
    any operation but K5's kernel fails at once."""
    import time
    from torch.profiler import ProfilerActivity, profile
    g = graph
    lo, hi, needles = _probes(g, 100_000, seed=5)
    for fn in (K.segment_search, K.segment_locate):
        fn(g.col_indices, lo, hi, needles)
        torch.cuda.synchronize()
        seen = []
        for _ in range(3):
            K.reset_launches()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                time.sleep(0.25)
                fn(g.col_indices, lo, hi, needles)
                torch.cuda.synchronize()
                time.sleep(0.25)
            ops = {e.key: e.count for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0}
            assert all("search_rows" in o and c == 1
                       for o, c in ops.items()), ops
            assert K.KERNELS["segment_search"].launches == 1
            seen.append(sum(ops.values()))
            if seen[-1] == 1:
                break
        assert seen[-1] == 1, seen


# ---- the serving path (graph_serve, telemetry, the degradation ladder) ----

def test_serve_mixed_clean_stream_on_the_card(graph):
    """A clean mixed stream on the cuda backend: every query ok, nothing
    retried or declared, K1/K2/K3/K4/K4m launched, and every served lane
    equal to a direct call of its primitive on the same sources."""
    from repro_torch.core import backend as TB
    from repro_torch.launch import graph_serve as GS
    n = graph.num_vertices
    rng = np.random.default_rng(1)
    queries = [(GS.KINDS[i % 4], int(rng.integers(0, n)))
               for i in range(16)]
    served = []

    def runner(kind, srcs, backend, hops):
        out = GS._run_kind(graph, kind, srcs, backend, hops)
        served.append((kind, srcs.copy(), out[0]))
        return out

    before = TB.declared_fallbacks()
    K.reset_launches()
    stats = GS.serve_mixed(graph, queries, batch=4, backend="cuda",
                           runner=runner, validate=True)
    launches = {k: v.launches for k, v in K.KERNELS.items()}
    assert stats["status_counts"]["ok"] == 16 and stats["retried"] == 0
    assert stats["validation_failures"] == 0
    assert TB.declared_fallbacks() == before
    for k in ("advance_filter_batch", "compact", "advance_batch", "spmv",
              "spmm"):
        assert launches[k] > 0, k
    for kind, srcs, field in served:
        direct = GS._run_kind(graph, kind, srcs, "cuda", 3)[0]
        assert torch.equal(field, direct), kind


def test_torch_rung_stays_on_the_card(graph):
    """Under a plan that misses attempt 0, the retry answers from the
    torch rung on the same card tensors, stamped degraded."""
    from repro_torch.core import backend as TB
    from repro_torch.ft import inject
    from repro_torch.launch import graph_serve as GS
    seed = next(s for s in range(64)
                if inject._draw(s, "provider_miss", "bfs", 0) < 0.6
                and inject._draw(s, "provider_miss", "bfs", 1) >= 0.6)
    with inject.faults("provider_miss:bfs@0.6", seed=seed):
        stats = GS.serve_mixed(graph, [("bfs", 0), ("bfs", 5)], batch=2,
                               backend="cuda")
    assert [q["status"] for q in stats["queries"]] == ["degraded"] * 2
    assert stats["flushes"][0]["backend"] == "torch"
    assert stats["flushes"][0]["device"].startswith("cuda")
    TB._DECLARED_FALLBACKS.pop(("bfs", "torch"), None)


def _syncs(fn):
    """fn's result and its synchronizing CUDA calls (sync debug mode)."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


def test_telemetry_on_the_card_is_bit_invisible(graph):
    """The same bits, host reads and synchronizing calls with telemetry
    on (a Python number is recorded by a fill, a tensor by a copy)."""
    from repro_torch.core import enactor
    from repro_torch.obs import telemetry as T
    hub = int(torch.argmax(graph.degrees))
    # warm: the first call under sync debug mode makes one more
    _syncs(lambda: bfs_batch(graph, [hub, 3], backend="cuda"))
    enactor.reset_host_reads()
    plain, syncs = _syncs(lambda: bfs_batch(graph, [hub, 3], backend="cuda"))
    reads = enactor.host_reads()
    enactor.reset_host_reads()
    (r, buf), syncs_on = _syncs(
        lambda: bfs_batch(graph, [hub, 3], backend="cuda", telemetry=True))
    assert enactor.host_reads() == reads
    assert syncs_on == syncs
    for x, y in zip(plain, r):
        assert torch.equal(x, y)
    trace = T.trim(buf, r.iterations)
    lab = r.labels[0].cpu().numpy()
    lane = trace.lane(0)
    counts = np.bincount(lab[lab >= 0], minlength=lane.steps + 1)
    assert np.array_equal(lane["frontier"], counts[1:lane.steps + 1])


# ---- the load-balancing and idempotence ablations (TWC, THREAD) -----------

@pytest.mark.parametrize("strategy", ["TWC", "THREAD"])
def test_strategies_cuda_match_torch_backend(graph, strategy):
    """bfs_batch (idempotence x direction), sssp_batch and one advance
    under TWC and THREAD: the cuda backend bit-equal to the torch backend
    on the card; TWC launches K3 and K2, THREAD K2 and no K3."""
    g = graph
    srcs = [int(torch.argmax(g.degrees)), 1, 2, 3]
    K.reset_launches()
    for idem in (True, False):
        for direction in (True, False):
            kw = dict(strategy=strategy, idempotence=idem,
                      direction=direction)
            a = bfs_batch(g, srcs, backend="cuda", **kw)
            b = bfs_batch(g, srcs, backend="torch", **kw)
            assert all(torch.equal(x, y) for x, y in zip(a, b)), kw
    a = sssp_batch(g, srcs, strategy=strategy, backend="cuda")
    b = sssp_batch(g, srcs, strategy=strategy, backend="torch")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert np.array_equal(a.dist.cpu().numpy(), R.sssp_ref(g, srcs))
    assert K.KERNELS["compact"].launches > 0
    assert (K.KERNELS["advance_batch"].launches > 0) == (strategy == "TWC")
    front = _frontier(g, 2, seed=5)
    before = K.KERNELS["advance_batch"].launches
    a, _ = O.advance_batch(g, front, g.num_edges, strategy=strategy,
                           backend="cuda")
    assert (K.KERNELS["advance_batch"].launches > before) == (
        strategy == "TWC")
    b, _ = O.advance_batch(g, front, g.num_edges, strategy=strategy,
                           backend="torch")
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_hash_uniquify_on_the_card_is_repeatable(graph):
    """The hash winner (the last kept lane of a slot) is picked by an
    explicit max, so repeated calls on the card agree with each other and
    with the CPU, slots colliding at hash_size 8."""
    rng = np.random.default_rng(9)
    ids = rng.integers(0, 200, (3, 4096)).astype(np.int32)
    lengths = np.array([4096, 3000, 17], np.int32)
    ids[np.arange(4096)[None, :] >= lengths[:, None]] = -1
    cpu = F.BatchedSparseFrontier(torch.from_numpy(ids),
                                  torch.from_numpy(lengths))
    card = F.BatchedSparseFrontier(cpu.ids.to(graph.device),
                                   cpu.lengths.to(graph.device))
    want = O.filter_frontier_batch(cpu, n=200, uniquify="hash",
                                   hash_size=8, cap=300)
    for _ in range(5):
        got = O.filter_frontier_batch(card, n=200, uniquify="hash",
                                      hash_size=8, cap=300, backend="cuda")
        assert torch.equal(got[0].ids.cpu(), want[0].ids)
        assert torch.equal(got[0].lengths.cpu(), want[0].lengths)
        assert torch.equal(got[2].cpu(), want[2])


def test_lb_scan_saturates_on_the_card(graph):
    """K6 and K3 on lanes whose sizes pass int32 in sum (a frontier of
    duplicates of the hub): the scan saturates as the plain version's, so
    every slot equals it and nothing is written out of bounds."""
    big = 2 ** 30
    sizes = torch.tensor([3, big, big, big, 7, 0, 5], dtype=torch.int32,
                         device=graph.device)
    for cap in (10, 5000):
        got = K.lb_expand(sizes, cap)
        want = P.lb_expand(P.lb_offsets(sizes), cap)
        assert all(torch.equal(x, y) for x, y in zip(got[:3], want))
        assert int(got.total) == 2 ** 31 - 1
    g = graph
    hub = int(torch.argmax(g.degrees))
    lanes = -(-(2 ** 31) // int(g.degrees[hub])) + 5
    ids = torch.full((2, lanes), hub, dtype=torch.int32, device=g.device)
    front = F.BatchedSparseFrontier(ids, torch.tensor(
        [lanes, lanes // 3], dtype=torch.int32, device=g.device))
    base, sizes = O._base_and_sizes(g, front.ids, front.valid_mask, "vertex")
    for cap in (4096, g.num_edges):
        got = K.advance_batch(g.row_offsets, g.col_indices, base, sizes, cap)
        want = P.advance_batch(g.row_offsets, g.col_indices, base, sizes, cap)
        assert all(torch.equal(x, y) for x, y in zip(got, want))
        assert got[6].tolist()[0] == 2 ** 31 - 1


# ---- placements: every part on the one card --------------------------------

def _placements(g, mesh_device):
    from repro_torch.core.partition import Mesh, partition_1d, partition_2d
    return (("1-D", partition_1d(g, 4),
             Mesh.on(mesh_device, (4,), ("graph",))),
            ("2-D", partition_2d(g, 2, 2),
             Mesh.on(mesh_device, (2, 2), ("row", "col"))))


@pytest.mark.parametrize("which", [0, 1], ids=["1-D", "2-D"])
def test_placement_on_the_card_equals_the_cpu(card, which):
    """A small partition on the card, 1-D and 2-D, gives the bits of the
    same run on the CPU (PageRank's float sums included: a part's
    overflow fold adds in ascending order on the card too), launches no
    kernel, and its bfs / pagerank equal the single-placement cuda
    backend's."""
    from repro_torch.core import distributed as D
    gc = G.rmat(9, 8, seed=7, weighted=True, device=card)
    gh = G.rmat(9, 8, seed=7, weighted=True, device="cpu")
    name, pc, mc = _placements(gc, card)[which]
    _, ph, mh = _placements(gh, "cpu")[which]
    src = int(torch.argmax(gh.degrees))
    K.reset_launches()
    runs = (
        ("bfs", lambda pg, m: D.distributed_bfs(pg, src, m).labels),
        ("sssp", lambda pg, m: D.distributed_sssp(pg, src, m,
                                                  delta=2.0).dist),
        ("cc", lambda pg, m: D.distributed_cc(pg, m).labels),
        ("pagerank", lambda pg, m: D.distributed_pagerank(pg, m, iters=10)),
        ("reach", lambda pg, m: D.distributed_reach(pg, [0, 3, 9], 3,
                                                    mesh=m).reached),
        ("lp", lambda pg, m: D.distributed_label_propagation(
            pg, m, max_iter=4).labels))
    got = {}
    for prim, run in runs:
        got[prim] = run(pc, mc)
        assert torch.equal(got[prim].cpu(), run(ph, mh)), (name, prim)
    assert not any(k.launches for k in K.KERNELS.values())
    assert torch.equal(got["pagerank"],
                       pagerank(gc, max_iter=10, backend="cuda").rank)
    assert torch.equal(got["bfs"], bfs_batch(gc, [src], backend="cuda")
                       .labels[0])


@pytest.mark.parametrize("op", ["sum", "or", "min", "max"])
def test_collectives_same_bits_on_the_card_as_on_the_cpu(card, op):
    from repro_torch.core import distributed as D
    rng = np.random.default_rng(5)
    host = [torch.from_numpy(rng.random(1000).astype(np.float32))
            for _ in range(4)]
    if op == "or":
        host = [h > 0.7 for h in host]
    dev = [h.to(card) for h in host]
    for a, b in zip(D.all_reduce(dev, op), D.all_reduce(host, op)):
        assert a.device == card and torch.equal(a.cpu(), b)
    assert torch.equal(D.all_gather(dev)[2].cpu(), D.all_gather(host)[2])
    for axis in (0, 1):
        for a, b in zip(D.axis_all_reduce(dev, (2, 2), axis, op),
                        D.axis_all_reduce(host, (2, 2), axis, op)):
            assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("k", [None, 1, 2, 5, 40])
def test_ordered_scatter_accum_on_the_card_is_the_cpu_fold(card, k):
    """The placements' plus fold on the card adds in ascending index
    order from the target's value, as the CPU's index_add does (1e4-scale
    terms make any other order show), for a vector and for k columns."""
    rng = np.random.default_rng(1)
    shape = (200_000,) if k is None else (200_000, k)
    idx = torch.from_numpy(rng.integers(0, 50, 200_000))
    vals = torch.from_numpy((rng.standard_normal(shape) * 1e4)
                            .astype(np.float32))
    tgt = torch.from_numpy((rng.standard_normal(
        (50,) + shape[1:]) * 1e4).astype(np.float32))
    want = L.ordered_scatter_accum(SR.plus_times, tgt, idx, vals)
    got = L.ordered_scatter_accum(SR.plus_times, tgt.to(card),
                                  idx.to(card), vals.to(card))
    assert torch.equal(got.cpu(), want), (
        "linalg.ops.ordered_scatter_accum no longer adds in index order on "
        f"the card (k={k}, torch {torch.__version__}): its plus fold rests "
        "on index_put_(accumulate=True)'s undocumented internals")


# ---- the launch audit on the card (analysis.sanitize) ---------------------

def _site_calls(g):
    """One call through each of the 11 launch sites, on the card: (site,
    a thunk returning the call's outputs as a tuple)."""
    from repro_torch.kernels.ref import ATTN_BQ
    dev = g.device
    front = _frontier(g, 2, seed=11)
    base, sizes = O._base_and_sizes(g, front.ids, front.valid_mask, "vertex")
    visited = torch.zeros((2, g.num_vertices), dtype=torch.bool, device=dev)
    mask = torch.rand((2, 3000), device=dev) < 0.4
    vals = torch.randint(0, 99, (2, 3000), dtype=torch.int32, device=dev)
    x = torch.rand(g.num_vertices, device=dev)
    xk = torch.rand((g.num_vertices, 5), device=dev)
    ro, cols = g.row_offsets, g.col_indices
    u = torch.arange(0, g.num_vertices, 7, device=dev)
    lo, hi = ro[u], ro[u + 1]
    needles = cols[lo.clamp(max=cols.numel() - 1).long()].to(torch.int32)
    q, k, v = (torch.randn((n, 128), dtype=torch.bfloat16, device=dev)
               for n in (ATTN_BQ, 4096, 4096))
    slot = torch.randint(-1, 300, (900,), dtype=torch.int32, device=dev)
    xt = torch.randn((256, 64), dtype=torch.bfloat16, device=dev)
    return [
        ("advance_batch", lambda: K.advance_batch(ro, cols, base, sizes,
                                                  4096)),
        ("advance_filter_batch", lambda: K.advance_filter_batch(
            ro, cols, base, sizes, visited, 4096, 500, g.cache)),
        ("compact", lambda: K.compact(vals, mask)),
        ("spmv", lambda: (K.spmv(ro, cols, g.edge_values, x, SR.plus_times,
                                 g.ell_width, None, cache=g.cache),)),
        ("spmm", lambda: (K.spmm(ro, cols, None, xk, SR.plus_times, None,
                                 None, cache=g.cache),)),
        ("segment_search", lambda: (K.segment_locate(cols, lo, hi, needles),
                                    K.segment_search(cols, lo, hi,
                                                     needles))),
        ("lb_expand", lambda: tuple(K.lb_expand(g.degrees, 5000))),
        ("attention_partials", lambda: K.attention_partials(q, k, v, True,
                                                            4)),
        ("attention_combine", lambda: (K.attention_combine(
            *K.attention_partials(q, k, v, True, 4), torch.bfloat16),)),
        ("flash_attention", lambda: (K.flash_attention(q, k, v),
                                     K.flash_attention(k, k, v))),
        ("moe_gather", lambda: (K.moe_gather(xt, slot),)),
    ]


def test_every_launch_site_audited_clean_on_the_card(graph):
    """Each of the 11 sites under sanitizing(): audited once a launch
    (the audits, by C function, equal the launch counters), no fault, and
    bit-equal to the same call unsanitized."""
    from repro_torch.analysis import sanitize
    calls = _site_calls(graph)
    assert sorted(s for s, _ in calls) == sorted(K.SITES)
    for site, call in calls:
        plain = call()
        K.reset_launches()
        sanitize.reset_audits()
        with sanitize.sanitizing():
            got = call()
        torch.cuda.synchronize()
        assert sanitize.audit_count(site) >= 1, site
        audited = {}
        for (_, fn), c in sanitize.audits().items():
            for kern in K.FUNCTION_KERNELS[fn]:
                audited[kern] = audited.get(kern, 0) + c
        launched = {n: k.launches for n, k in K.KERNELS.items()
                    if k.launches}
        assert audited == launched, site
        for a, b in zip(plain, got):
            assert torch.equal(a, b), site


def test_each_fault_class_caught_before_launch(graph):
    """A K3 launch with a column id equal to n, a K2 launch whose output
    aliases its input, and a K2 launch with a float mask each raise
    MemoryFault before the kernel runs; the card stays usable."""
    from repro_torch.analysis import sanitize
    g = graph
    front = _frontier(g, 2, seed=12)
    base, sizes = O._base_and_sizes(g, front.ids, front.valid_mask, "vertex")
    cols = g.col_indices.clone()
    cols[-1] = g.num_vertices
    K.reset_launches()
    with sanitize.sanitizing():
        with pytest.raises(sanitize.MemoryFault, match="column ids outside"):
            K.advance_batch(g.row_offsets, cols, base, sizes, 4096)
        vals = torch.arange(6000, dtype=torch.int32,
                            device=g.device).reshape(2, 3000)
        mask = vals % 3 == 0
        lb, epoch = K._lookback_state(g.device, 2, 2, 1)
        with pytest.raises(sanitize.MemoryFault, match="write-write race"):
            K._launch("compact", "compact", "compact_batch", vals, 3000,
                      mask, 2, 3000, lb.counters, lb.status,
                      lb.status.numel(), epoch, vals,
                      torch.empty((2,), dtype=torch.int32, device=g.device),
                      256, runtime.stream_ptr(g.device))
        with pytest.raises(sanitize.MemoryFault, match="dtype mismatch"):
            K._launch("compact", "compact", "compact_batch", vals, 3000,
                      mask.float(), 2, 3000, lb.counters, lb.status,
                      lb.status.numel(), epoch, vals.clone(),
                      torch.empty((2,), dtype=torch.int32, device=g.device),
                      256, runtime.stream_ptr(g.device))
    assert all(k.launches == 0 for k in K.KERNELS.values())
    visited = torch.zeros((2, g.num_vertices), dtype=torch.bool,
                          device=g.device)
    got = K.advance_filter_batch(g.row_offsets, g.col_indices, base, sizes,
                                 visited, 4096, 100, g.cache)
    want = P.advance_filter_batch(g.row_offsets, g.col_indices, base, sizes,
                                  visited, 4096, 100)
    assert all(torch.equal(x, y) for x, y in zip(got, want))


def test_sanitizing_off_adds_no_read_or_sync(graph):
    """With sanitizing off a launch makes no synchronizing call and the
    loops their one host read a step; the audit's one read a launch is
    the only difference sanitizing makes."""
    from repro_torch.analysis import sanitize
    from repro_torch.core import enactor
    g = graph
    front = _frontier(g, 2, seed=13)
    base, sizes = O._base_and_sizes(g, front.ids, front.valid_mask, "vertex")
    k3 = lambda: K.advance_batch(g.row_offsets, g.col_indices, base, sizes,
                                 4096)
    _syncs(k3)
    with sanitize.sanitizing(False):
        _, off = _syncs(k3)
    with sanitize.sanitizing():
        _, on = _syncs(k3)
    assert off == 0 and on >= 1
    hub = int(torch.argmax(g.degrees))
    run = lambda: bfs_batch(g, [hub, 3], backend="cuda")
    _syncs(run)
    enactor.reset_host_reads()
    plain, syncs = _syncs(run)
    reads = enactor.host_reads()
    enactor.reset_host_reads()
    with sanitize.sanitizing(False):
        again, syncs_off = _syncs(run)
    assert enactor.host_reads() == reads and syncs_off == syncs
    assert all(torch.equal(x, y) for x, y in zip(plain, again))


def test_saturated_scan_reads_no_offset_of_a_padding_lane(card):
    """Past the scan's saturation every lane's offset is written, empty
    ones too: a padding lane (frontier id -1) must not read
    row_offsets[-1]. The offsets sit at the start of an allocation of
    their own, so such a read would fall before it."""
    g = G.rmat(10, 8, seed=3, device=card)
    hub = int(torch.argmax(g.degrees))
    big = torch.empty((1 << 24,), dtype=torch.int32, device=card)
    ro = big[:g.num_vertices + 1]
    ro.copy_(g.row_offsets)
    lanes = -(-(2 ** 31) // int(g.degrees[hub])) + 5
    base = torch.full((1, lanes + 64), -1, dtype=torch.int32, device=card)
    base[0, :lanes] = hub
    sizes = torch.where(base >= 0, g.degrees[hub], 0).to(torch.int32)
    for cap in (4096, g.num_edges):
        got = K.advance_batch(ro, g.col_indices, base, sizes, cap)
        want = P.advance_batch(ro, g.col_indices, base, sizes, cap)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(got, want))
        assert got[6].tolist()[0] == 2 ** 31 - 1


# ---- the LM serving path (no kernel: plain PyTorch on the card) -----------

LM_ARCHS = ("kimi-k2-1t-a32b", "qwen3-moe-235b-a22b", "yi-6b", "llama3-405b",
            "starcoder2-15b", "minicpm-2b", "qwen2-vl-2b", "mamba2-780m",
            "zamba2-2.7b", "whisper-large-v3")


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_smoke_on_the_card_equals_the_cpu(card, arch):
    """The SMOKE config in fp32: params drawn once on the CPU and moved,
    the same prompts; logits within the reference's decode-vs-direct
    2e-3, greedy ids equal, and no kernel launched."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import generate, prompt_batch
    from repro_torch.models import build_model
    from repro_torch.models.api import tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    model = build_model(get_smoke_config(arch))
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    batch = prompt_batch(model.cfg, np.random.default_rng(0), 2, 16, "cpu")
    ids, logits = generate(model, params, batch, 8, cache_len=24)
    before = {k: v.launches for k, v in K.KERNELS.items()}
    ids_c, logits_c = generate(
        model, tree_map(lambda t: t.to(card), params),
        {k: v.to(card) for k, v in batch.items()}, 8, cache_len=24)
    assert {k: v.launches for k, v in K.KERNELS.items()} == before
    assert float((logits_c.cpu() - logits).abs().max()) < 2e-3, arch
    assert torch.equal(ids_c.cpu(), ids), arch


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_decode_step_reads_nothing_back_on_the_card(card, arch):
    """One decode step under the sync debug mode "error": a host read or
    a blocking copy anywhere in it (the M-RoPE table, the cache write,
    the MoE routing) raises."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import prompt_batch
    from repro_torch.models import build_model
    model = build_model(get_smoke_config(arch))
    params = model.init(0, device=card)
    batch = prompt_batch(model.cfg, np.random.default_rng(0), 2, 16, card)
    lg, cache = model.prefill(params, batch, cache_len=18)
    tok = torch.argmax(lg[:, -1], -1).to(torch.int32)[:, None]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        lg, cache = model.decode_step(params, cache, {"tokens": tok})
        torch.argmax(lg[:, -1], -1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(cache["len"]) == 17
    assert bool(torch.isfinite(lg).all())


def test_whisper_position_clamp_reads_nothing_back_on_the_card(card):
    """Whisper's decode step at SMOKE with max_cache_len below the decode
    position: the clamped row is taken on the card (no host read of the
    cache length), and the step equals the CPU's."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import prompt_batch
    from repro_torch.models import build_model
    from repro_torch.models.api import tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    model = build_model(get_smoke_config("whisper-large-v3").replace(
        max_cache_len=8))
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    batch = prompt_batch(model.cfg, np.random.default_rng(0), 2, 16, "cpu")
    lg, cache = model.prefill(params, batch, cache_len=18)
    tok = torch.argmax(lg[:, -1], -1).to(torch.int32)[:, None]
    want, _ = model.decode_step(params, cache, {"tokens": tok})
    params_c = tree_map(lambda t: t.to(card), params)
    cache_c = tree_map(lambda t: t.to(card), cache)
    tok_c = tok.to(card)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got, cache_c = model.decode_step(params_c, cache_c,
                                         {"tokens": tok_c})
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(cache_c["len"]) == 17
    assert float((got.cpu() - want).abs().max()) < 2e-3


def test_moe_combine_is_deterministic_on_the_card(card):
    """The fixed-order combine: two runs of one batch give the same bits
    (index_add_ would add with atomics in no order)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import moe as M
    cfg = get_smoke_config("kimi-k2-1t-a32b").replace(
        d_model=256, n_experts=64, top_k=8, d_expert=128,
        capacity_factor=0.5)
    params = M.moe_init(torch.Generator(device=card).manual_seed(0), cfg,
                        torch.float32, device=card)
    x = torch.randn((4, 256, 256), device=card,
                    generator=torch.Generator(device=card).manual_seed(1))
    y1, aux1 = M.moe_ffn(params, x, cfg)
    y2, aux2 = M.moe_ffn(params, x, cfg)
    assert torch.equal(y1, y2)
    assert torch.equal(aux1["moe_aux_loss"], aux2["moe_aux_loss"])
    assert float(aux1["moe_drop_frac"]) > 0.0


# ---- LM training (no kernel: plain PyTorch on the card) -------------------

def _smoke_train(arch, device, **kw):
    """One SMOKE train step (fp32, B = 2, S = 32) on ``device`` from
    params drawn once on the CPU: (loss, grads, params after the step)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import make_batch_for
    from repro_torch.models import build_model
    from repro_torch.models.api import tree_map
    from repro_torch.train import adamw, make_schedule, make_train_step
    from repro_torch.train.trainstep import value_and_grad
    model = build_model(get_smoke_config(arch).replace(**kw))
    params = tree_map(lambda t: t.to(device), model.init(
        torch.Generator().manual_seed(0), device="cpu"))
    batch = {k: v.to(device) for k, v in make_batch_for(
        model.cfg, {"global_batch": 2, "seq_len": 32}, "train", seed=3,
        device="cpu").items()}
    _, _, grads = value_and_grad(model, params, batch)
    opt_init, opt_update = adamw(make_schedule("cosine", 1e-3, 10,
                                               warmup_steps=2))
    step = make_train_step(model, opt_update)
    params, _, metrics = step(params, opt_init(params), batch)
    return metrics["loss"], grads, params


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_train_step_on_the_card_equals_the_cpu(card, arch):
    """A SMOKE train step on the card against the CPU's from the same
    params: loss within 2e-3, every gradient leaf within 2e-3 × the
    global norm, params within 2e-3 relative L2; no kernel launched."""
    from repro_torch.pytree import leaves
    torch.backends.cuda.matmul.allow_tf32 = False
    loss, grads, params = _smoke_train(arch, "cpu")
    before = {k: v.launches for k, v in K.KERNELS.items()}
    loss_c, grads_c, params_c = _smoke_train(arch, card)
    assert {k: v.launches for k, v in K.KERNELS.items()} == before
    assert abs(float(loss_c) - float(loss)) < 2e-3, arch
    norm = float(torch.sqrt(sum(torch.sum(g.double() ** 2)
                                for g in leaves(grads))))
    for g, gc in zip(leaves(grads), leaves(grads_c)):
        assert float((gc.cpu() - g).abs().max()) <= 2e-3 * norm, arch
    a = torch.cat([t.ravel() for t in leaves(params)])
    b = torch.cat([t.cpu().ravel() for t in leaves(params_c)])
    assert float(torch.linalg.norm(a - b) / torch.linalg.norm(a)) < 2e-3


def test_remat_lowers_peak_memory_on_the_card(card):
    """MiniCPM-2B's width at 8 layers, B = 4, S = 512, bf16: a
    backward's peak falls from "none" to "dots" to "full", and the loss
    is the same."""
    from repro_torch.configs import get_config
    from repro_torch.data import make_batch_for
    from repro_torch.models import build_model
    from repro_torch.train.trainstep import value_and_grad
    peaks, losses = {}, {}
    for remat in ("none", "dots", "full"):
        model = build_model(get_config("minicpm-2b").replace(
            n_layers=8, remat=remat))
        params = model.init(0, device=card)
        batch = make_batch_for(model.cfg, {"global_batch": 4,
                                           "seq_len": 512}, "train",
                               seed=1, device=card)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        loss, _, grads = value_and_grad(model, params, batch)
        torch.cuda.synchronize()
        peaks[remat] = torch.cuda.max_memory_allocated() - base
        losses[remat] = float(loss)
        del params, grads
        torch.cuda.empty_cache()
    assert peaks["none"] > peaks["dots"] > peaks["full"], peaks
    assert losses["dots"] == losses["none"] == losses["full"], losses


def test_checkpoint_from_the_card_restores_on_the_cpu(card, tmp_path):
    """A bf16 params tree and int8 moments saved from the card, restored
    on the CPU bit for bit."""
    from repro_torch.ckpt import restore_checkpoint, save_checkpoint
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.models.api import tree_map
    from repro_torch.pytree import leaves
    from repro_torch.train import adamw, make_schedule
    model = build_model(get_smoke_config("minicpm-2b").replace(
        param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16))
    params = model.init(0, device=card)
    opt_init, _ = adamw(make_schedule("constant", 1e-3, 10),
                        quantize_moments=True)
    state = (params, opt_init(params))
    save_checkpoint(str(tmp_path), 1, state)
    like = tree_map(lambda t: torch.zeros_like(t, device="cpu"), state)
    got, _ = restore_checkpoint(str(tmp_path), 1, like, device="cpu")
    for a, b in zip(leaves(state), leaves(got)):
        assert b.device.type == "cpu" and a.dtype == b.dtype
        assert torch.equal(a.cpu(), b)
