"""The CUDA kernels on the card: each against its plain version, and the
primitives on the ``cuda`` backend against the ``torch`` backend on the
same card. Skipped (with the reason) where no Hopper card is present;
run them on the card with

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
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
from repro_torch.linalg import ops as L
from repro_torch.linalg import semiring as SR

pytestmark = pytest.mark.cuda


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
    got = K.advance_batch(g.row_offsets, g.col_indices, base, sizes, cap)
    want = P.advance_batch(g.row_offsets, g.col_indices, base, sizes, cap)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
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
    assert all(k.launches > 0 for k in K.KERNELS.values())
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
    assert all(k.launches > 0 for k in K.KERNELS.values())


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
    """rmat scale 14: rows above and below the kernel's 1024-edge split."""
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


@pytest.mark.parametrize("k", [4, 32, 33])
def test_spmm_kernel_float_plus_times(heavy_graph, k):
    """General floats: at k >= 32, on rows of at most 1024 edges, a lane
    folds its column in ascending edge order, the plain version's order
    on the CPU, so the two are bit-equal there; below 32 the edge groups,
    and on longer rows the block's per-warp shares, regroup the sum (rtol
    1e-5, the reference's own limit between its providers)."""
    g = heavy_graph
    light = (g.degrees <= 1024).cpu()
    assert 0 < int((~light).sum()) < g.num_vertices
    x = torch.rand((g.num_vertices, k), device=g.device)
    args = (g.row_offsets, g.col_indices, g.edge_values, x, SR.plus_times,
            g.ell_width, None, g.row_seg)
    got = K.spmm(*args).cpu()
    want = P.spmm(*(a.cpu() if torch.is_tensor(a) else a for a in args))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    if k >= 32:
        assert torch.equal(got[light], want[light])


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
