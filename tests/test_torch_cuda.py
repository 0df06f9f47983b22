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
                                            (40, 7)])
def test_lb_expand_kernel_matches_plain_on_every_slot(card, cap_in,
                                                      cap_out):
    rng = np.random.default_rng(cap_in + cap_out)
    sizes = torch.from_numpy(rng.integers(0, 40, cap_in).astype(np.int32))
    sizes[::7] = 0                              # zero-size segments
    K.reset_launches()
    got = K.lb_expand(sizes.to(card), cap_out)
    want = K.lb_expand(sizes, cap_out)
    assert K.KERNELS["lb_expand"].launches == 1
    assert all(torch.equal(x.cpu(), y) for x, y in zip(got, want))


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
def test_flash_attention_split_kv_matches_plain(card, dtype, sq, sk):
    """Few queries against many keys: the kv axis split over blocks and
    merged by the combine kernel, within the unchanged limits."""
    gen = torch.Generator(device=card).manual_seed(sq + sk)
    q, k, v = (torch.randn((n, 128), generator=gen, device=card).to(dtype)
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
        got = K.advance_filter_batch(g.row_offsets, store, base, sizes,
                                     visited, cap, 100, g.cache)
        want = P.advance_filter_batch(g.row_offsets, store, base, sizes,
                                      visited, cap, 100)
        assert all(torch.equal(x, y) for x, y in zip(got, want))
    for name in ("advance_batch", "advance_filter_batch"):
        assert K.KERNELS[name].variants == {want_variant: 2}, name


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
