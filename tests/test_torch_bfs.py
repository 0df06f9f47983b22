"""Port BFS against the reference (xla provider): labels, preds,
iterations, pull_iters, edges_visited, overflow and converged equal, on
both fixtures, for B ∈ {1, 8}, a high-degree and an isolated source,
tiered and pinned to the top tier. One case runs the reference on its
Pallas kernels (interpret mode, small graph)."""
import numpy as np
import pytest

from repro.core import graph as JG
from repro.core.primitives import bfs as jbfs
from repro.core.primitives import bfs_batch as jbfs_batch
from repro_torch import convert
from repro_torch.core.graph import TENSOR_FIELDS
from repro_torch.core.primitives import bfs, bfs_batch


def _pair(jg):
    return jg, convert.graph_from_arrays(
        {f: np.asarray(getattr(jg, f)) for f in TENSOR_FIELDS},
        ell_width=jg.ell_width, csc_ell_width=jg.csc_ell_width,
        device="cpu")


# the directed rmat's CSC differs from its CSR, so a CSR / CSC mix-up
# shows there (the other two fixtures are symmetric)
FIXTURES = {"rmat": lambda: JG.rmat(9, 8, seed=7, weighted=True),
            "grid": lambda: JG.grid2d(20, weighted=True, seed=3),
            "directed": lambda: JG.rmat(8, 8, seed=3, undirected=False,
                                        weighted=True)}


@pytest.fixture(scope="module", params=sorted(FIXTURES))
def pair(request):
    return _pair(FIXTURES[request.param]())


def _assert_same(jr, tr):
    for f in jr._fields:
        want, got = np.asarray(getattr(jr, f)), getattr(tr, f).numpy()
        assert np.array_equal(want, got), f


def _sources(g, which):
    deg = np.diff(g.row_offsets.numpy())
    if which == "high":
        return [int(np.argmax(deg))]
    if which == "isolated":
        return [int(np.argmin(deg))]
    return [int(s) for s in
            np.random.default_rng(0).choice(g.num_vertices, 8, replace=False)]


@pytest.mark.parametrize("which", ["high", "isolated", "batch8"])
@pytest.mark.parametrize("tiered", [True, False])
def test_bfs_batch_matches_reference(pair, which, tiered):
    jg, tg = pair
    srcs = _sources(tg, which)
    jr = jbfs_batch(jg, srcs, backend="xla", tiered=tiered)
    tr = bfs_batch(tg, srcs, tiered=tiered)
    _assert_same(jr, tr)


def test_bfs_hub_source_pulls():
    """The rmat fixture's hub source takes the pull path (and compacts
    its bitmap back to a queue), so the parity above covers it."""
    _, tg = _pair(JG.rmat(9, 8, seed=7, weighted=True))
    tr = bfs(tg, _sources(tg, "high")[0])
    assert int(tr.pull_iters) > 0
    assert int(tr.iterations) > int(tr.pull_iters)


def test_bfs_single_squeezes_and_variants(pair):
    jg, tg = pair
    src = _sources(tg, "high")[0]
    _assert_same(jbfs(jg, src, backend="xla"), bfs(tg, src))
    # push only, no predecessors
    jr = jbfs_batch(jg, [src, 0], backend="xla", direction=False,
                    record_preds=False)
    tr = bfs_batch(tg, [src, 0], direction=False, record_preds=False)
    _assert_same(jr, tr)


def test_bfs_matches_pallas_reference():
    jg, tg = _pair(JG.rmat(6, 4, seed=1, weighted=True))
    srcs = [0, 5, 17]
    _assert_same(jbfs_batch(jg, srcs, backend="pallas"),
                 bfs_batch(tg, srcs))


def test_bfs_rejects_unported_strategy(pair):
    _, tg = pair
    with pytest.raises(NotImplementedError, match="later slice"):
        bfs(tg, 0, strategy="TWC")
