"""Port BFS against the reference (xla provider): labels, preds,
iterations, pull_iters, edges_visited, overflow and converged equal, on
every fixture, for B ∈ {1, 8}, a high-degree and an isolated source,
tiered and pinned to the top tier, and under the TWC and THREAD
strategies with idempotence and direction optimization on and off (one
case where hash culling overflows the vertex frontier). Two cases run
the reference on its Pallas kernels (interpret mode, small graph)."""
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


@pytest.mark.parametrize("strategy", ["TWC", "THREAD"])
@pytest.mark.parametrize("idempotence", [True, False])
@pytest.mark.parametrize("direction", [True, False])
def test_bfs_strategies_match_reference(pair, strategy, idempotence,
                                        direction):
    """The unfused push at full capacity (the Fig. 19 / 20 ablations):
    labels, last-slot predecessors, overflow and iterations equal."""
    jg, tg = pair
    srcs = _sources(tg, "batch8")
    kw = dict(strategy=strategy, idempotence=idempotence,
              direction=direction)
    _assert_same(jbfs_batch(jg, srcs, backend="xla", **kw),
                 bfs_batch(tg, srcs, **kw))
    src = _sources(tg, "high")[0]
    _assert_same(jbfs(jg, src, backend="xla", **kw), bfs(tg, src, **kw))


@pytest.mark.parametrize("direction", [True, False])
def test_bfs_hash_overflow_matches_reference(direction):
    """A seeded search over rmat scale 11 (n = 2048 > the 1024-slot hash
    table, so ids collide) found rmat(11, 16, seed=2): from its hub and
    vertex 0 under TWC with hash culling, lane 1's leftover duplicates
    pass the min(n, m) vertex frontier, and the clamp drops some."""
    jg, tg = _pair(JG.rmat(11, 16, seed=2, weighted=True))
    srcs = [_sources(tg, "high")[0], 0]
    kw = dict(strategy="TWC", idempotence=True, direction=direction)
    tr = bfs_batch(tg, srcs, **kw)
    _assert_same(jbfs_batch(jg, srcs, backend="xla", **kw), tr)
    if not direction:
        assert int(tr.overflow[1]) > 0


def test_bfs_strategies_match_pallas_reference():
    jg, tg = _pair(JG.rmat(6, 4, seed=1, weighted=True))
    srcs = [0, 5, 17]
    for strategy in ("TWC", "THREAD"):
        _assert_same(jbfs_batch(jg, srcs, backend="pallas",
                                strategy=strategy, direction=False),
                     bfs_batch(tg, srcs, strategy=strategy,
                               direction=False))
