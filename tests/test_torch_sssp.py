"""Port SSSP against the reference (xla provider): dist, preds,
iterations, relaxations and converged equal on both fixtures for
B ∈ {1, 8}. Both get the same explicit ``delta``: the auto heuristic
takes a float32 mean whose summation order differs between the
frameworks, and another delta changes the bucket sequence and with it
the predecessor ties."""
import numpy as np
import pytest

from repro.core import graph as JG
from repro.core.primitives import sssp as jsssp
from repro.core.primitives import sssp_batch as jsssp_batch
from repro.core.primitives.sssp import sssp_bellman_ford as jbellman
from repro_torch import convert
from repro_torch.core import ref as R
from repro_torch.core.graph import TENSOR_FIELDS, Graph
from repro_torch.core.primitives import sssp, sssp_batch, sssp_bellman_ford


def _pair(jg):
    return jg, convert.graph_from_arrays(
        {f: np.asarray(getattr(jg, f)) for f in TENSOR_FIELDS},
        ell_width=jg.ell_width, csc_ell_width=jg.csc_ell_width,
        device="cpu")


@pytest.fixture(scope="module", params=["rmat", "grid"])
def pair(request):
    return _pair(JG.rmat(9, 8, seed=7, weighted=True)
                 if request.param == "rmat"
                 else JG.grid2d(20, weighted=True, seed=3))


def _assert_same(jr, tr):
    for f in jr._fields:
        want, got = np.asarray(getattr(jr, f)), getattr(tr, f).numpy()
        assert np.array_equal(want, got), f


@pytest.mark.parametrize("delta", [40.0, 7.5])
def test_sssp_batch_matches_reference(pair, delta):
    jg, tg = pair
    srcs = [int(s) for s in np.random.default_rng(1).choice(
        tg.num_vertices, 8, replace=False)]
    jr = jsssp_batch(jg, srcs, delta=delta, backend="xla")
    tr = sssp_batch(tg, srcs, delta=delta)
    _assert_same(jr, tr)
    assert np.array_equal(tr.dist.numpy(), R.sssp_ref(tg, srcs))


def test_sssp_single_and_pinned_tier(pair):
    jg, tg = pair
    src = int(np.argmax(np.diff(tg.row_offsets.numpy())))
    _assert_same(jsssp(jg, src, delta=40.0, backend="xla"),
                 sssp(tg, src, delta=40.0))
    # pinned top tier: the same bits as the tier ladder
    a = sssp_batch(tg, [src, 3], delta=40.0, tiered=False)
    b = sssp_batch(tg, [src, 3], delta=40.0)
    for x, y in zip(a, b):
        assert np.array_equal(x.numpy(), y.numpy())


def test_sssp_auto_delta_distances_exact(pair):
    _, tg = pair
    r = sssp(tg, 0)
    assert np.array_equal(r.dist.numpy(), R.sssp_ref(tg, 0))
    assert bool(r.converged)


def test_sssp_isolated_sources_match_reference():
    """A near pile with no out-edges (an isolated source beside a hub):
    the relax step sees an empty expansion."""
    jg, tg = _pair(JG.rmat(9, 8, seed=7, weighted=True))
    deg = np.diff(tg.row_offsets.numpy())
    srcs = [int(np.flatnonzero(deg == 0)[0]), int(np.argmax(deg))]
    _assert_same(jsssp_batch(jg, srcs, delta=40.0, backend="xla"),
                 sssp_batch(tg, srcs, delta=40.0))
    _assert_same(jsssp(jg, srcs[0], delta=40.0, backend="xla"),
                 sssp(tg, srcs[0], delta=40.0))


def test_sssp_edgeless_graph():
    """No edges at all (the reference's relax gathers from an empty
    weight array and fails here; the port's dists match the oracle)."""
    g = Graph.from_csr(np.zeros(9, np.int32), np.zeros(0, np.int32),
                       np.zeros(0, np.float32), device="cpu")
    r = sssp_batch(g, [0, 3], delta=1.0)
    assert np.array_equal(r.dist.numpy(), R.sssp_ref(g, [0, 3]))
    assert (r.preds.numpy() == -1).all() and bool(r.converged.all())
    assert np.array_equal(sssp(g, 5).dist.numpy(), R.sssp_ref(g, 5))


def test_sssp_matches_pallas_reference():
    jg, tg = _pair(JG.rmat(6, 4, seed=1, weighted=True))
    _assert_same(jsssp_batch(jg, [0, 9], delta=40.0, backend="pallas"),
                 sssp_batch(tg, [0, 9], delta=40.0))


def test_bellman_ford_matches_reference(pair):
    """The Ligra baseline (priority queue off) bit for bit, from the hub
    and from a seeded vertex, and the Dijkstra oracle's distances."""
    jg, tg = pair
    hub = int(np.argmax(np.diff(tg.row_offsets.numpy())))
    for src in (hub, 17):
        jr = jbellman(jg, src, backend="xla")
        tr = sssp_bellman_ford(tg, src)
        _assert_same(jr, tr)
        assert np.array_equal(tr.dist.numpy(), R.sssp_ref(tg, src))
    with pytest.raises(ValueError, match="weights"):
        sssp_bellman_ford(Graph.from_csr(np.zeros(3, np.int32),
                                         np.zeros(0, np.int32),
                                         device="cpu"), 0)


@pytest.mark.parametrize("strategy", ["TWC", "THREAD"])
@pytest.mark.parametrize("tiered", [True, False])
def test_sssp_strategies_match_reference(pair, strategy, tiered):
    """The relax advance under TWC (tiered; its winners' slot order the
    size-class order) and THREAD (the top tier, CSR order): dist, preds,
    iterations and relaxations equal, batched and single."""
    jg, tg = pair
    srcs = [int(s) for s in np.random.default_rng(2).choice(
        tg.num_vertices, 8, replace=False)]
    kw = dict(delta=7.5, strategy=strategy)
    tr = sssp_batch(tg, srcs, tiered=tiered, **kw)
    _assert_same(jsssp_batch(jg, srcs, backend="xla", tiered=tiered, **kw),
                 tr)
    assert np.array_equal(tr.dist.numpy(), R.sssp_ref(tg, srcs))
    hub = int(np.argmax(np.diff(tg.row_offsets.numpy())))
    _assert_same(jsssp(jg, hub, backend="xla", **kw), sssp(tg, hub, **kw))


@pytest.mark.parametrize("strategy", ["TWC", "THREAD"])
def test_bellman_ford_strategies_match_reference(pair, strategy):
    jg, tg = pair
    hub = int(np.argmax(np.diff(tg.row_offsets.numpy())))
    tr = sssp_bellman_ford(tg, hub, strategy=strategy)
    _assert_same(jbellman(jg, hub, strategy=strategy, backend="xla"), tr)
    assert np.array_equal(tr.dist.numpy(), R.sssp_ref(tg, hub))


def test_sssp_strategies_edgeless_and_unknown():
    g = Graph.from_csr(np.zeros(9, np.int32), np.zeros(0, np.int32),
                       np.zeros(0, np.float32), device="cpu")
    for strategy in ("TWC", "THREAD"):
        r = sssp_batch(g, [0, 3], delta=1.0, strategy=strategy)
        assert np.array_equal(r.dist.numpy(), R.sssp_ref(g, [0, 3]))
    _, tg = _pair(JG.rmat(6, 4, seed=1, weighted=True))
    with pytest.raises(ValueError, match="unknown strategy"):
        sssp(tg, 0, strategy="bogus")


def test_bucket_pop_steps_past_a_rounding_stall():
    """d = 8 with δ = fl(8/7) (the auto δ of this graph): 8/δ rounds to
    6.9999995 and 7·δ to 8.0, so the bucket ⌊8/δ⌋ = 6 holds no vertex
    below its threshold. The reference's bucket pop stalls there and
    leaves vertex 7 at inf (C-ref-11); the port steps to the next bucket
    and equals Dijkstra, single-device and under both placements."""
    from repro_torch.core import distributed as D
    from repro_torch.core.partition import Mesh, partition_1d, partition_2d
    ro = np.array([0, 4, 6, 8, 10, 11, 12, 13, 14, 14, 14, 14, 14, 14, 14])
    ci = np.array([2, 4, 5, 6, 3, 7, 0, 3, 1, 2, 0, 0, 0, 1])
    ev = np.array([6, 1, 5, 1, 1, 1, 6, 1, 1, 1, 1, 5, 1, 1], np.float32)
    tg = Graph.from_csr(ro, ci, ev, device="cpu")
    jg = JG.Graph.from_csr(ro, ci, ev)
    want = R.sssp_ref(tg, 0)
    assert want[7] == 9.0
    r = sssp(tg, 0)
    assert np.array_equal(r.dist.numpy(), want) and bool(r.converged)
    assert np.isinf(np.asarray(jsssp(jg, 0, backend="xla").dist)[7])
    for pg, mesh in ((partition_1d(tg, 2), Mesh.on("cpu", (2,), ("graph",))),
                     (partition_2d(tg, 2, 2),
                      Mesh.on("cpu", (2, 2), ("row", "col")))):
        assert np.array_equal(D.distributed_sssp(pg, 0, mesh).dist.numpy(),
                              want)
