"""The port's primitives on random graphs (the reference's property
tests, ``tests/test_primitives.py::random_graph``, drawn the same way:
4-24 vertices, 0-60 edges, integer weights 1-9, undirected).

  * hypothesis draws the graphs, built with the port's own
    ``from_edge_list`` on the CPU; ``bfs``, ``sssp``,
    ``connected_components`` and ``triangle_count`` are held to the
    ``repro_torch.core.ref`` oracles (a graph with no edge included: the
    port's SSSP reads no weight there);
  * on fixed-seed graphs drawn the same way, the reference's graph is
    carried across with ``convert.graph_from_arrays`` and the port is
    held to the reference bit for bit wherever the reference equals its
    own oracle (its SSSP once missed a relaxation on such a graph), and
    to the oracle always;
  * both, again, under the TWC and THREAD strategies (BFS with hash and
    exact uniquify).
"""
import collections

import numpy as np
import pytest
from _hyp import given, settings, st

from repro.core import graph as JG
from repro.core import primitives as JP
from repro_torch import convert
from repro_torch.core import graph as TG
from repro_torch.core import ref as R
from repro_torch.core.graph import TENSOR_FIELDS
from repro_torch.core.primitives import (bfs, connected_components, sssp,
                                         triangle_count)

MAX_EXAMPLES = 12


def _edges(n, m, draw_int):
    """(src, dst, weights) of m edges over n vertices, as random_graph
    draws them: the endpoints, then a weight 1-9 an edge."""
    ends = [(draw_int(0, n - 1), draw_int(0, n - 1)) for _ in range(m)]
    return ([a for a, _ in ends], [b for _, b in ends],
            [float(draw_int(1, 9)) for _ in ends])


@st.composite
def random_graph(draw):
    n = draw(st.integers(4, 24))
    m = draw(st.integers(0, 60))
    src, dst, w = _edges(n, m, lambda a, b: draw(st.integers(a, b)))
    return TG.from_edge_list(src, dst, n=n, values=w, undirected=True,
                             device="cpu")


def _same_partition(a, b):
    pa = collections.defaultdict(set)
    pb = collections.defaultdict(set)
    for i, (x, y) in enumerate(zip(a, b)):
        pa[x].add(i)
        pb[y].add(i)
    return sorted(map(frozenset, pa.values())) == \
        sorted(map(frozenset, pb.values()))


@given(random_graph(), st.integers(0, 3))
@settings(max_examples=MAX_EXAMPLES, deadline=None)
def test_bfs_property(g, src_seed):
    src = src_seed % g.num_vertices
    r = bfs(g, src, direction=False)
    assert np.array_equal(r.labels.numpy(), R.bfs_ref(g, src))


@given(random_graph(), st.integers(0, 3))
@settings(max_examples=MAX_EXAMPLES, deadline=None)
def test_bfs_direction_property(g, src_seed):
    src = src_seed % g.num_vertices
    r = bfs(g, src, direction=True)
    assert np.array_equal(r.labels.numpy(), R.bfs_ref(g, src))


@given(random_graph(), st.integers(0, 3))
@settings(max_examples=MAX_EXAMPLES, deadline=None)
def test_sssp_property(g, src_seed):
    src = src_seed % g.num_vertices
    r = sssp(g, src)
    assert np.allclose(r.dist.numpy(), R.sssp_ref(g, src), rtol=1e-5)


@given(random_graph(), st.integers(0, 3), st.sampled_from(["TWC", "THREAD"]),
       st.booleans())
@settings(max_examples=MAX_EXAMPLES, deadline=None)
def test_strategy_property(g, src_seed, strategy, idempotence):
    """The unfused TWC / THREAD push and relax: BFS depths and SSSP
    distances equal the oracles (n ≤ 24 ids never collide in the hash
    table, so nothing overflows)."""
    src = src_seed % g.num_vertices
    r = bfs(g, src, strategy=strategy, idempotence=idempotence,
            direction=idempotence)
    assert np.array_equal(r.labels.numpy(), R.bfs_ref(g, src))
    assert int(r.overflow) == 0
    r = sssp(g, src, strategy=strategy)
    assert np.allclose(r.dist.numpy(), R.sssp_ref(g, src), rtol=1e-5)


@given(random_graph())
@settings(max_examples=MAX_EXAMPLES, deadline=None)
def test_cc_property(g):
    r = connected_components(g)
    want = R.cc_ref(g)
    assert _same_partition(r.labels.tolist(), want.tolist())
    assert int(r.num_components) == len(set(want.tolist()))


@given(random_graph())
@settings(max_examples=MAX_EXAMPLES, deadline=None)
def test_tc_property(g):
    assert int(triangle_count(g).total) == R.tc_ref(g)


# ---- fixed seeds: the port against the reference -------------------------

SEEDS = (0, 1, 2, 3)


def _draw(seed):
    """(n, src, dst, weights) of a seeded random_graph draw (at least one
    edge: the reference's SSSP refuses a graph with none)."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(4, 25))
    m = int(rng.integers(1, 61))
    return (n, *_edges(n, m, lambda a, b: int(rng.integers(a, b + 1))))


def _pair(seed):
    """The reference's graph of ``_draw(seed)``, and the port's graph of
    the very same arrays."""
    n, src, dst, w = _draw(seed)
    jg = JG.from_edge_list(src, dst, n=n, values=w, undirected=True)
    tg = convert.graph_from_arrays(
        {f: np.asarray(getattr(jg, f)) for f in TENSOR_FIELDS},
        ell_width=jg.ell_width, csc_ell_width=jg.csc_ell_width,
        device="cpu")
    return jg, tg


@pytest.mark.parametrize("seed", SEEDS)
def test_port_graph_equals_reference_graph(seed):
    """The port's from_edge_list builds the reference's arrays."""
    n, src, dst, w = _draw(seed)
    jg = JG.from_edge_list(src, dst, n=n, values=w, undirected=True)
    tg = TG.from_edge_list(src, dst, n=n, values=w, undirected=True,
                           device="cpu")
    for f in TENSOR_FIELDS:
        want, got = getattr(jg, f), getattr(tg, f)
        assert (want is None) == (got is None), f
        if want is not None:
            assert np.array_equal(np.asarray(want), got.numpy()), f


@pytest.mark.parametrize("seed", SEEDS)
def test_bfs_matches_reference(seed):
    jg, tg = _pair(seed)
    for src in range(0, tg.num_vertices, 7):
        want = R.bfs_ref(tg, src)
        got = bfs(tg, src, direction=False)
        assert np.array_equal(got.labels.numpy(), want)
        ref = JP.bfs(jg, src, direction=False, backend="xla")
        if np.array_equal(np.asarray(ref.labels), want):
            assert np.array_equal(got.labels.numpy(),
                                  np.asarray(ref.labels))
            assert np.array_equal(got.preds.numpy(), np.asarray(ref.preds))


@pytest.mark.parametrize("seed", SEEDS)
def test_sssp_matches_reference(seed):
    jg, tg = _pair(seed)
    for src in range(0, tg.num_vertices, 7):
        want = R.sssp_ref(tg, src)
        got = sssp(tg, src)
        assert np.allclose(got.dist.numpy(), want, rtol=1e-5)
        ref = JP.sssp(jg, src, backend="xla")
        if np.allclose(np.asarray(ref.dist), want, rtol=1e-5):
            assert np.array_equal(got.dist.numpy(), np.asarray(ref.dist))


@pytest.mark.parametrize("seed", SEEDS)
def test_cc_and_tc_match_reference(seed):
    jg, tg = _pair(seed)
    got = connected_components(tg)
    want = R.cc_ref(tg).tolist()
    assert _same_partition(got.labels.tolist(), want)
    ref = np.asarray(JP.connected_components(jg).labels)
    if _same_partition(ref.tolist(), want):
        assert np.array_equal(got.labels.numpy(), ref)
    want = R.tc_ref(tg)
    assert int(triangle_count(tg).total) == want
    ref = int(JP.triangle_count(jg).total)
    if ref == want:
        assert int(triangle_count(tg).total) == ref


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("strategy", ["TWC", "THREAD"])
def test_strategies_match_reference(seed, strategy):
    """BFS (hash and exact uniquify) and SSSP under TWC and THREAD: the
    oracle always, the reference bit for bit where it equals its own."""
    jg, tg = _pair(seed)
    for src in range(0, tg.num_vertices, 7):
        want = R.bfs_ref(tg, src)
        for idem in (True, False):
            got = bfs(tg, src, strategy=strategy, idempotence=idem)
            assert np.array_equal(got.labels.numpy(), want)
            ref = JP.bfs(jg, src, strategy=strategy, idempotence=idem,
                         backend="xla")
            if np.array_equal(np.asarray(ref.labels), want):
                for f in ref._fields:
                    assert np.array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(ref, f))), f
        want = R.sssp_ref(tg, src)
        got = sssp(tg, src, delta=5.0, strategy=strategy)
        assert np.allclose(got.dist.numpy(), want, rtol=1e-5)
        ref = JP.sssp(jg, src, delta=5.0, strategy=strategy, backend="xla")
        if np.allclose(np.asarray(ref.dist), want, rtol=1e-5):
            for f in ref._fields:
                assert np.array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f))), f
