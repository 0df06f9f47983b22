"""Port operators against the reference's xla providers, bit for bit, on
the rmat fixture at two capacity tiers: advance(_batch),
advance_filter(_batch), advance_pull(_batch), the scatters. One case
per kernel also runs the reference's Pallas kernel (interpret mode on
a small graph); ints must be equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import frontier as JF
from repro.core import graph as JG
from repro.core import operators as JO
from repro_torch import convert
from repro_torch.core import backend as TB
from repro_torch.core import frontier as TF
from repro_torch.core import operators as TO
from repro_torch.core.graph import TENSOR_FIELDS
from repro_torch.kernels import ops as K


def _pair(jg):
    tg = convert.graph_from_arrays(
        {f: np.asarray(getattr(jg, f)) for f in TENSOR_FIELDS},
        ell_width=jg.ell_width, csc_ell_width=jg.csc_ell_width,
        device="cpu")
    return jg, tg


@pytest.fixture(scope="module")
def pair():
    return _pair(JG.rmat(9, 8, seed=7, weighted=True))


@pytest.fixture(scope="module")
def small_pair():
    return _pair(JG.rmat(6, 4, seed=1, weighted=True))


def _frontiers(n, b, cap, seed):
    rng = np.random.default_rng(seed)
    ids = np.full((b, cap), -1, np.int32)
    lengths = rng.integers(0, cap + 1, size=b).astype(np.int32)
    for i in range(b):
        ids[i, :lengths[i]] = rng.choice(n, size=lengths[i], replace=False)
    return ids, lengths


def _both(ids, lengths):
    return (JF.BatchedSparseFrontier(jnp.asarray(ids), jnp.asarray(lengths)),
            TF.BatchedSparseFrontier(torch.from_numpy(ids),
                                     torch.from_numpy(lengths)))


def _eq(a, b):
    assert np.array_equal(np.asarray(a), b.numpy())


TIERS = [512, None]      # a small tier and the top one (m)


@pytest.mark.parametrize("tier", TIERS)
def test_advance_batch_matches_reference(pair, tier):
    jg, tg = pair
    cap = tier or tg.num_edges
    ids, lengths = _frontiers(tg.num_vertices, 3, 40, seed=5)
    jf, tf = _both(ids, lengths)
    jr, _ = JO.advance_batch(jg, jf, cap, backend="xla")
    tr, _ = TO.advance_batch(tg, tf, cap)
    for f in jr._fields:
        _eq(getattr(jr, f), getattr(tr, f))


def test_advance_single_and_functor_match_reference(pair):
    jg, tg = pair
    ids, lengths = _frontiers(tg.num_vertices, 1, 30, seed=6)
    jf, tf = _both(ids, lengths)

    def jfun(s, d, e, r, v, data):
        return v & (d % 3 == 0), data

    def tfun(s, d, e, r, v, data):
        return v & (d % 3 == 0), data

    jr, _ = JO.advance(jg, jf.lane(0), 2048, functor=jfun, backend="xla")
    tr, _ = TO.advance(tg, tf.lane(0), 2048, functor=tfun)
    for f in jr._fields:
        _eq(getattr(jr, f), getattr(tr, f))
    # an edge frontier expands its destinations' lists
    jr, _ = JO.advance(jg, jf.lane(0), 4096, input_kind="edge",
                       backend="xla")
    tr, _ = TO.advance(tg, tf.lane(0), 4096, input_kind="edge")
    _eq(jr.dst, tr.dst)


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("cap_front", [None, 7])
def test_advance_filter_batch_matches_reference(pair, tier, cap_front):
    jg, tg = pair
    n = tg.num_vertices
    cap = tier or tg.num_edges
    ids, lengths = _frontiers(n, 4, 60, seed=7)
    jf, tf = _both(ids, lengths)
    visited = np.random.default_rng(8).random((4, n)) < 0.3
    jr = JO.advance_filter_batch(jg, jf, jnp.asarray(visited), cap,
                                 cap_front=cap_front, backend="xla")
    tr = TO.advance_filter_batch(tg, tf, torch.from_numpy(visited), cap,
                                 cap_front=cap_front)
    _eq(jr[0].ids, tr[0].ids)
    _eq(jr[0].lengths, tr[0].lengths)
    _eq(jr[1], tr[1])
    _eq(jr[2], tr[2])
    # the kernel wrapper on CPU tensors is the plain version, no launch
    before = K.KERNELS["advance_filter_batch"].launches
    base, sizes = TO._base_and_sizes(tg, tf.ids, tf.valid_mask, "vertex")
    out = K.advance_filter_batch(tg.row_offsets, tg.col_indices, base,
                                 sizes, torch.from_numpy(visited), cap,
                                 cap_front or 60, tg.cache)
    assert torch.equal(out[0], tr[0].ids) and torch.equal(out[3], tr[2])
    assert K.KERNELS["advance_filter_batch"].launches == before


def test_advance_filter_single_matches_reference(pair):
    jg, tg = pair
    n = tg.num_vertices
    ids, lengths = _frontiers(n, 1, 50, seed=9)
    jf, tf = _both(ids, lengths)
    visited = np.random.default_rng(10).random(n) < 0.2
    jr = JO.advance_filter(jg, jf.lane(0), jnp.asarray(visited), 1024,
                           backend="xla")
    tr = TO.advance_filter(tg, tf.lane(0), torch.from_numpy(visited), 1024)
    _eq(jr[0].ids, tr[0].ids)
    assert int(jr[0].length) == int(tr[0].length)
    _eq(jr[1], tr[1])
    assert int(jr[2]) == int(tr[2])


def test_advance_kernels_match_pallas(small_pair):
    """K1 and K3's reference kernels in Pallas interpret mode."""
    jg, tg = small_pair
    n = tg.num_vertices
    ids, lengths = _frontiers(n, 2, 16, seed=11)
    jf, tf = _both(ids, lengths)
    jr, _ = JO.advance_batch(jg, jf, 512, backend="pallas")
    tr, _ = TO.advance_batch(tg, tf, 512)
    for f in jr._fields:
        _eq(getattr(jr, f), getattr(tr, f))
    visited = np.random.default_rng(12).random((2, n)) < 0.25
    jr = JO.advance_filter_batch(jg, jf, jnp.asarray(visited), 512,
                                 backend="pallas")
    tr = TO.advance_filter_batch(tg, tf, torch.from_numpy(visited), 512)
    _eq(jr[0].ids, tr[0].ids)
    _eq(jr[1], tr[1])
    _eq(jr[2], tr[2])


def test_advance_to_vertex_frontier_matches_reference(pair):
    jg, tg = pair
    ids, lengths = _frontiers(tg.num_vertices, 2, 30, seed=16)
    jf, tf = _both(ids, lengths)
    jr, _ = JO.advance_batch(jg, jf, 2048, backend="xla")
    tr, _ = TO.advance_batch(tg, tf, 2048)
    jv = JO.advance_to_vertex_frontier_batch(jr, 700, backend="xla")
    tv = TO.advance_to_vertex_frontier_batch(tr, 700)
    _eq(jv.ids, tv.ids)
    _eq(jv.lengths, tv.lengths)
    js = JO.advance_to_vertex_frontier(
        JO.AdvanceResult(*(t[0] for t in jr)), backend="xla")
    ts = TO.advance_to_vertex_frontier(TO.AdvanceResult(*(t[0] for t in tr)))
    _eq(js.ids, ts.ids)


def test_frontier_workload_matches_reference(pair):
    jg, tg = pair
    ids, lengths = _frontiers(tg.num_vertices, 3, 20, seed=13)
    jf, tf = _both(ids, lengths)
    _eq(JO.frontier_workload(jg, jf), TO.frontier_workload(tg, tf))


@pytest.mark.parametrize("kind", ["rmat", "grid"])
def test_advance_pull_batch_matches_reference(kind):
    jg, tg = _pair(JG.rmat(9, 8, seed=7, weighted=True) if kind == "rmat"
                   else JG.grid2d(20, weighted=True, seed=3))
    n = tg.num_vertices
    rng = np.random.default_rng(14)
    cur = rng.random((3, n)) < 0.1
    unv = rng.random((3, n)) < 0.7
    jn, jp = JO.advance_pull_batch(jg, JF.BatchedDenseFrontier(
        jnp.asarray(unv)), JF.BatchedDenseFrontier(jnp.asarray(cur)),
        return_preds=True)
    tn, tp = TO.advance_pull_batch(tg, TF.BatchedDenseFrontier(
        torch.from_numpy(unv)), TF.BatchedDenseFrontier(
        torch.from_numpy(cur)), return_preds=True)
    _eq(jn.flags, tn.flags)
    _eq(jp, tp)
    one = TO.advance_pull(tg, TF.DenseFrontier(torch.from_numpy(unv[0])),
                          TF.DenseFrontier(torch.from_numpy(cur[0])))
    _eq(jn.flags[0], one.flags)


def test_scatters_match_reference():
    rng = np.random.default_rng(15)
    idx = rng.integers(0, 20, 100).astype(np.int32)
    valid = rng.random(100) < 0.7
    vals = rng.integers(0, 50, 100).astype(np.float32)
    target = rng.integers(0, 60, 20).astype(np.float32)
    args = [jnp.asarray(a) for a in (vals, idx, valid, target)]
    targs = [torch.from_numpy(a) for a in (vals, idx, valid, target)]
    _eq(JO.scatter_min(*args), TO.scatter_min(*targs))
    _eq(JO.scatter_add(*args), TO.scatter_add(*targs))
    flags = np.zeros(20, bool)
    _eq(JO.scatter_or(args[1], args[2], jnp.asarray(flags)),
        TO.scatter_or(targs[1], targs[2], torch.from_numpy(flags)))


def test_lb_strategy_only(pair):
    """An unknown strategy raises, on both single and batched advance."""
    _, tg = pair
    ids, lengths = _frontiers(tg.num_vertices, 2, 8, seed=17)
    _, tf = _both(ids, lengths)
    with pytest.raises(ValueError, match="unknown strategy"):
        TO.advance_batch(tg, tf, 64, strategy="bogus")
    with pytest.raises(ValueError, match="unknown strategy"):
        TO.advance(tg, tf.lane(0), 64, strategy="bogus")


# --- the load-balancing ablation: TWC and THREAD (Fig. 20) -------------


def test_twc_order_matches_reference():
    from repro.core.operators import twc_order as jtwc
    rng = np.random.default_rng(18)
    # the class boundaries (32 | 33, 256 | 257) and many ties
    sizes = rng.choice([0, 1, 31, 32, 33, 200, 256, 257, 5000],
                       size=(3, 97)).astype(np.int32)
    want = np.stack([np.asarray(jtwc(jnp.asarray(r))) for r in sizes])
    _eq(want, TO.twc_order(torch.from_numpy(sizes)))
    _eq(want[0], TO.twc_order(torch.from_numpy(sizes[0])))


def _mod3(s, d, e, r, v, data):
    return v & (d % 3 == 0), data


@pytest.mark.parametrize("strategy", ["TWC", "THREAD"])
@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("functor", [None, _mod3])
def test_advance_strategies_match_reference(pair, strategy, tier, functor):
    """TWC and THREAD, batched and single, with and without a functor;
    at the small tier THREAD's sweep is cut (the first 512 CSR slots)."""
    jg, tg = pair
    cap = tier or tg.num_edges
    ids, lengths = _frontiers(tg.num_vertices, 3, 40, seed=19)
    jf, tf = _both(ids, lengths)
    jr, _ = JO.advance_batch(jg, jf, cap, functor=functor,
                             strategy=strategy, backend="xla")
    tr, _ = TO.advance_batch(tg, tf, cap, functor=functor,
                             strategy=strategy)
    for f in jr._fields:
        _eq(getattr(jr, f), getattr(tr, f))
    jr, _ = JO.advance(jg, jf.lane(1), cap, functor=functor,
                       strategy=strategy, backend="xla")
    tr, _ = TO.advance(tg, tf.lane(1), cap, functor=functor,
                       strategy=strategy)
    for f in jr._fields:
        _eq(getattr(jr, f), getattr(tr, f))


def test_advance_strategy_input_kinds(pair):
    """TWC expands an edge frontier's destinations; THREAD takes vertex
    frontiers only (the reference asserts, the port raises)."""
    jg, tg = pair
    ids, lengths = _frontiers(tg.num_vertices, 2, 30, seed=20)
    jf, tf = _both(ids, lengths)
    jr, _ = JO.advance_batch(jg, jf, 4096, input_kind="edge",
                             strategy="TWC", backend="xla")
    tr, _ = TO.advance_batch(tg, tf, 4096, input_kind="edge",
                             strategy="TWC")
    for f in jr._fields:
        _eq(getattr(jr, f), getattr(tr, f))
    with pytest.raises(AssertionError):
        JO.advance(jg, jf.lane(0), 64, input_kind="edge", strategy="THREAD")
    with pytest.raises(ValueError, match="vertex frontiers"):
        TO.advance(tg, tf.lane(0), 64, input_kind="edge", strategy="THREAD")


def test_advance_twc_matches_pallas(small_pair):
    """TWC over the reference's K3 in Pallas interpret mode; THREAD runs
    its plain sweep on every backend."""
    jg, tg = small_pair
    ids, lengths = _frontiers(tg.num_vertices, 2, 16, seed=21)
    jf, tf = _both(ids, lengths)
    for strategy in ("TWC", "THREAD"):
        jr, _ = JO.advance_batch(jg, jf, 512, strategy=strategy,
                                 backend="pallas")
        tr, _ = TO.advance_batch(tg, tf, 512, strategy=strategy)
        for f in jr._fields:
            _eq(getattr(jr, f), getattr(tr, f))


def test_advance_thread_launches_no_kernel(pair):
    """THREAD has no kernel: even backend="cuda" would run no K3 (on
    CPU tensors the cuda backend is refused, so the torch run counts)."""
    _, tg = pair
    ids, lengths = _frontiers(tg.num_vertices, 1, 10, seed=22)
    _, tf = _both(ids, lengths)
    before = K.KERNELS["advance_batch"].launches
    TO.advance(tg, tf.lane(0), tg.num_edges, strategy="THREAD")
    assert K.KERNELS["advance_batch"].launches == before


def test_advance_to_edge_frontier_matches_reference(pair):
    jg, tg = pair
    ids, lengths = _frontiers(tg.num_vertices, 1, 30, seed=23)
    jf, tf = _both(ids, lengths)
    for strategy in ("LB", "TWC", "THREAD"):
        jr, _ = JO.advance(jg, jf.lane(0), 2048, functor=_mod3,
                           strategy=strategy, backend="xla")
        tr, _ = TO.advance(tg, tf.lane(0), 2048, functor=_mod3,
                           strategy=strategy)
        for cap in (None, 40):
            je = JO.advance_to_edge_frontier(jr, cap, backend="xla")
            te = TO.advance_to_edge_frontier(tr, cap)
            _eq(je.ids, te.ids)
            _eq(je.length, te.length)


# --- filter, partition, neighborhood reduce, compute --------------------


def _dup_frontiers(b, cap, hi, seed):
    """Lanes of ids with many duplicates (ids < ``hi``)."""
    rng = np.random.default_rng(seed)
    ids = np.full((b, cap), -1, np.int32)
    lengths = rng.integers(cap // 2, cap + 1, size=b).astype(np.int32)
    for i in range(b):
        ids[i, :lengths[i]] = rng.integers(0, hi, size=lengths[i])
    return ids, lengths


def _odd(ids, valid, data):
    return ids % 2 == 1, data


@pytest.mark.parametrize("uniquify", ["none", "exact", "hash"])
@pytest.mark.parametrize("functor", [None, _odd])
@pytest.mark.parametrize("cap", [None, 9])
def test_filter_frontier_matches_reference(uniquify, functor, cap):
    """Hash culling at hash_size 8 over ids up to 40, so slots collide:
    the owner of a slot (its last kept lane) decides who survives. cap 9
    clamps the survivors, which the batched form counts as overflow."""
    ids, lengths = _dup_frontiers(4, 64, 40, seed=24)
    jf, tf = _both(ids, lengths)
    kw = dict(n=40, uniquify=uniquify, cap=cap, hash_size=8)
    jr, _, jo = JO.filter_frontier_batch(jf, functor=functor, backend="xla",
                                         **kw)
    tr, _, to = TO.filter_frontier_batch(tf, functor=functor, **kw)
    _eq(jr.ids, tr.ids)
    _eq(jr.lengths, tr.lengths)
    _eq(jo, to)
    if cap and uniquify != "exact":
        assert int(to.sum()) > 0
    js, _ = JO.filter_frontier(jf.lane(2), functor=functor, backend="xla",
                               **kw)
    ts, _ = TO.filter_frontier(tf.lane(2), functor=functor, **kw)
    _eq(js.ids, ts.ids)
    _eq(js.length, ts.length)


def test_filter_frontier_matches_pallas():
    """The compaction through the reference's K2 (Pallas interpret)."""
    ids, lengths = _dup_frontiers(2, 32, 20, seed=25)
    jf, tf = _both(ids, lengths)
    jr, _, jo = JO.filter_frontier_batch(jf, n=20, uniquify="hash",
                                         hash_size=8, cap=12,
                                         backend="pallas")
    tr, _, to = TO.filter_frontier_batch(tf, n=20, uniquify="hash",
                                         hash_size=8, cap=12)
    _eq(jr.ids, tr.ids)
    _eq(jo, to)


def test_filter_frontier_rejects_bad_uniquify():
    _, tf = _both(*_dup_frontiers(1, 8, 5, seed=26))
    with pytest.raises(ValueError, match="needs the vertex count"):
        TO.filter_frontier_batch(tf, uniquify="exact")
    with pytest.raises(ValueError, match="unknown uniquify"):
        TO.filter_frontier_batch(tf, uniquify="bogus")


def test_partition_frontier_matches_reference():
    ids, lengths = _frontiers(100, 1, 30, seed=27)
    jf, tf = _both(ids, lengths)
    pred = np.random.default_rng(28).random(30) < 0.4
    for caps in ((None, None), (5, 7)):
        jn, jfar = JO.partition_frontier(jf.lane(0), jnp.asarray(pred),
                                         *caps, backend="xla")
        tn, tfar = TO.partition_frontier(tf.lane(0), torch.from_numpy(pred),
                                         *caps)
        for a, b in ((jn, tn), (jfar, tfar)):
            _eq(a.ids, b.ids)
            _eq(a.length, b.length)


@pytest.mark.parametrize("strategy", ["LB", "TWC", "THREAD"])
@pytest.mark.parametrize("reduce_op", ["add", "max", "min"])
@pytest.mark.parametrize("init", [None, -7.0])
def test_neighborhood_reduce_matches_reference(pair, strategy, reduce_op,
                                               init):
    """Integer-valued floats (the destination ids) reduce exactly under
    every op; the weights' float sums are held to a relative 1e-6 (the
    summation order may differ). Under THREAD ``in_pos`` is the source
    vertex, as in the reference. A lane whose vertex has no edge keeps
    the identity; ``init`` fills the invalid lanes."""
    jg, tg = pair
    deg = np.diff(tg.row_offsets.numpy())
    ids, lengths = _frontiers(tg.num_vertices, 1, 24, seed=29)
    ids[0, 3] = int(np.argmin(deg))           # an edgeless vertex
    lengths[0] = max(lengths[0], 4)
    jf, tf = _both(ids, lengths)
    jw, tw = jg.edge_values, tg.edge_values

    def jdst(s, d, e, v, data):
        return d.astype(jnp.float32)

    def tdst(s, d, e, v, data):
        return d.to(torch.float32)

    def jwt(s, d, e, v, data):
        return jw[jnp.where(v, e, 0)]

    def twt(s, d, e, v, data):
        return tw[torch.where(v, e, 0).long()]

    for jmap, tmap, exact in ((jdst, tdst, True), (jwt, twt, False)):
        want = np.asarray(JO.neighborhood_reduce(
            jg, jf.lane(0), 2048, jmap, reduce_op, init=init,
            strategy=strategy, backend="xla"))
        got = TO.neighborhood_reduce(tg, tf.lane(0), 2048, tmap, reduce_op,
                                     init=init, strategy=strategy).numpy()
        if exact or reduce_op != "add":
            assert np.array_equal(want, got)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6)


def test_compute_matches_reference():
    ids, lengths = _frontiers(50, 1, 12, seed=30)
    jf, tf = _both(ids, lengths)

    def jfun(i, v, data):
        return data.at[i].add(jnp.where(v, 1, 0))

    def tfun(i, v, data):
        return data.index_add(0, i.long(), v.to(torch.int32))

    _eq(JO.compute(jf.lane(0), jfun, jnp.zeros(50, jnp.int32)),
        TO.compute(tf.lane(0), tfun, torch.zeros(50, dtype=torch.int32)))


# --- segmented search (K5) and segmented intersection -------------------


def _search_inputs(tg, count, seed):
    """``count`` probes into the CSR columns: whole rows (empty ones
    included), needles drawn from the row or at random, and a tail of
    -1 padding lanes (lo = hi = 0, needle -1) as the Pallas wrapper pads."""
    rng = np.random.default_rng(seed)
    ro = tg.row_offsets.numpy()
    ci = tg.col_indices.numpy()
    n = tg.num_vertices
    live = count - count // 8
    rows = rng.integers(0, n, size=live)
    rows[: live // 10] = np.flatnonzero(np.diff(ro) == 0)[0] if (
        np.diff(ro) == 0).any() else rows[: live // 10]
    lo, hi = ro[rows], ro[rows + 1]
    hit = rng.random(live) < 0.5
    pick = lo + (rng.random(live) * np.maximum(hi - lo, 1)).astype(np.int64)
    needles = np.where(hit & (hi > lo), ci[np.minimum(pick, len(ci) - 1)],
                       rng.integers(0, n, size=live))
    # a few empty segments cut out of non-empty rows
    hi = np.where(rng.random(live) < 0.05, lo, hi)
    pad = count - live
    cat = lambda a, v: np.concatenate([a, np.full(pad, v)]).astype(np.int32)
    return (ci.astype(np.int32), cat(lo, 0), cat(hi, 0), cat(needles, -1))


@pytest.mark.parametrize("locate", [False, True], ids=["found", "locate"])
def test_segment_search_matches_reference(pair, locate):
    jg, tg = pair
    hay, lo, hi, needles = _search_inputs(tg, 3000, seed=21)
    j = [jnp.asarray(a) for a in (hay, lo, hi, needles)]
    t = [torch.from_numpy(a) for a in (hay, lo, hi, needles)]
    if locate:
        want = np.asarray(JO._searchsorted_segment(*j, locate=True))
        got = TO._segment_locate_torch(*t)
        assert got.dtype == torch.int32
    else:
        want = np.asarray(JO._segment_search_xla(*j))
        got = TO._segment_search_torch(*t)
        assert got.dtype == torch.bool
    assert np.array_equal(want, got.numpy())
    assert (want != (-1 if locate else 0)).sum() > 100   # real hits
    # the registry op and the kernel wrappers on CPU tensors: the plain
    # version, no launch
    before = K.KERNELS["segment_search"].launches
    wrap = K.segment_locate if locate else K.segment_search
    assert torch.equal(wrap(*t), got)
    if not locate:
        assert torch.equal(TB.dispatch("segment_search", "torch")(*t), got)
        assert torch.equal(TB.dispatch("segment_search", "cuda")(*t), got)
    assert K.KERNELS["segment_search"].launches == before


@pytest.mark.parametrize("locate", [False, True], ids=["found", "locate"])
def test_segment_search_matches_pallas_kernel(pair, locate):
    """K5's reference kernel in Pallas interpret mode."""
    from repro.kernels.segment_search import segment_search_kernel
    _, tg = pair
    hay, lo, hi, needles = _search_inputs(tg, 2000, seed=22)
    want = np.asarray(segment_search_kernel(
        *(jnp.asarray(a) for a in (hay, lo, hi, needles)),
        interpret=True, locate=locate))
    got = TO._searchsorted_segment(
        *(torch.from_numpy(a) for a in (hay, lo, hi, needles)),
        locate=locate)
    assert np.array_equal(want, got.numpy().astype(np.int32))


def test_segment_search_empty_haystack_reads_nothing():
    hay = torch.zeros((0,), dtype=torch.int32)
    lo = torch.zeros((50,), dtype=torch.int32)
    needles = torch.arange(50, dtype=torch.int32) - 1
    assert not TO._segment_search_torch(hay, lo, lo, needles).any()
    assert (TO._segment_locate_torch(hay, lo, lo + 3, needles) == -1).all()
    assert not K.segment_search(hay, lo, lo, needles).any()


def _pair_frontiers(n, cap, seed):
    rng = np.random.default_rng(seed)
    out = []
    length = int(rng.integers(cap // 2, cap + 1))
    for _ in range(2):
        ids = np.full(cap, -1, np.int32)
        ids[:length] = rng.integers(0, n, size=length)
        out.append(ids)
    return out, length


@pytest.mark.parametrize("cap_out", [4096, None])
def test_segmented_intersect_matches_reference(pair, cap_out):
    jg, tg = pair
    (a, b), length = _pair_frontiers(tg.num_vertices, 64, seed=23)
    deg = np.diff(tg.row_offsets.numpy())
    need = int(np.minimum(deg[a[:length]], deg[b[:length]]).sum())
    cap = cap_out or max(need, 1)       # 4096 truncates, None does not
    jr = JO.segmented_intersect(
        jg, JF.SparseFrontier(jnp.asarray(a), jnp.int32(length)),
        JF.SparseFrontier(jnp.asarray(b), jnp.int32(length)), cap,
        backend="xla")
    tr = TO.segmented_intersect(
        tg, TF.SparseFrontier(torch.from_numpy(a), torch.tensor(length)),
        TF.SparseFrontier(torch.from_numpy(b), torch.tensor(length)), cap)
    for f in jr._fields:
        _eq(getattr(jr, f), getattr(tr, f))
    assert int(tr.total) > 0


def test_segmented_intersect_on_edgeless_graph():
    """m = 0: nothing intersects."""
    from repro_torch.core.graph import Graph
    tg = Graph.from_csr(np.zeros(9, np.int32), np.zeros(0, np.int32),
                        device="cpu")
    (a, b), length = _pair_frontiers(8, 16, seed=24)
    fa = TF.SparseFrontier(torch.from_numpy(a), torch.tensor(length))
    fb = TF.SparseFrontier(torch.from_numpy(b), torch.tensor(length))
    r = TO.segmented_intersect(tg, fa, fb, 512)
    assert int(r.total) == 0 and int(r.length) == 0
    assert (r.items == -1).all() and not r.counts.any()


def test_lb_scan_saturates_past_int32():
    """A frontier of duplicates (hash culling's leftovers) can hold more
    slots than int32 counts: the scan saturates at INT32_MAX, as the
    kernels' does, so every slot below cap_out keeps its true lane (the
    reference's int32 scan wraps there)."""
    big = 2 ** 30
    sizes = torch.tensor([[3, big, big, big, 7, 0, 5]], dtype=torch.int32)
    offsets, total = TO.lb_scan(sizes)
    assert offsets.tolist() == [[0, 3, big + 3, TO.INT32_MAX, TO.INT32_MAX,
                                 TO.INT32_MAX, TO.INT32_MAX]]
    assert total.tolist() == [TO.INT32_MAX]
    exp = TO.lb_expand(sizes[0], torch.ones(7, dtype=torch.bool), 10)
    assert exp.in_pos.tolist() == [0, 0, 0] + [1] * 7
    assert exp.rank.tolist() == [0, 1, 2] + list(range(7))
    assert bool(exp.valid.all()) and int(exp.total) == TO.INT32_MAX
    # K6's plain version (on CPU tensors, the wrapper's) agrees
    k6 = K.lb_expand(sizes[0], 10)
    assert k6.in_pos.tolist() == exp.in_pos.tolist()
    assert k6.rank.tolist() == exp.rank.tolist()
    assert int(k6.total) == TO.INT32_MAX
