"""The port's observability layer against the reference's (``repro.obs``):
telemetry traces equal column by column for the six primitives (batched
lanes included) and bit-invisible to the results; histogram quantiles and
Prometheus text equal for the same observations; spans, the Chrome trace
and the logger; the enactor's one host read a step with telemetry on."""
import functools
import json
import logging

import numpy as np
import pytest
import torch

from repro.core import graph as JG
from repro.core import primitives as JP
from repro.obs import metrics as JM
from repro.obs import telemetry as JT
from repro_torch import convert, obs
from repro_torch.core import enactor
from repro_torch.core import primitives as TP
from repro_torch.core.graph import TENSOR_FIELDS
from repro_torch.obs import metrics as TM
from repro_torch.obs import telemetry as TT

SSSP_DELTA = 40.0      # explicit: the auto delta's float32 mean may differ
# PageRank against the reference at tol = 0 (its default): the ranks
# differ by ulps (ROADMAP C-ref-3, the reference's fused multiply-add),
# so a vertex near a tol > 0 threshold may settle one sweep apart


def _pair(jg):
    return jg, convert.graph_from_arrays(
        {f: np.asarray(getattr(jg, f)) for f in TENSOR_FIELDS},
        ell_width=jg.ell_width, csc_ell_width=jg.csc_ell_width,
        device="cpu")


GRAPHS = ("rmat", "grid", "directed")


@functools.lru_cache(maxsize=None)
def _graphs(name):
    if name == "rmat":
        return _pair(JG.rmat(9, 8, seed=7, weighted=True))
    if name == "grid":
        return _pair(JG.grid2d(20, weighted=True, seed=3))
    return _pair(JG.rmat(8, 8, seed=3, undirected=False, weighted=True))


@pytest.fixture(scope="module", params=GRAPHS)
def pair(request):
    return _graphs(request.param)


def _lanes(g, b):
    """The hub first, then ``b - 1`` seeded others (ragged depths)."""
    deg = np.diff(np.asarray(g.row_offsets))
    rest = np.random.default_rng(5).choice(len(deg), b - 1, replace=False)
    return [int(np.argmax(deg))] + [int(s) for s in rest]


def _run(pkg, prim, g, srcs, telemetry, tol=0.0):
    if prim == "bfs":
        return pkg.bfs_batch(g, srcs, telemetry=telemetry,
                             **({"backend": "xla"} if pkg is JP else {}))
    if prim == "sssp":
        return pkg.sssp_batch(g, srcs, delta=SSSP_DELTA,
                              telemetry=telemetry,
                              **({"backend": "xla"} if pkg is JP else {}))
    if prim == "pagerank":
        return pkg.pagerank(g, max_iter=10, tol=tol, telemetry=telemetry,
                            **({"backend": "xla"} if pkg is JP else {}))
    if prim == "cc":
        return pkg.connected_components(g, telemetry=telemetry)
    if prim == "bc":
        return pkg.bc_batch(g, srcs, telemetry=telemetry)
    return pkg.triangle_count(g, telemetry=telemetry)


PRIMS = ("bfs", "sssp", "pagerank", "cc", "bc", "tc")
BATCHED = ("bfs", "sssp", "bc")
# (graph, primitive, lanes): triangle counting takes undirected graphs,
# and only the traversals have lanes
CASES = [(g, p, b) for g in GRAPHS for p in PRIMS
         for b in ((1, 3) if p in BATCHED else (1,))
         if not (p == "tc" and g == "directed")]


def _trace(mod, prim, res, buf):
    lanes = (np.asarray(res.iterations) if prim in ("bfs", "sssp")
             else None)
    if mod is TT and lanes is not None:
        lanes = res.iterations
    return mod.trim(buf, lanes)


# ---------------------------------------------------------------- telemetry

@pytest.mark.parametrize("graph,prim,b", CASES)
def test_telemetry_trace_equals_reference(graph, prim, b):
    jg, tg = _graphs(graph)
    srcs = _lanes(jg, b)
    jr, jbuf = _run(JP, prim, jg, srcs, True)
    tr, tbuf = _run(TP, prim, tg, srcs, True)
    jt, tt = _trace(JT, prim, jr, jbuf), _trace(TT, prim, tr, tbuf)
    assert tt.steps == jt.steps
    assert tbuf.cursor == int(jbuf.cursor)
    assert tt.names == jt.names
    for name in jt.names:
        assert np.array_equal(tt[name], jt[name]), name
    for lane in range(b if prim in ("bfs", "sssp") else 0):
        tl, jl = tt.lane(lane), jt.lane(lane)
        assert tl.steps == jl.steps
        for name in jl.names:
            assert np.array_equal(tl[name], jl[name]), (lane, name)


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x.numpy()]
    if isinstance(x, tuple):
        return [v for item in x for v in _leaves(item)]
    if isinstance(x, np.ndarray):
        return [x]
    return [np.asarray(x)]


@pytest.mark.parametrize("graph,prim", sorted({c[:2] for c in CASES}))
def test_telemetry_changes_no_result_bit(graph, prim):
    _, tg = _graphs(graph)
    srcs = _lanes(tg, 3)
    plain = _leaves(_run(TP, prim, tg, srcs, False, tol=1e-6))
    with_t = _leaves(_run(TP, prim, tg, srcs, True, tol=1e-6)[0])
    assert len(plain) == len(with_t)
    for x, y in zip(plain, with_t):
        assert np.array_equal(x, y), prim


@pytest.mark.parametrize("single", [False, True])
def test_bfs_frontier_column_is_the_level_oracle(pair, single):
    _, tg = pair
    srcs = _lanes(tg, 1 if single else 3)
    if single:
        r, buf = TP.bfs(tg, srcs[0], telemetry=True)
        labels, iters = r.labels[None], r.iterations[None]
    else:
        r, buf = TP.bfs_batch(tg, srcs, telemetry=True)
        labels, iters = r.labels, r.iterations
    trace = TT.trim(buf, iters)
    assert trace.steps == int(iters.max())
    for lane in range(len(labels)):
        lt = trace.lane(lane)
        lab = labels[lane].numpy()
        counts = np.bincount(lab[lab >= 0], minlength=lt.steps + 1)
        assert np.array_equal(lt["frontier"], counts[1:lt.steps + 1])
        assert lt["frontier"][-1] == 0
    assert set(np.unique(trace["direction"])) <= {0, 1}
    assert np.all(trace["tier"] > 0)


def test_telemetry_adds_no_host_read(pair):
    """The enactor reads the host once a step with telemetry on, as
    off; ``trim`` is the one read after the loop."""
    _, tg = pair
    srcs = _lanes(tg, 3)
    reads = []
    for telemetry in (False, True):
        enactor.reset_host_reads()
        r = TP.bfs_batch(tg, srcs, telemetry=telemetry)
        reads.append(enactor.host_reads())
    assert reads[0] == reads[1] == int(r[0].iterations.max()) + 1


def test_buffer_drops_past_capacity_but_counts():
    buf = TT.TelemetryBuffer.make(2, {"x": ((), torch.int32)}, "cpu")
    for i in range(5):
        buf.record(x=i)
    assert buf.cursor == 5
    trace = TT.trim(buf)
    assert trace.steps == 2 and np.array_equal(trace["x"], [0, 1])
    with pytest.raises(KeyError):
        buf.record(y=1)


def test_format_table_renders_direction_as_reference():
    spec = {"frontier": (1,), "direction": (1,)}
    jbuf = JT.TelemetryBuffer.make(2, {k: (v, np.int32)
                                       for k, v in spec.items()})
    tbuf = TT.TelemetryBuffer.make(2, {k: (v, torch.int32)
                                       for k, v in spec.items()}, "cpu")
    for f, d in ((7, 0), (3, 1)):
        jbuf = jbuf.record(frontier=np.array([f]), direction=np.array([d]))
        tbuf.record(frontier=torch.tensor([f]), direction=torch.tensor([d]))
    table = TT.trim(tbuf).format_table(prefix="  ")
    assert table == JT.trim(jbuf).format_table(prefix="  ")
    assert "push" in table and "pull" in table


# ------------------------------------------------------------------ metrics

SAMPLES = {
    "lognormal": np.random.default_rng(0).lognormal(1.0, 0.7, size=2000),
    "two": np.array([10.0, 20.0]),
    "one": np.array([5.0]),
    "wide": np.random.default_rng(1).uniform(0.001, 5e5, size=300),
}


@pytest.mark.parametrize("name", sorted(SAMPLES))
def test_histogram_and_summaries_equal_reference(name):
    xs = SAMPLES[name]
    jh, th = JM.Histogram(), TM.Histogram()
    jh.observe_many(xs)
    th.observe_many(xs)
    assert np.array_equal(th.counts, jh.counts)
    for q in (0.0, 0.25, 0.5, 0.95, 0.99, 1.0):
        assert th.quantile(q) == jh.quantile(q)
        assert TM.quantile(xs, q) == JM.quantile(xs, q)
    assert th.summary() == jh.summary()
    assert TM.latency_summary(xs) == JM.latency_summary(xs)


def _metric_calls(m):
    rng = np.random.default_rng(3)
    for kind in ("bfs", "sssp", "pagerank"):
        for v in rng.lognormal(2.0, 1.0, size=40):
            m.observe("latency_ms", float(v), help="per-query latency",
                      kind=kind)
        m.counter("queries_total", 40, help="queries", kind=kind)
        m.observe("batch_occupancy", 0.75, help="occupancy", kind=kind)
    m.gauge_max("queue_depth_peak", 7, help="peak depth")
    m.gauge_max("queue_depth_peak", 3, help="peak depth")
    m.gauge("exchange", 1.5e-7)
    m.counter("cache_hits_total", 0, help="answer-cache hits")
    return m.render()


def test_prometheus_text_equals_reference():
    text = _metric_calls(TM.Metrics())
    assert text == _metric_calls(JM.Metrics())
    assert "graph_serve_latency_ms_bucket" in text
    assert 'graph_serve_latency_ms_quantile{kind="bfs",quantile="0.99"}' \
        in text
    other = TM.Metrics()
    other.counter("x", 1)
    with pytest.raises(ValueError):
        other.gauge("x", 1.0)


def test_histogram_merge_and_layout_guard():
    a, b = TM.Histogram(), TM.Histogram()
    a.observe_many([1.0, 2.0, 4.0])
    b.observe_many([8.0, 16.0])
    assert a.merge(b).total == 5 and a.quantile(1.0) == 16.0
    with pytest.raises(ValueError):
        a.merge(TM.Histogram(buckets=4))


# ------------------------------------------------------------------ tracing

def test_spans_nest_and_export_chrome_trace(tmp_path):
    obs.reset()
    with obs.span("outer", category="setup"):
        with obs.span("inner", category="dispatch", args={"k": 1},
                      sync=(torch.ones(3), {"x": [torch.zeros(1)]})):
            pass
    with obs.timed_span("timed") as t:
        pass
    assert t["ms"] >= 0
    assert [e.name for e in obs.registry().events] == ["inner", "outer",
                                                       "timed"]
    out = tmp_path / "trace.json"
    assert obs.export_chrome_trace(str(out)) == 3
    doc = json.loads(out.read_text())
    for ev in doc["traceEvents"]:
        assert ev["ph"] == "X" and ev["dur"] >= 0 and "ts" in ev
    inner = [e for e in doc["traceEvents"] if e["name"] == "inner"][0]
    assert inner["args"] == {"k": 1}
    assert obs.registry().total_ns("outer") > 0
    obs.reset()
    assert not obs.registry().events


def test_spans_are_profiler_ranges():
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span("serve_phase_marker", into=obs.SpanRegistry()):
            torch.ones(4).sum()
    assert "serve_phase_marker" in {e.key for e in prof.key_averages()}
    assert obs.tracing.cuda_devices([torch.ones(1), {"a": (1, 2)}]) == set()


# ---------------------------------------------------------------------- log

def test_logger_hierarchy_levels_and_format(capsys):
    from repro_torch.obs import log as L
    lg = L.get_logger("graph_serve")
    assert lg.name == "repro_torch.graph_serve"
    assert L.configure("debug").level == logging.DEBUG
    assert L.configure(logging.WARNING).level == logging.WARNING
    lg.info("hidden")
    lg.warning("shown")
    L.configure("info")
    lg.info("plain")
    out = capsys.readouterr().out.splitlines()
    assert out == ["[graph_serve] WARNING: shown", "[graph_serve] plain"]
    with pytest.raises(ValueError, match="unknown log level"):
        L.configure("loud")


def test_deprecated_warns():
    from repro_torch.obs.log import deprecated
    with pytest.warns(DeprecationWarning, match="gone soon"):
        deprecated("gone soon")


# ---- distributed_trace ----------------------------------------------------

@pytest.mark.parametrize("shape,tiles", [((4,), None), ((2, 2), None),
                                         ((2, 2), 3)])
def test_distributed_trace_equals_reference(shape, tiles):
    """The comm-model trace of a distributed BFS (bytes a step and the
    frontier from the labels) equals the reference's column for
    column."""
    from repro.core.partition import partition_1d as jp1
    from repro.core.partition import partition_2d as jp2
    from repro_torch.core import distributed as D
    from repro_torch.core.graph import rmat
    from repro_torch.core.partition import Mesh, partition_1d, partition_2d
    jg = JG.rmat(8, 8, seed=3)
    tg = rmat(8, 8, seed=3, device="cpu")
    src = int(np.argmax(np.diff(tg.row_offsets.numpy())))
    if len(shape) == 1:
        jpg, tpg = jp1(jg, *shape), partition_1d(tg, *shape)
        mesh = Mesh.on("cpu", shape, ("graph",))
    else:
        jpg, tpg = jp2(jg, *shape), partition_2d(tg, *shape)
        mesh = Mesh.on("cpu", shape, ("row", "col"))
    r = D.distributed_bfs(tpg, src, mesh)
    got = obs.distributed_trace(tpg, "bfs", r.iterations, r.labels,
                                tiles=tiles)
    want = JT.distributed_trace(jpg, "bfs", r.iterations,
                                r.labels.numpy(), tiles=tiles)
    assert got.steps == want.steps == r.iterations
    assert set(got.names) == set(want.names) == {"exchange_bytes",
                                                 "frontier"}
    for name in want.names:
        assert np.array_equal(got[name], want[name]), name
    assert got["frontier"].sum() == int((r.labels > 0).sum())
    for prim in ("sssp", "cc", "pagerank"):
        assert np.array_equal(
            obs.distributed_trace(tpg, prim, 5)["exchange_bytes"],
            JT.distributed_trace(jpg, prim, 5)["exchange_bytes"])
