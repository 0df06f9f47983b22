"""The port's serving entry point (``repro_torch.launch.graph_serve``): the
reference's latency-accounting cases on a fake clock, the request
lifecycle under injected faults (one status a query, counters that
reconcile), ``serve_mixed`` per-query records and answers equal to the
reference's on a seeded plan, the port's no-fallback rule, and the CLI
on the CPU."""
import json
import re

import numpy as np
import pytest
import torch

from repro.core import graph as JG
from repro.ft import inject as JI
from repro.launch import graph_serve as JS
from repro.obs.metrics import Metrics as JMetrics
from repro_torch import convert
from repro_torch import ft as TF
from repro_torch.core import backend as TB
from repro_torch.core.graph import TENSOR_FIELDS
from repro_torch.ft import inject as TI
from repro_torch.launch import graph_serve as GS
from repro_torch.obs.metrics import Metrics


class FakeClock:
    """Deterministic clock: only the stub runner and backoff sleeps move
    it, so latencies are whole fake batch times."""

    def __init__(self):
        self.t = 0.0

    def monotonic(self):
        return self.t

    def sleep(self, seconds):
        self.t += seconds


def _stub_runner(clock, batch_seconds=1.0):
    def run(kind, srcs, backend, hops):
        clock.t += batch_seconds
        return (np.zeros((len(srcs), 4), np.float32),
                np.zeros(len(srcs), np.int64), None)
    return run


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    JI._reset_for_tests()
    yield
    assert TI.active() is None


# ---- the reference's three cases (tests/test_graph_serve.py) ---------------

def test_serve_mixed_latency_measured_from_enqueue(monkeypatch):
    clock = FakeClock()
    monkeypatch.setattr(GS, "time", clock)
    queries = ([("bfs", 0)] * 4) + ([("sssp", 0)] * 2) + [("reach", 0)]
    stats = GS.serve_mixed(None, queries, batch=2, backend="cuda",
                           runner=_stub_runner(clock))
    per = stats["per_kind"]
    assert per["bfs"]["lat_ms_mean"] == pytest.approx(1000.0)
    assert per["bfs"]["lat_ms_p95"] == pytest.approx(1000.0)
    assert per["sssp"]["lat_ms_mean"] == pytest.approx(1000.0)
    assert per["reach"]["lat_ms_mean"] == pytest.approx(1000.0)
    assert stats["lat_ms_p95"] == pytest.approx(1000.0)
    assert stats["batches"] == 4
    assert [f["kind"] for f in stats["flushes"]] == ["bfs", "bfs", "sssp",
                                                     "reach"]
    assert all(f["flush_ms"] == pytest.approx(1000.0)
               for f in stats["flushes"])


def test_serve_mixed_latency_includes_queue_wait(monkeypatch):
    clock = FakeClock()
    monkeypatch.setattr(GS, "time", clock)
    queries = [("sssp", 0)] + ([("bfs", 0)] * 4) + [("sssp", 0)]
    stats = GS.serve_mixed(None, queries, batch=2, backend="cuda",
                           runner=_stub_runner(clock))
    assert stats["per_kind"]["sssp"]["lat_ms_mean"] == pytest.approx(2000.0)
    assert stats["per_kind"]["bfs"]["lat_ms_mean"] == pytest.approx(1000.0)


def test_serve_mixed_empty_stream_rejected():
    with pytest.raises(ValueError):
        GS.serve_mixed(None, [], batch=2, backend="cuda",
                       runner=lambda *a: None)


# ---- the lifecycle under injected faults -----------------------------------

def _ctotal(metrics, name):
    fam = metrics._families.get(f"graph_serve_{name}")
    return 0 if fam is None else int(sum(fam.series.values()))


def _statuses(stats):
    return [q["status"] for q in stats["queries"]]


def _assert_reconciled(stats, metrics, mod=GS):
    """Counters == per-query statuses; one status a query."""
    counts = stats["status_counts"]
    assert sum(counts.values()) == stats["requests"]
    assert all(q is not None for q in stats["queries"])
    assert counts == {s: _statuses(stats).count(s) for s in mod.STATUSES}
    for st in mod.STATUSES:
        assert _ctotal(metrics, mod._STATUS_COUNTER[st]) == counts[st], st
    assert _ctotal(metrics, "queries_retried_total") == stats["retried"]


def _serve(queries, clock, monkeypatch, *, spec=None, seed=0,
           backend="cuda", **kw):
    monkeypatch.setattr(GS, "time", clock)
    metrics = Metrics()
    kw.setdefault("runner", _stub_runner(clock))
    kw.setdefault("retry", TF.RetryPolicy(retries=2, base_ms=10.0,
                                          jitter=0.0))
    if spec is None:
        stats = GS.serve_mixed(None, queries, batch=2, backend=backend,
                               metrics=metrics, **kw)
    else:
        with TI.faults(spec, seed=seed):
            stats = GS.serve_mixed(None, queries, batch=2, backend=backend,
                                   metrics=metrics, **kw)
    _assert_reconciled(stats, metrics)
    return stats


def _seed_hit_then_miss(kind, site, p):
    return next(s for s in range(64) if TI._draw(s, kind, site, 0) < p
                and TI._draw(s, kind, site, 1) >= p)


def test_provider_miss_exhausts_ladder(monkeypatch):
    stats = _serve([("bfs", 0)] * 4, FakeClock(), monkeypatch,
                   spec="provider_miss@1.0")
    assert _statuses(stats) == ["error"] * 4
    assert all("ProviderMissError" in q["reason"] for q in stats["queries"])
    assert stats["retried"] == 4
    assert [f["rung"] for f in stats["flushes"]] == \
        ["backend cuda→torch"] * 2


def test_nan_guardrail_retry_recovers(monkeypatch):
    seed = _seed_hit_then_miss("nan", "bfs", 0.6)
    stats = _serve([("bfs", 0)] * 2, FakeClock(), monkeypatch,
                   spec="nan:bfs@0.6", seed=seed, backend="torch")
    assert _statuses(stats) == ["ok", "ok"]
    assert all(q["attempts"] == 2 for q in stats["queries"])
    assert stats["retried"] == 2


def test_nan_guardrail_terminal_error(monkeypatch):
    stats = _serve([("sssp", 0)] * 2, FakeClock(), monkeypatch,
                   spec="nan@1.0")
    assert _statuses(stats) == ["error"] * 2
    assert all("PoisonedResultError" in q["reason"]
               for q in stats["queries"])


def test_degraded_batch_is_stamped_and_declared(monkeypatch):
    """A miss on attempt 0 only: the retry runs the torch rung and its
    answers are stamped degraded with the rung's reason."""
    seed = _seed_hit_then_miss("provider_miss", "bfs", 0.6)
    backends = []
    clock = FakeClock()

    def runner(kind, srcs, backend, hops):
        backends.append(backend)
        return _stub_runner(clock)(kind, srcs, backend, hops)

    stats = _serve([("bfs", 0)] * 2, clock, monkeypatch,
                   spec="provider_miss:bfs@0.6", seed=seed, runner=runner)
    assert _statuses(stats) == ["degraded"] * 2
    assert all(q["degraded_to"] == "backend cuda→torch"
               for q in stats["queries"])
    assert backends == ["torch"]
    assert stats["flushes"][0]["backend"] == "torch"
    assert TB.declared_fallback("bfs", "torch") == \
        "serve-time degradation: backend cuda→torch"
    TB._DECLARED_FALLBACKS.pop(("bfs", "torch"))


def test_deadline_expires_in_queue(monkeypatch):
    queries = [("sssp", 0)] + [("bfs", 0)] * 4 + [("sssp", 0)]
    stats = _serve(queries, FakeClock(), monkeypatch,
                   budget=TF.Budget(wall_ms=1500.0))
    sssp = [q for q in stats["queries"] if q["kind"] == "sssp"]
    assert [q["status"] for q in sssp] == ["deadline_exceeded", "ok"]
    assert "expired in queue" in sssp[0]["reason"]


def test_deadline_late_completion_is_stamped(monkeypatch):
    stats = _serve([("bfs", 0)] * 2, FakeClock(), monkeypatch,
                   budget=TF.Budget(wall_ms=500.0))
    assert _statuses(stats) == ["deadline_exceeded"] * 2
    assert all("after deadline" in q["reason"] for q in stats["queries"])


def test_admission_sheds_over_cap(monkeypatch):
    stats = _serve([("bfs", i) for i in range(4)], FakeClock(), monkeypatch,
                   admission=TF.AdmissionPolicy(max_per_kind=1))
    assert _statuses(stats) == ["ok", "shed", "shed", "shed"]


def test_iteration_budget_partial_is_deadline_exceeded(monkeypatch):
    clock = FakeClock()

    def runner(kind, srcs, backend, hops):
        clock.t += 1.0
        return (np.zeros((len(srcs), 4), np.int32),
                np.zeros(len(srcs), np.int64),
                np.array([True, False]))

    stats = _serve([("bfs", 0), ("bfs", 1)], clock, monkeypatch,
                   runner=runner)
    assert _statuses(stats) == ["ok", "deadline_exceeded"]
    assert "partial" in stats["queries"][1]["reason"]


def test_no_plan_means_no_retry_and_no_fallback(monkeypatch):
    """Without a fault plan a failing flush raises out of the stream: no
    retry, no ladder, no declared fallback."""
    calls = []

    def broken(kind, srcs, backend, hops):
        calls.append(backend)
        raise RuntimeError("kernel launch failed")

    before = TB.declared_fallbacks()
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        GS.serve_mixed(None, [("bfs", 0)] * 2, batch=2, backend="cuda",
                       runner=broken)
    assert calls == ["cuda"] and TB.declared_fallbacks() == before

    def poisoned(kind, srcs, backend, hops):
        return (np.full((len(srcs), 3), np.nan, np.float32), np.zeros(2),
                None)

    with pytest.raises(GS.PoisonedResultError):
        GS.serve_mixed(None, [("pagerank", 0)] * 2, batch=2,
                       backend="cuda", runner=poisoned)


@pytest.mark.parametrize("error", [
    RuntimeError("kernel launch failed"),
    TB.ProviderMissError("advance", "cuda"),
    GS.PoisonedResultError("a kernel wrote NaN")])
def test_plan_retries_only_injected_faults(monkeypatch, error):
    """Under a plan a runner's own error, and a miss or poison that no
    plan caused, escape the stream at once: no retry, no ladder."""
    calls = []

    def broken(kind, srcs, backend, hops):
        calls.append(backend)
        raise error

    before = TB.declared_fallbacks()
    with TI.faults("provider_miss:sssp@0.5;nan@0.5", seed=0):
        with pytest.raises(type(error), match=str(error)[:12]):
            GS.serve_mixed(None, [("bfs", 0)] * 2, batch=2,
                           backend="cuda", runner=broken,
                           retry=TF.RetryPolicy(retries=2, base_ms=0.0))
    assert calls == ["cuda"] and TB.declared_fallbacks() == before


def test_straggler_chaos_reconciles():
    """A real-clock straggler plan: statuses depend on timing, so only
    their reconciliation is checked."""
    metrics = Metrics()

    def runner(kind, srcs, backend, hops):
        return (np.zeros((len(srcs), 2), np.float32), np.zeros(len(srcs)),
                None)

    with TI.faults("straggler@0.5;nan@0.3", seed=2):
        stats = GS.serve_mixed(
            None, [(k, 0) for k in ("bfs", "sssp") for _ in range(8)],
            batch=2, backend="cuda", runner=runner, metrics=metrics,
            retry=TF.RetryPolicy(retries=1, base_ms=0.0, jitter=0.0),
            budget=TF.Budget(wall_ms=5000.0))
    _assert_reconciled(stats, metrics)
    assert "graph_serve_straggler_batches_total" in metrics.render()


# ---- against the reference's serve_mixed on a real graph ------------------

def _pair(jg):
    return jg, convert.graph_from_arrays(
        {f: np.asarray(getattr(jg, f)) for f in TENSOR_FIELDS},
        ell_width=jg.ell_width, csc_ell_width=jg.csc_ell_width,
        device="cpu")


@pytest.fixture(scope="module")
def graphs():
    return _pair(JG.rmat(8, 8, seed=7, weighted=True))


def _queries(n, count=24):
    rng = np.random.default_rng(4)
    kinds = GS.KINDS
    return [(kinds[i % 4], int(rng.integers(0, n))) for i in range(count)]


def _recording(mod, g, sink):
    def run(kind, srcs, backend, hops):
        out = mod._run_kind(g, kind, srcs, backend, hops)
        field = out[0]
        sink.append((kind, backend, hops,
                     field.numpy() if isinstance(field, torch.Tensor)
                     else np.asarray(field)))
        return out
    return run


@pytest.mark.parametrize("site,prob,seed", [
    ("bfs", 0.5, 11), ("sssp", 0.5, 11), ("pagerank", 0.5, 11),
    ("reach", 0.7, 0), ("reach", 0.7, 2)])
def test_serve_mixed_equals_reference_on_a_seeded_plan(graphs, site, prob,
                                                        seed):
    """provider_miss is scoped to one kind: the reference's registry hook
    draws when a program is traced and a warm program never draws, the
    port's once per op in each primitive call, so an unscoped clause
    would draw at different counts; nan is unscoped."""
    jg, tg = graphs
    spec = f"provider_miss:{site}@{prob};nan@0.4"
    queries = _queries(tg.num_vertices)
    runs, stats, recs = {}, {}, {}
    for name, mod, g, inj, bk, metrics in (
            ("ref", JS, jg, JI, "xla", JMetrics()),
            ("port", GS, tg, TI, "torch", Metrics())):
        recs[name] = []
        with inj.faults(spec, seed=seed):
            stats[name] = mod.serve_mixed(
                g, queries, batch=4, backend=bk, hops=3,
                runner=_recording(mod, g, recs[name]), metrics=metrics,
                retry=mod.ft.RetryPolicy(retries=2, base_ms=0.0,
                                         jitter=0.0))
        _assert_reconciled(stats[name], metrics, mod)
        runs[name] = stats[name]["queries"]
    for want, got in zip(runs["ref"], runs["port"]):
        for key in ("id", "kind", "source", "status", "attempts",
                    "degraded_to"):
            assert got.get(key) == want.get(key), (key, want, got)
        if "reason" in want:
            assert got["reason"].split(":")[0] == \
                want["reason"].split(":")[0]
    assert stats["port"]["status_counts"] == stats["ref"]["status_counts"]
    assert stats["port"]["status_counts"]["ok"] < len(queries)
    assert stats["port"]["retried"] == stats["ref"]["retried"]
    assert len(recs["port"]) == len(recs["ref"])
    for (jk, _, jh, jf), (tk, tbk, th, tf) in zip(recs["ref"],
                                                    recs["port"]):
        assert (tk, th) == (jk, jh) and tbk == "torch"
        if jk == "pagerank":         # ROADMAP C-ref-3
            assert np.allclose(tf, jf, rtol=0, atol=1e-6)
        else:
            assert np.array_equal(tf, jf), jk


def test_clean_stream_validates_and_declares_nothing(graphs):
    _, tg = graphs
    before = TB.declared_fallbacks()
    metrics = Metrics()
    stats = GS.serve_mixed(tg, _queries(tg.num_vertices, 17), batch=4,
                           backend="torch", validate=True, metrics=metrics)
    _assert_reconciled(stats, metrics)
    assert stats["status_counts"]["ok"] == 17
    assert stats["retried"] == 0 and stats["validation_failures"] == 0
    assert TB.declared_fallbacks() == before
    assert all(f["device"] == "cpu" and f["attempts"] == 1
               for f in stats["flushes"])


def test_malformed_queries_become_structured_errors(graphs):
    _, tg = graphs
    metrics = Metrics()
    n = tg.num_vertices
    queries = [("bfs", 0), ("pagerank_typo", 0), ("bfs", "zero"),
               ("sssp", n + 17), ("sssp", 1)]
    stats = GS.serve_mixed(tg, queries, batch=1, backend="torch",
                           metrics=metrics)
    _assert_reconciled(stats, metrics)
    assert _statuses(stats) == ["ok", "error", "error", "error", "ok"]
    assert "unknown kind" in stats["queries"][1]["reason"]
    assert "not an integer" in stats["queries"][2]["reason"]
    assert "out of range" in stats["queries"][3]["reason"]


def test_single_kind_serve_validates(graphs):
    _, tg = graphs
    for prim in ("bfs", "sssp"):
        m = Metrics()
        stats = GS.serve(tg, prim, np.arange(7), 3, "torch", validate=True,
                         metrics=m)
        assert stats["batches"] == 3 and stats["validation_failures"] == 0
        assert stats["samples"] == 7


# ---- the CLI ---------------------------------------------------------------

def test_cli_smoke_on_cpu(tmp_path, capsys):
    out_json = tmp_path / "rows.json"
    out_prom = tmp_path / "metrics.prom"
    out_trace = tmp_path / "trace.json"
    argv = ["--scale", "7", "--kinds", "bfs,sssp,pagerank,reach",
            "--requests", "12", "--batch", "4", "--validate",
            "--device", "cpu", "--json", str(out_json),
            "--metrics", str(out_prom), "--trace", str(out_trace)]
    stats = GS.main(argv)
    rows = json.loads(out_json.read_text())
    assert len(rows) == 1 and rows[0]["status_counts"]["ok"] == 12
    assert rows[0]["resident_bytes"] == rows[0]["storage"]["total_bytes"]
    assert rows[0]["resident_bytes"] > 0 and stats["device"] == "cpu"
    assert rows[0]["validation_failures"] == 0
    text = out_prom.read_text()
    assert re.search(r'^graph_serve_queries_ok_total\{kind="bfs"\} 3$',
                     text, re.M)
    names = {e["name"] for e in
             json.loads(out_trace.read_text())["traceEvents"]}
    assert {"build_graph", "warmup", "serve"} <= names
    out = capsys.readouterr().out
    assert "[graph_serve] 12 queries in" in out
    GS.main(argv[:-6] + ["--primitive", "sssp", "--kinds", "",
                         "--json", str(out_json)])
    assert len(json.loads(out_json.read_text())) == 2


def test_cli_faults_flag_and_limits(capsys):
    stats = GS.main(["--scale", "6", "--kinds", "pagerank,reach",
                     "--requests", "8", "--batch", "2", "--device", "cpu",
                     "--faults", "provider_miss@0.5;nan@0.5",
                     "--faults-seed", "3", "--metrics", "-"])
    assert sum(stats["status_counts"].values()) == 8
    out = capsys.readouterr().out
    assert "fault injection ACTIVE" in out
    assert "graph_serve_queries_error_total" in out
    with pytest.raises(SystemExit, match="RxC"):
        GS.main(["--mesh", "2x", "--device", "cpu"])
    with pytest.raises(SystemExit, match="mutually exclusive"):
        GS.main(["--mesh", "2x2", "--parts", "4", "--device", "cpu"])
    with pytest.raises(SystemExit, match="unknown query kind"):
        GS.main(["--kinds", "bfs,nope", "--device", "cpu"])


# ---- serving from a mesh (--parts / --mesh) --------------------------------

@pytest.mark.parametrize("flag,value", [("--parts", "4"), ("--mesh", "2x2")])
def test_cli_serves_validated_from_a_mesh(tmp_path, capsys, flag, value):
    """A validated mixed stream from the 1-D and 2-D placements on the
    CPU; the partition's balance and the comm model's bytes a step equal
    the reference's for the same graph, and land in --json and
    --metrics; the trace carries the partition and shard spans."""
    from repro.core import distributed as JD
    from repro.core.partition import partition_1d as jp1
    from repro.core.partition import partition_2d as jp2
    from repro.launch.graph_run import make_graph as j_make_graph
    out_json, out_trace = tmp_path / "rows.json", tmp_path / "trace.json"
    kinds = "bfs,sssp,pagerank,reach"
    GS.main(["--scale", "7", "--kinds", kinds, "--requests", "8",
             "--batch", "4", "--validate", "--device", "cpu", flag, value,
             "--json", str(out_json), "--metrics", "-",
             "--trace", str(out_trace)])
    row = json.loads(out_json.read_text())[-1]
    assert row["parts"] == 4 and row["validation_failures"] == 0
    assert row["status_counts"]["ok"] == 8
    jg = j_make_graph("rmat", 7, 16, 0)
    if flag == "--mesh":
        jpg = jp2(jg, 2, 2)
        assert row["placement"] == "2d" and row["mesh"] == [2, 2]
    else:
        jpg = jp1(jg, 4)
        assert row["placement"] == "sharded" and "mesh" not in row
    assert row["balance"] == json.loads(json.dumps(jpg.balance()))
    want = {k: JD.exchange_bytes_per_step(jpg, k)
            for k in ("bfs", "sssp", "pagerank")}
    assert row["exchange_bytes_per_step"] == want
    out = capsys.readouterr().out
    for k, b in want.items():
        assert f'graph_serve_exchange_bytes_per_step{{kind="{k}"}} {b}' \
            in out
    names = {e["name"] for e in
             json.loads(out_trace.read_text())["traceEvents"]}
    assert {"build_graph", "partition", "shard", "warmup", "serve"} <= names


def test_shard_loss_stream_degrades_through_declared_rungs():
    """A chaos stream on the 2-D mesh under shard_loss@0.2: every query
    gets one status, every degraded answer comes from a rung of the
    ladder the stream can realize (declared under its placement), and
    no exception leaves the stream."""
    declared = dict(TB._DECLARED_FALLBACKS)
    for kind in GS.KINDS:
        TB._DECLARED_FALLBACKS.pop((kind, "single"), None)
    stats = GS.main(["--scale", "7", "--kinds", "bfs,sssp,pagerank,reach",
                     "--requests", "32", "--batch", "4", "--mesh", "2x2",
                     "--validate", "--device", "cpu", "--faults",
                     "shard_loss@0.2", "--faults-seed", "0"])
    counts = stats["status_counts"]
    assert sum(counts.values()) == 32 == len(stats["queries"])
    assert counts["degraded"] > 0 and counts["error"] == 0
    for q in stats["queries"]:
        if q["status"] == "degraded":
            rungs = TF.ladder(q["kind"], "torch", "2d",
                              hops=3 if q["kind"] == "reach" else None)
            assert q["degraded_to"] in {r.reason for r in rungs
                                        if r.placement == "single"}
            assert TB.declared_fallback(q["kind"], "single")
    assert {f["placement"] for f in stats["flushes"]} == {"2d", "single"}
    assert stats["validation_failures"] == 0
    TB._DECLARED_FALLBACKS.clear()
    TB._DECLARED_FALLBACKS.update(declared)


def test_shard_loss_on_a_cuda_mesh_skips_the_backend_rung(graphs):
    """On a mesh the cuda backend already runs the placement's torch
    provider, so a lost shard degrades straight to single-device serving:
    no answer is stamped with the cuda→torch rung, which would rerun
    rung 0's code."""
    _, tg = graphs
    declared = dict(TB._DECLARED_FALLBACKS)

    def mesh_runner(kind, srcs, backend, hops):
        raise AssertionError("shard_loss@1 lets no mesh flush run")

    with TI.faults("shard_loss@1.0", seed=0):
        stats = GS.serve_mixed(
            tg, [("bfs", 3), ("sssp", 9), ("pagerank", 0), ("bfs", 40)],
            batch=2, backend="cuda", runner=mesh_runner, placement="2d",
            retry=TF.RetryPolicy(retries=3, base_ms=0.0, jitter=0.0))
    assert stats["status_counts"]["degraded"] == 4
    assert {q["degraded_to"] for q in stats["queries"]} == \
        {"placement sharded→single"}
    assert {q["attempts"] for q in stats["queries"]} == {2}
    assert {f["placement"] for f in stats["flushes"]} == {"single"}
    TB._DECLARED_FALLBACKS.clear()
    TB._DECLARED_FALLBACKS.update(declared)


def test_mesh_runner_answers_equal_single_device(graphs):
    """make_sharded_runner's answers equal the single-device runner's,
    lane for lane, on both placements."""
    from repro_torch.core.partition import Mesh, partition_1d, partition_2d
    _, tg = graphs
    srcs = np.array([3, 9, 9, 40])
    for pg, mesh, axis in (
            (partition_1d(tg, 4), Mesh.on("cpu", (4,), ("graph",)),
             "graph"),
            (partition_2d(tg, 2, 2), Mesh.on("cpu", (2, 2),
                                             ("row", "col")),
             ("row", "col"))):
        run = GS.make_sharded_runner(pg, mesh, axis)
        for kind in ("bfs", "sssp", "pagerank", "reach"):
            field, ovf, conv = run(kind, srcs, "torch", 3)
            want = GS._run_kind(tg, kind, srcs, "torch", 3)[0]
            assert torch.equal(field, want), kind
            assert conv is None and not ovf.any()
