"""The port's fault-tolerance layer against the reference's (``repro.ft``):
fault schedules and backoff schedules equal for the same spec and seed;
budgets, admission and the ladder; partial answers and ``converged``
under an iteration budget equal to the reference's; the registry's
fault hook, ``use_backend`` and declared fallbacks; health probes."""
import functools
import threading
import time

import numpy as np
import pytest
import torch

from repro import ft as JF
from repro.core import graph as JG
from repro.core import primitives as JP
from repro.ft import inject as JI
from repro.ft import retry as JR
from repro_torch import convert
from repro_torch import ft as TF
from repro_torch.core import backend as TB
from repro_torch.core import primitives as TP
from repro_torch.core.graph import TENSOR_FIELDS
from repro_torch.ft import health as TH
from repro_torch.ft import inject as TI
from repro_torch.ft import retry as TR

SPECS = ("provider_miss@0.5;nan:bfs@0.25",
         "provider_miss@0.3;nan@0.2;straggler@0.1",
         "straggler:sssp@0.9;shard_loss@0.2")
SITES = [(k, s) for k in ("provider_miss", "nan", "straggler", "shard_loss")
         for s in ("bfs", "sssp", "pagerank", "reach", "compact", "")]


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    JI._reset_for_tests()
    yield
    JI._reset_for_tests()
    assert TI.active() is None


# ---- fault injection ------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 123])
@pytest.mark.parametrize("spec", SPECS)
def test_fault_schedule_equals_reference(spec, seed):
    jp, tp = JI.FaultPlan(spec, seed), TI.FaultPlan(spec, seed)
    assert tp.clauses == jp.clauses
    order = np.random.default_rng(seed).integers(0, len(SITES), 400)
    got = [tp.should(*SITES[i]) for i in order]
    want = [jp.should(*SITES[i]) for i in order]
    assert got == want and any(got) and not all(got)
    assert tp.fired == jp.fired
    for n in range(50):
        assert TI._draw(seed, "nan", "bfs", n) == JI._draw(seed, "nan",
                                                           "bfs", n)


@pytest.mark.parametrize("bad", ["provider_miss", "frobnicate@0.5",
                                 "nan@lots", "nan@1.5", "nan@-0.1"])
def test_fault_spec_errors_as_reference(bad):
    with pytest.raises(JI.FaultSpecError):
        JI.FaultPlan(bad)
    with pytest.raises(TI.FaultSpecError):
        TI.FaultPlan(bad)


def test_faults_context_installs_and_restores():
    assert TI.active() is None
    with TI.faults("nan@1.0", seed=3) as plan:
        assert TI.active() is plan and plan.seed == 3
        with TI.faults("straggler@1.0") as inner:
            assert TI.active() is inner
        assert TI.active() is plan
    assert TI.active() is None


def test_registry_fault_hook():
    """An installed plan's provider_miss makes dispatch miss for its
    site (the op); lookups that only read the registry never draw."""
    assert TB.dispatch("compact", "torch")
    with TI.faults("provider_miss:compact@1.0") as plan:
        with pytest.raises(TB.ProviderMissError, match="injected") as info:
            TB.dispatch("compact", "torch")
        assert info.value.op == "compact"
        assert TB.dispatch("advance", "torch")          # another site
        assert TB.registered("compact", "torch")
        assert TB.declared_encodings("compact", "torch") == ("dense",)
        assert plan.fired == {"provider_miss": 1}
    assert TB.dispatch("compact", "torch")


# ---- backend context and declared fallbacks -------------------------------

def test_use_backend_context():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert TB.resolve(None, cuda) == "cuda"
    with TB.use_backend("torch"):
        assert TB.resolve(None, cuda) == "torch"
        assert TB.resolve("cuda", cuda) == "cuda"        # explicit wins
        with TB.use_backend("cuda"):
            with pytest.raises(ValueError, match="CUDA tensors"):
                TB.resolve(None, cpu)
        assert TB.resolve(None, cpu) == "torch"
    assert TB.resolve(None, cuda) == "cuda"
    with pytest.raises(ValueError, match="unknown backend"):
        with TB.use_backend("xla"):
            pass


def test_use_backend_is_per_thread():
    seen = []
    with TB.use_backend("torch"):
        t = threading.Thread(
            target=lambda: seen.append(TB.resolve(None,
                                                  torch.device("cuda"))))
        t.start()
        t.join()
    assert seen == ["cuda"]


def test_declared_fallbacks():
    assert TB.declared_fallback("sssp_test_op", "torch") is None
    with pytest.raises(ValueError):
        TB.declare_fallback("sssp_test_op", "torch", reason="")
    TB.declare_fallback("sssp_test_op", "torch", reason="why")
    assert TB.declared_fallback("sssp_test_op", "torch") == "why"
    assert TB.declared_fallbacks()[("sssp_test_op", "torch")] == "why"
    TB._DECLARED_FALLBACKS.pop(("sssp_test_op", "torch"))


# ---- budgets, retry, admission, ladder ------------------------------------

def test_budget_validation_as_reference():
    for kw in ({"max_iters": 0}, {"wall_ms": 0}, {"wall_ms": -1.0}):
        with pytest.raises(ValueError):
            TF.Budget(**kw)
        with pytest.raises(ValueError):
            JF.Budget(**kw)
    for b in (TF.Budget(max_iters=3, wall_ms=250.0), TF.UNLIMITED):
        j = JF.Budget(max_iters=b.max_iters, wall_ms=b.wall_ms)
        for it in (1, 2, 3, 17):
            assert b.cap_iters(it) == j.cap_iters(it)
        assert b.deadline_from(1.0) == j.deadline_from(1.0)


@pytest.mark.parametrize("jitter", [0.0, 0.25, 0.5])
def test_backoff_schedule_equals_reference(jitter):
    tp = TF.RetryPolicy(retries=4, base_ms=10.0, factor=2.0, jitter=jitter)
    jp = JF.RetryPolicy(retries=4, base_ms=10.0, factor=2.0, jitter=jitter)
    for seed in (0, 1, 11, 99):
        assert [TR.backoff_ms(tp, a, seed) for a in range(5)] == \
            [JR.backoff_ms(jp, a, seed) for a in range(5)]
    sleeps = {}
    for name, mod, pol in (("t", TF, tp), ("j", JF, jp)):
        sleeps[name] = []

        def flaky(attempt):
            if attempt < 3:
                raise RuntimeError("boom")
            return "ok"

        assert mod.with_retry(flaky, pol, seed=5,
                              sleep=sleeps[name].append) == ("ok", 4)
    assert sleeps["t"] == sleeps["j"]


def test_with_retry_exhaustion_and_nonretryable():
    p = TF.RetryPolicy(retries=1, base_ms=0.0, jitter=0.0)
    with pytest.raises(RuntimeError):
        TF.with_retry(lambda a: (_ for _ in ()).throw(RuntimeError("x")),
                      p, sleep=lambda s: None)
    calls = []

    def bad(attempt):
        calls.append(attempt)
        raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        TF.with_retry(bad, p, retryable=(RuntimeError,),
                      sleep=lambda s: None)
    assert calls == [0]


def test_with_retry_retry_if_rejects_at_once():
    """A retryable exception that ``retry_if`` rejects propagates on the
    first attempt; one it accepts is retried."""
    p = TF.RetryPolicy(retries=2, base_ms=0.0, jitter=0.0)
    calls = []

    def flaky(attempt):
        calls.append(attempt)
        err = RuntimeError("x")
        err.injected = attempt == 0
        raise err

    with pytest.raises(RuntimeError):
        TF.with_retry(flaky, p, retryable=(RuntimeError,),
                      retry_if=lambda e: e.injected, sleep=lambda s: None)
    assert calls == [0, 1]


def test_admission_policy_as_reference():
    with pytest.raises(ValueError):
        TF.AdmissionPolicy(max_per_kind=0)
    for kw in ({"max_per_kind": 2, "max_pending": 3}, {}):
        tp, jp = TF.AdmissionPolicy(**kw), JF.AdmissionPolicy(**kw)
        for kind, pend in (("bfs", {"bfs": [1, 2]}), ("bfs", {"bfs": [1]}),
                           ("sssp", {"bfs": [1, 2], "sssp": [3]}),
                           ("bfs", {"bfs": list(range(999))})):
            assert tp.admit(kind, pend) == jp.admit(kind, pend)


@pytest.mark.parametrize("kind,hops", [("bfs", None), ("sssp", None),
                                       ("pagerank", None), ("reach", 4),
                                       ("reach", 1), ("bc", None)])
def test_ladder_mirrors_reference(kind, hops):
    """cuda→torch stands where pallas→xla stands; the rest is equal."""
    for tb, jb in (("cuda", "pallas"), ("torch", "xla")):
        got = TF.ladder(kind, tb, hops=hops)
        want = JF.ladder(kind, jb, "single", hops=hops)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.reason == w.reason.replace("pallas→xla", "cuda→torch")
            assert g.backend == {"pallas": "cuda", "xla": "torch"}[w.backend]
            assert (g.hops, g.sampled, g.approximate) == \
                (w.hops, w.sampled, w.approximate)
    assert TF.rung_for_attempt(got, 99) is got[-1]


def test_engage_declares_and_logs(capsys):
    rung = TF.ladder("bfs", "cuda")[1]
    TF.engage("bfs", rung, RuntimeError("launch failed"))
    assert TB.declared_fallback("bfs", "torch") == \
        "serve-time degradation: backend cuda→torch"
    assert "degrade kind=bfs backend cuda→torch after RuntimeError" in \
        capsys.readouterr().out
    TB._DECLARED_FALLBACKS.pop(("bfs", "torch"))
    TF.engage("bfs", TF.ladder("bfs", "cuda")[0])      # rung 0: nothing
    assert TB.declared_fallback("bfs", "cuda") is None


# ---- partial answers under an iteration budget ----------------------------

def _pair(jg):
    return jg, convert.graph_from_arrays(
        {f: np.asarray(getattr(jg, f)) for f in TENSOR_FIELDS},
        ell_width=jg.ell_width, csc_ell_width=jg.csc_ell_width,
        device="cpu")


@functools.lru_cache(maxsize=None)
def _graphs(name):
    if name == "rmat":
        return _pair(JG.rmat(9, 8, seed=7, weighted=True))
    return _pair(JG.grid2d(20, weighted=True, seed=3))


SRCS = [0, 17, 101, 250]


def _budgeted(pkg, kind, g, budget):
    kw = {"backend": "xla"} if pkg is JP else {}
    if kind == "bfs":
        return pkg.bfs_batch(g, SRCS, budget=budget, **kw)
    if kind == "sssp":
        return pkg.sssp_batch(g, SRCS, delta=40.0, budget=budget, **kw)
    if kind == "pagerank":
        return pkg.pagerank(g, max_iter=20, budget=budget, **kw)
    return pkg.reach_batch(g, SRCS, k=4, budget=budget, **kw)


@pytest.mark.parametrize("max_iters", [1, 2, 3, None])
@pytest.mark.parametrize("kind", ["bfs", "sssp", "pagerank", "reach"])
@pytest.mark.parametrize("graph", ["rmat", "grid"])
def test_budget_partial_answers_equal_reference(graph, kind, max_iters):
    jg, tg = _graphs(graph)
    budget = None if max_iters is None else TF.Budget(max_iters=max_iters)
    jbudget = None if max_iters is None else JF.Budget(max_iters=max_iters)
    jr = _budgeted(JP, kind, jg, jbudget)
    tr = _budgeted(TP, kind, tg, budget)
    for f in jr._fields:
        want = np.asarray(getattr(jr, f))
        got = getattr(tr, f)
        got = got.numpy() if isinstance(got, torch.Tensor) else \
            np.asarray(got)
        if kind == "pagerank" and f == "rank":
            # ROADMAP C-ref-3: the reference's fused multiply-add
            assert np.allclose(got, want, rtol=0, atol=1e-6), f
        else:
            assert np.array_equal(got, want), f
    if max_iters == 1 and kind != "reach":
        assert not np.asarray(jr.converged).all()


@pytest.mark.parametrize("kind", ["bfs", "sssp", "pagerank", "reach"])
def test_fault_hook_draws_once_per_op_in_a_primitive_call(kind):
    """A primitive call is the port's trace: the registry's hook draws
    once for each op the call dispatches, however many steps it runs."""
    _, g = _graphs("rmat")
    with TI.faults("provider_miss@0.0", seed=0) as plan:
        for calls in (1, 2):
            _budgeted(TP, kind, g, None)
            assert plan._counters and set(plan._counters.values()) == \
                {calls}, plan._counters
    with TI.faults("provider_miss:compact@0.0", seed=0) as plan:
        with TB.draw_scope():
            for _ in range(3):
                TB.dispatch("compact", "torch")
        TB.dispatch("compact", "torch")
        assert plan._counters == {("provider_miss", "compact"): 2}


def test_unbudgeted_and_zero_probability_plan_change_nothing():
    _, g = _graphs("rmat")
    base = [TP.bfs_batch(g, SRCS).labels,
            TP.sssp_batch(g, SRCS, delta=40.0).dist,
            TP.pagerank(g).rank, TP.reach_batch(g, SRCS, k=3).reached]
    unlimited = TP.bfs_batch(g, SRCS, budget=TF.UNLIMITED)
    assert torch.equal(unlimited.labels, base[0])
    assert bool(unlimited.converged.all())
    spec = "provider_miss@0.0;nan@0.0;straggler@0.0;shard_loss@0.0"
    with TI.faults(spec, seed=1):
        inside = [TP.bfs_batch(g, SRCS).labels,
                  TP.sssp_batch(g, SRCS, delta=40.0).dist,
                  TP.pagerank(g).rank, TP.reach_batch(g, SRCS, k=3).reached]
    for a, b in zip(base, inside):
        assert torch.equal(a, b)


# ---- health ---------------------------------------------------------------

def test_check_devices_probes_with_a_timeout(monkeypatch):
    probe = TH._probe
    healthy = TF.check_devices()
    assert healthy and all(healthy.values())
    monkeypatch.setattr(TH, "_probe", lambda dev, out: time.sleep(2.0))
    t0 = time.monotonic()
    hung = TF.check_devices(timeout_s=0.1)
    assert set(hung) == set(healthy) and not any(hung.values())
    assert time.monotonic() - t0 < 1.5
    out = {}
    probe(torch.device("meta"), out)        # a device that fails
    assert "error" in out and not out.get("ok")


def test_step_watchdog_flags_stragglers(monkeypatch):
    clock = {"t": 0.0}
    monkeypatch.setattr(TH.time, "monotonic", lambda: clock["t"])
    seen = []
    wd = TF.StepWatchdog(threshold=2.0,
                         on_straggler=lambda s, dt, med: seen.append(s))
    for step, dt in enumerate([1.0, 1.0, 1.0, 1.0, 5.0, 1.0]):
        wd.start(step)
        clock["t"] += dt
        wd.stop()
    assert seen == [4] and wd.stragglers[0][:2] == (4, 5.0)
    assert wd.median() == 1.0


# ---- the placement rungs and shard loss -----------------------------------

@pytest.mark.parametrize("placement", ["single", "sharded", "2d"])
@pytest.mark.parametrize("kind,hops", [("bfs", None), ("reach", 4),
                                       ("bc", None)])
def test_placement_ladder_mirrors_reference(kind, hops, placement):
    """2d → sharded → single stand after the backend rung, as in the
    reference."""
    for tb, jb in (("cuda", "pallas"), ("torch", "xla")):
        got = TF.ladder(kind, tb, placement, hops=hops)
        want = JF.ladder(kind, jb, placement, hops=hops)
        assert [g.reason for g in got] == [
            w.reason.replace("pallas→xla", "cuda→torch") for w in want]
        assert [g.placement for g in got] == [w.placement for w in want]
        assert [(g.hops, g.sampled, g.approximate) for g in got] == [
            (w.hops, w.sampled, w.approximate) for w in want]


def test_engage_declares_a_placement_rung_under_its_placement():
    rungs = TF.ladder("sssp", "torch", "2d")
    assert [r.reason for r in rungs] == ["", "placement 2d→sharded",
                                         "placement sharded→single"]
    TF.engage("sssp", rungs[2])
    assert TB.declared_fallback("sssp", "single") == \
        "serve-time degradation: placement sharded→single"
    TB._DECLARED_FALLBACKS.pop(("sssp", "single"))
    with pytest.raises(ValueError, match="unknown placement"):
        TB.declare_fallback("sssp", "mesh", reason="why")


def test_shard_loss_error_carries_injected():
    assert TF.ShardLossError("lost").injected is False
    err = TF.ShardLossError("lost", injected=True)
    assert err.injected and isinstance(err, RuntimeError)
    with TF.faults("shard_loss:bfs@1.0", seed=0) as plan:
        assert plan.should("shard_loss", "bfs")
        assert not plan.should("shard_loss", "sssp")
