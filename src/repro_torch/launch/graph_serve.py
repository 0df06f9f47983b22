"""Graph query serving — batched mixed-kind serving on one card or from
a mesh (counterpart of ``repro.launch.graph_serve``).

A stream of queries is packed into fixed batch slots: each query kind
keeps its own slot queue and a queue flushes as ONE batched multi-source
run the moment it fills (ragged tails flush at the end of the stream,
padded with the last real source). Kinds: ``bfs`` (``bfs_batch``: K1 on
push steps, K2 on pull steps' compaction), ``sssp`` (``sssp_batch``: K3
relax, K2 near pile), ``pagerank`` (one run answers its whole batch: K4)
and ``reach`` (``reach_batch``, or-and k-hop reachability: K4m).

Per-query latency runs from the query's own enqueue to its batch's
completion — the host copy of the answer field (``.cpu()``), which is
the fence. Reported: qps, per-kind and aggregate p50/p95/p99 (linear
interpolation, beside the sample count), per-query statuses and, per
flush, where the host time went (``flushes``).

The request lifecycle follows the reference: every query ends in exactly
one of ``ok | degraded | deadline_exceeded | shed | error``; counters
reconcile with the statuses; admission sheds; iteration and wall-clock
budgets; retry with backoff down the degradation ladder (``cuda→torch``:
the plain providers on the same card tensors; ``reach`` k → k//2); a
NaN/Inf guardrail; a straggler watchdog. One rule is the port's own:
**with no fault plan installed nothing is retried and nothing falls
back** — a build or launch error, or a poisoned answer, raises out of
the stream (and ``main`` exits nonzero). Retries and the ladder run
only under an installed plan (``--faults SPEC --faults-seed N``, or
``ft.faults``), and only for the faults it injects (a provider miss, a
poisoned answer); any other error raises there too.

  PYTHONPATH=src python -m repro_torch.launch.graph_serve --graph rmat \\
      --scale 10 --kinds bfs,sssp,pagerank,reach --requests 64 \\
      --batch 4 --validate --device cpu --json out.json --metrics -

``--parts P`` (the 1-D sharded placement) and ``--mesh RxC`` (the 2-D
vertex cut) build the partition once and serve every kind from it
(``make_sharded_runner``); part i lies on ``cuda:(i mod
device_count)``, so on one card every part is on it (``--device cpu``:
every part on the CPU). Answers equal single-device serving bit for
bit, so ``--validate`` uses the same oracles. ``--json`` / ``--metrics``
carry ``parts``, ``balance`` and the analytic
``exchange_bytes_per_step``. Under a fault plan a ``shard_loss`` clause
fails a mesh flush as a lost part would, and the retry goes down to the
``single`` rung (the ``cuda→torch`` rung is skipped on a mesh, where the
cuda backend already runs the placement's torch provider).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time

import numpy as np
import torch

from .. import ft, obs
from ..core import backend as B
from ..core import ref as R
from ..core.primitives import bfs_batch, pagerank, reach_batch, sssp_batch
from ..core.storage import resident_bytes
from ..ft import inject
from ..kernels.runtime import resolve_device
from ..obs.metrics import Metrics, latency_summary
from .graph_run import make_graph

KINDS = ("bfs", "sssp", "pagerank", "reach")

# terminal statuses and the counter each lands in: counter sums equal
# the status counts of the results (the chaos suite's invariant)
STATUSES = ("ok", "degraded", "deadline_exceeded", "shed", "error")
_STATUS_COUNTER = {
    "ok": "queries_ok_total",
    "degraded": "queries_degraded_total",
    "deadline_exceeded": "queries_deadline_total",
    "shed": "queries_shed_total",
    "error": "queries_error_total",
}

# an injected straggler's stall: long enough for the watchdog's
# robust-median multiple to flag it at any realistic batch cadence
_STRAGGLER_SLEEP_S = 0.2

log = obs.get_logger("graph_serve")


class PoisonedResultError(RuntimeError):
    """A served answer failed the NaN/Inf guardrail."""

    def __init__(self, msg: str, *, injected: bool = False):
        super().__init__(msg)
        self.injected = injected        # the poison was a fault plan's


# the faults a plan injects: the only errors a flush retries; any other
# error, or one of these that no plan caused, raises out of the stream
_INJECTABLE = (B.ProviderMissError, PoisonedResultError,
               inject.ShardLossError)


def _injected(exc: BaseException) -> bool:
    return getattr(exc, "injected", False)


def _host(x) -> np.ndarray:
    """The host copy of an answer (the fence for a card tensor)."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def serve(g, primitive: str, sources: np.ndarray, batch: int,
          backend: str, validate: bool = False,
          metrics: Metrics | None = None) -> dict:
    """Serve ``sources`` of one traversal kind in fixed batches; returns
    latency / qps stats (quantiles beside their sample count)."""
    run = {"bfs": bfs_batch, "sssp": sssp_batch}[primitive]
    n_q = len(sources)
    if n_q == 0:
        raise ValueError("empty query stream (requests must be > 0)")
    lat_ms = np.zeros(n_q)
    failures = 0
    overflow = 0
    answers = []                 # validated after the clock stops
    t_start = time.monotonic()
    enqueue = np.full(n_q, t_start)        # closed loop: all queued
    done = 0
    batches = 0
    while done < n_q:
        sl = sources[done:done + batch]
        srcs = np.concatenate(
            [sl, np.full(batch - len(sl), sl[-1], sl.dtype)])
        r = run(g, srcs, backend=backend)
        field = _host(r.dist if primitive == "sssp" else r.labels)
        t_done = time.monotonic()
        if primitive == "bfs":
            overflow += int(_host(r.overflow)[:len(sl)].sum())
        if validate:
            answers.append((sl, field))
        batch_lat = (t_done - enqueue[done:done + len(sl)]) * 1e3
        lat_ms[done:done + len(sl)] = batch_lat
        if metrics is not None:
            _observe_batch(metrics, primitive, batch_lat, len(sl), batch,
                           queue_depth=n_q - done)
        done += len(sl)
        batches += 1
    total_s = time.monotonic() - t_start
    if validate:
        for sl, field in answers:
            failures += _validate_kind(g, primitive, sl, field, 0)
    if metrics is not None:
        _count_totals(metrics, batches, overflow)
    return {
        "primitive": primitive, "backend": backend, "batch": batch,
        "requests": n_q, "batches": batches, "total_s": round(total_s, 4),
        "qps": round(n_q / total_s, 2),
        **latency_summary(lat_ms),
        "overflow": overflow,
        "validation_failures": failures if validate else None,
    }


def _observe_batch(m: Metrics, kind: str, batch_lat, real: int,
                   batch: int, queue_depth: int) -> None:
    """One flushed batch's metrics: per-kind latency observations,
    batch-slot occupancy, the queue-depth high-water mark."""
    for v in np.asarray(batch_lat, np.float64).reshape(-1):
        m.observe("latency_ms", float(v),
                  help="per-query latency, enqueue to batch completion",
                  kind=kind)
    m.counter("queries_total", real, help="queries answered", kind=kind)
    m.observe("batch_occupancy", real / max(batch, 1),
              help="fraction of batch slots holding real queries",
              kind=kind)
    m.gauge_max("queue_depth_peak", queue_depth,
                help="high-water mark of queued-but-unflushed queries")


def _count_totals(m: Metrics, batches: int, overflow: int) -> None:
    """Stream-level counters (the answer cache's are declared at zero,
    as in the reference)."""
    m.counter("batches_total", batches, help="batches flushed")
    m.counter("overflow_total", overflow,
              help="BFS discoveries dropped by capped frontiers")
    m.counter("cache_hits_total", 0, help="answer-cache hits")
    m.counter("cache_misses_total", 0, help="answer-cache misses")


def _run_kind(g, kind: str, srcs: np.ndarray, backend: str, hops: int,
              budget=None):
    """One flushed batch of ``kind``: (answer field, per-lane BFS
    overflow, ``converged`` flags), as the primitive left them — card
    tensors are not waited for here (the caller's host copy is the
    fence)."""
    zeros = np.zeros(len(srcs), np.int64)
    if kind == "bfs":
        r = bfs_batch(g, srcs, backend=backend, budget=budget)
        return r.labels, r.overflow, r.converged
    if kind == "sssp":
        r = sssp_batch(g, srcs, backend=backend, budget=budget)
        return r.dist, zeros, r.converged
    if kind == "reach":
        r = reach_batch(g, srcs, hops, backend=backend, budget=budget)
        return r.reached, zeros, r.converged
    if kind == "pagerank":
        # a global query: one run answers every slot of the batch
        r = pagerank(g, backend=backend, budget=budget)
        return r.rank, zeros, r.converged
    raise ValueError(kind)


def make_sharded_runner(pg, mesh, axis="graph"):
    """A runner serving every kind from the 1-D (or 2-D vertex-cut)
    partition ``pg`` on ``mesh``, built once: bfs / sssp run one
    distributed traversal per distinct source of a batch (the padding
    lanes repeat the last real source), reach / pagerank run the
    primitives on the sharded view through the placement's providers.
    Answers equal the single-device runner's bit for bit; the dense
    bitmask exchange has no capped frontier, so no overflow."""
    from ..core.distributed import (_shard_any, distributed_bfs,
                                    distributed_sssp)
    sg = _shard_any(pg, mesh, axis)

    def _per_source(srcs, one):
        memo = {}
        rows = []
        for s in srcs:
            s = int(s)
            if s not in memo:
                memo[s] = one(s)
            rows.append(memo[s])
        return torch.stack(rows)

    def run(kind: str, srcs: np.ndarray, backend: str, hops: int):
        zeros = np.zeros(len(srcs), np.int64)
        if kind == "bfs":
            return _per_source(srcs, lambda s: distributed_bfs(
                pg, s, mesh, axis, backend=backend).labels), zeros, None
        if kind == "sssp":
            return _per_source(srcs, lambda s: distributed_sssp(
                pg, s, mesh, axis).dist), zeros, None
        if kind == "reach":
            return reach_batch(sg, srcs, hops, backend=backend).reached, \
                zeros, None
        if kind == "pagerank":
            return pagerank(sg, backend=backend).rank, zeros, None
        raise ValueError(kind)

    return run


def _validate_kind(g, kind: str, srcs, field, hops: int) -> int:
    """Lanes of a host answer that differ from the oracles."""
    if kind == "pagerank":
        return int(R.pagerank_rel_err(field, R.pagerank_ref(g, iters=20))
                   > R.PR_RTOL)
    fails = 0
    for i, s in enumerate(srcs):
        a = np.asarray(field[i])
        if kind == "bfs":
            ok = np.array_equal(a, R.bfs_ref(g, int(s)))
        elif kind == "sssp":
            ok = np.allclose(a, R.sssp_ref(g, int(s)), rtol=1e-5)
        else:
            ok = np.array_equal(a, R.reach_ref(g, int(s), hops))
        fails += not ok
    return fails


def _guardrail(kind: str, field: np.ndarray, injected: bool = False
               ) -> None:
    """Reject a poisoned float answer before it ships (a read of the
    host copy: healthy answers are untouched). sssp distances may be
    +inf (unreachable), so NaN is its poison; pagerank ranks must be
    finite; bfs / reach answers are integral or boolean."""
    if field.dtype.kind != "f":
        return
    bad = np.isnan(field) if kind == "sssp" else ~np.isfinite(field)
    if bad.any():
        raise PoisonedResultError(
            f"{kind} output failed the NaN/Inf guardrail "
            f"({float(bad.mean()):.1%} of entries non-finite)",
            injected=injected)


def serve_mixed(g, queries, batch: int, backend: str, hops: int = 3,
                validate: bool = False, runner=None,
                metrics: Metrics | None = None,
                budget: ft.Budget | None = None,
                admission: ft.AdmissionPolicy | None = None,
                retry: ft.RetryPolicy | None = None,
                placement: str = B.SINGLE, watchdog=None) -> dict:
    """Serve a mixed-kind stream of ``(kind, source)`` queries through
    per-kind fixed batch slots; returns aggregate stats, a ``per_kind``
    breakdown, per-query records under ``queries`` and per-flush records
    under ``flushes``.

    ``runner(kind, srcs, backend, hops)`` overrides execution (tests pass
    stubs, the mesh CLI ``make_sharded_runner``'s runner under
    ``placement``) and returns ``(field, overflow, converged)``,
    converged None for a run that completed; the default runs the
    primitives on ``g``. Lifecycle, as in
    the reference: malformed input → per-query ``error``; ``admission``
    sheds over its caps; ``budget.max_iters`` rides into the primitives
    (lanes cut short → ``deadline_exceeded`` with partial answers),
    ``budget.wall_ms`` is checked at flush boundaries (expired in queue
    → not dispatched; late → ``deadline_exceeded``); a NaN/Inf guardrail
    reads each answer; a watchdog times each flush. Under an installed
    fault plan a flush that the plan's faults hit runs under ``retry``
    down the ``ft.degrade`` ladder (a lower rung's answers →
    ``degraded``, with the rung's reason; the ladder dry → ``error``);
    any other error raises, plan or not. With no plan a flush runs once,
    on the requested backend.
    """
    n_q = len(queries)
    if n_q == 0:
        raise ValueError("empty query stream (requests must be > 0)")
    retry = retry if retry is not None else ft.RetryPolicy()
    wd = watchdog if watchdog is not None else ft.StepWatchdog()
    plan = inject.active()
    num_v = None if g is None else g.num_vertices
    results: list = [None] * n_q
    lat_ms = {k: [] for k in KINDS}
    pending: dict = {k: [] for k in KINDS}   # (qid, src, t_enq, deadline)
    status_counts = {s: 0 for s in STATUSES}
    failures = 0
    overflow = 0
    retried = 0
    answers = []
    flushes = []
    batches = 0
    if metrics is not None:
        # every lifecycle counter declared up front, so counters equal the
        # statuses even for fault classes that never fire
        for s in STATUSES:
            metrics.counter(_STATUS_COUNTER[s], 0,
                            help=f"queries finished with status={s}")
        metrics.counter("queries_retried_total", 0,
                        help="queries whose batch needed >=1 retry")
    t_start = time.monotonic()

    def finish(qid, kind, src, status, t_enq, t_done=None, reason=None,
               attempts=1, degraded_to=None):
        t_done = time.monotonic() if t_done is None else t_done
        rec = {"id": qid, "kind": kind, "source": src, "status": status,
               "lat_ms": round((t_done - t_enq) * 1e3, 3),
               "attempts": attempts}
        if reason:
            rec["reason"] = reason
        if degraded_to:
            rec["degraded_to"] = degraded_to
        results[qid] = rec
        status_counts[status] += 1
        if metrics is not None:
            metrics.counter(_STATUS_COUNTER[status], 1,
                            help=f"queries finished with status={status}",
                            kind=str(kind))
        return rec

    run_default = (lambda k, s, bk, h: _run_kind(g, k, s, bk, h, budget))
    run_kind = runner if runner is not None else run_default

    def realizable(r):
        """The rungs this stream can realize: single-device serving of
        ``g``, or the runner's own placement. A backend rung under a
        distributed placement is dropped: a cuda dispatch there already
        runs the placement's torch provider, so it would repeat rung 0."""
        if r.placement == B.SINGLE:
            return True
        return r.placement == placement and not r.reason.startswith(
            "backend")

    def dispatch(kind, srcs):
        """One batch: (field, ovf, conv, attempts, rung, timing, error).
        ``error`` is set, and ``field`` None, when the ladder ran dry."""
        rungs = [r for r in ft.ladder(kind, backend, placement,
                                      hops=hops if kind == "reach"
                                      else None) if realizable(r)]
        state = {"attempts": 1, "rung": rungs[0]}
        timing = {}

        def attempt(a):
            state["attempts"] = a + 1
            rung = ft.rung_for_attempt(rungs, a)
            state["rung"] = rung
            if rung.reason:
                ft.engage(kind, rung)
            if plan is not None and plan.should("provider_miss", kind):
                raise B.ProviderMissError(
                    kind, rung.backend, "injected by repro_torch.ft.inject",
                    injected=True, placement=rung.placement)
            if (placement != B.SINGLE and rung.placement == placement
                    and plan is not None
                    and plan.should("shard_loss", kind)):
                raise inject.ShardLossError(
                    f"injected shard loss during {kind} flush",
                    injected=True)
            h = rung.hops if rung.hops is not None else hops
            run = run_kind if rung.placement == placement else run_default
            t0 = time.monotonic()
            field, ovf, conv = run(kind, srcs, rung.backend, h)
            t1 = time.monotonic()
            timing["device"] = (str(field.device)
                                if isinstance(field, torch.Tensor)
                                else "host")
            field = _host(field)          # the fence
            t2 = time.monotonic()
            ovf = _host(ovf)
            conv = None if conv is None else _host(conv)
            poison = (plan is not None and field.dtype.kind == "f"
                      and plan.should("nan", kind))
            if poison:
                field = field.copy()
                field.reshape(-1)[0] = np.nan
            if plan is not None and plan.should("straggler", kind):
                time.sleep(_STRAGGLER_SLEEP_S)
            t3 = time.monotonic()
            _guardrail(kind, field, injected=poison)
            timing.update(run_ms=(t1 - t0) * 1e3, copy_ms=(t2 - t1) * 1e3,
                          guard_ms=(time.monotonic() - t3) * 1e3)
            return field, ovf, conv

        if plan is None:
            # no fault plan: one attempt on the requested rung, and any
            # failure is the caller's — nothing is retried or degraded
            field, ovf, conv = attempt(0)
            return field, ovf, conv, 1, rungs[0], timing, None

        def on_retry(a, exc):
            log.warning(f"{kind} batch attempt {a + 1} failed "
                        f"({type(exc).__name__}: {exc}); backing off")

        try:
            (field, ovf, conv), attempts = ft.with_retry(
                attempt, retry, seed=batches, sleep=time.sleep,
                retryable=_INJECTABLE, retry_if=_injected,
                on_retry=on_retry)
            return field, ovf, conv, attempts, state["rung"], timing, None
        except _INJECTABLE as exc:   # the retry boundary: the ladder ran dry
            if not _injected(exc):
                raise                # a real miss or poison: no fallback
            log.error(f"{kind} batch failed after {state['attempts']} "
                      f"attempts: {type(exc).__name__}: {exc}")
            return (None, None, None, state["attempts"], state["rung"],
                    timing, exc)

    def flush(kind):
        nonlocal batches, overflow, retried
        q = pending[kind]
        if not q:
            return
        pending[kind] = []
        now = time.monotonic()
        live = []
        for qid, src, t_enq, dl in q:
            if dl is not None and now >= dl:
                # expired while queued: no batch slot is spent on it
                finish(qid, kind, src, "deadline_exceeded", t_enq,
                       t_done=now, reason="deadline expired in queue")
            else:
                live.append((qid, src, t_enq, dl))
        if not live:
            return
        sl = np.asarray([src for _, src, _, _ in live], np.int64)
        srcs = np.concatenate([sl, np.full(batch - len(sl), sl[-1],
                                           sl.dtype)])
        wd.start(batches)
        t_flush = time.monotonic()
        field, ovf, conv, attempts, rung, timing, err = dispatch(kind,
                                                                 srcs)
        dt = wd.stop()
        t_done = time.monotonic()
        flushes.append({"kind": kind, "real": len(live),
                        "attempts": attempts, "rung": rung.reason,
                        "backend": rung.backend,
                        "placement": rung.placement,
                        "error": None if err is None
                        else type(err).__name__,
                        "flush_ms": (t_done - t_flush) * 1e3, **timing})
        batches += 1
        if metrics is not None and wd.median():
            metrics.gauge_max(
                "straggler_multiple_max", dt / wd.median(),
                help="worst batch wall time as a multiple of the "
                     "robust-median batch time")
        if field is None:
            # retries and the whole ladder failed: structured errors, the
            # stream lives on
            for qid, src, t_enq, _ in live:
                finish(qid, kind, src, "error", t_enq, t_done=t_done,
                       reason=f"{type(err).__name__}: {err}",
                       attempts=attempts)
            if metrics is not None:
                metrics.counter("queries_retried_total", len(live),
                                kind=kind)
            retried += len(live)
            return
        overflow += int(np.asarray(ovf)[:len(sl)].sum())
        # degraded = answered by a lower rung; a retry that recovered on
        # the requested rung is "ok" (attempts and retried record it)
        degraded = bool(rung.reason)
        conv_arr = None if conv is None else np.asarray(conv).reshape(-1)
        if validate and not degraded and (conv_arr is None
                                          or conv_arr.all()):
            answers.append((kind, sl, field))
        batch_lat = []
        for i, (qid, src, t_enq, dl) in enumerate(live):
            conv_i = (True if conv_arr is None else
                      bool(conv_arr[min(i, len(conv_arr) - 1)]))
            late = dl is not None and t_done > dl
            if not conv_i:
                st = "deadline_exceeded"
                reason = "iteration budget exhausted (partial result)"
            elif late:
                st = "deadline_exceeded"
                reason = "completed after deadline"
            elif degraded:
                st, reason = "degraded", None
            else:
                st, reason = "ok", None
            finish(qid, kind, src, st, t_enq, t_done=t_done,
                   reason=reason, attempts=attempts,
                   degraded_to=rung.reason if degraded else None)
            batch_lat.append((t_done - t_enq) * 1e3)
        if attempts > 1:
            retried += len(live)
            if metrics is not None:
                metrics.counter("queries_retried_total", len(live),
                                kind=kind)
        lat_ms[kind].extend(batch_lat)
        if metrics is not None:
            depth = sum(len(p) for p in pending.values())
            _observe_batch(metrics, kind, batch_lat, len(sl), batch,
                           queue_depth=depth)

    for qid, (kind, src) in enumerate(queries):
        t_enq = time.monotonic()
        # malformed queries become structured per-query errors
        if kind not in KINDS:
            finish(qid, str(kind), src, "error", t_enq,
                   reason=f"unknown kind {kind!r}; expected one of "
                          f"{','.join(KINDS)}")
            continue
        try:
            src = int(src)
        except (TypeError, ValueError):
            finish(qid, kind, src, "error", t_enq,
                   reason=f"source {src!r} is not an integer")
            continue
        if num_v is not None and not 0 <= src < num_v:
            finish(qid, kind, src, "error", t_enq,
                   reason=f"source {src} out of range [0, {num_v})")
            continue
        if admission is not None:
            shed_reason = admission.admit(kind, pending)
            if shed_reason is not None:
                finish(qid, kind, src, "shed", t_enq, reason=shed_reason)
                continue
        dl = None if budget is None else budget.deadline_from(t_enq)
        pending[kind].append((qid, src, t_enq, dl))
        if metrics is not None:
            metrics.gauge_max(
                "queue_depth_peak", sum(len(p) for p in pending.values()),
                help="high-water mark of queued-but-unflushed queries")
        if len(pending[kind]) == batch:
            flush(kind)
    for kind in KINDS:                   # ragged tails, padded
        flush(kind)
    total_s = time.monotonic() - t_start

    if validate:                         # oracles off the serving clock
        for kind, sl, field in answers:
            failures += _validate_kind(g, kind, sl, field, hops)
    if metrics is not None:
        _count_totals(metrics, batches, overflow)
        metrics.counter("straggler_batches_total", len(wd.stragglers),
                        help="flushes the watchdog flagged as stragglers")

    all_lat = np.asarray(sum(lat_ms.values(), []))
    per_kind = {}
    for kind in KINDS:
        lk = np.asarray(lat_ms[kind])
        if len(lk):
            per_kind[kind] = {"requests": int(len(lk)),
                              **latency_summary(lk)}
    return {
        "kinds": sorted(per_kind), "backend": backend,
        "placement": placement, "batch": batch,
        "hops": hops, "requests": n_q, "batches": batches,
        "total_s": round(total_s, 4), "qps": round(n_q / total_s, 2),
        **latency_summary(all_lat),
        "per_kind": per_kind,
        "overflow": overflow,
        "queries": results,
        "flushes": flushes,
        "status_counts": status_counts,
        "retried": retried,
        "stragglers": len(wd.stragglers),
        "validation_failures": failures if validate else None,
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description="Serve a stream of graph queries in fixed batch "
                    "slots on one card (--kinds mixes query kinds in one "
                    "stream).")
    ap.add_argument("--graph", default="rmat",
                    choices=("rmat", "rgg", "grid"))
    ap.add_argument("--scale", type=int, default=12)
    ap.add_argument("--edge-factor", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--index-dtype", default=None,
                    choices=("int16", "int32", "int64"),
                    help="vertex-id width of the served graph (default: "
                         "the narrowest that holds n)")
    ap.add_argument("--encoding", default="dense",
                    choices=("dense", "delta"),
                    help="CSR/CSC column storage encoding")
    ap.add_argument("--primitive", default="bfs", choices=("bfs", "sssp"))
    ap.add_argument("--kinds", default=None, metavar="K0,K1,...",
                    help=f"serve a MIXED stream over these query kinds "
                         f"(of {','.join(KINDS)}); overrides --primitive")
    ap.add_argument("--hops", type=int, default=3,
                    help="k of reach queries")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8,
                    help="fixed batch-slot count (B lanes)")
    ap.add_argument("--warmup", type=int, default=1,
                    help="untimed warmup batches a kind (the kernels' "
                         "first launches)")
    ap.add_argument("--parts", type=int, default=None, metavar="P",
                    help="serve from a P-way 1-D partition (sharded "
                         "placement; part i on cuda:(i mod device "
                         "count)); balance lands in --json")
    ap.add_argument("--mesh", default=None, metavar="RxC",
                    help="serve from an R×C 2-D vertex-cut partition "
                         "(2d placement); --parts P is the 1-D form")
    ap.add_argument("--validate", action="store_true",
                    help="validate the built graph and check every lane "
                         "against the host oracles")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-query wall-clock budget")
    ap.add_argument("--max-iters", type=int, default=None,
                    help="per-query BSP iteration budget (partial "
                         "answers, stamped deadline_exceeded)")
    ap.add_argument("--retries", type=int, default=2,
                    help="batch retries down the degradation ladder "
                         "(under --faults only)")
    ap.add_argument("--max-pending", type=int, default=None,
                    help="admission control: shed arrivals once this "
                         "many queries are queued")
    ap.add_argument("--backend", default=None, choices=B.BACKENDS,
                    help="operator backend (default: cuda on the card, "
                         "torch on the CPU)")
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    ap.add_argument("--faults", default=None, metavar="SPEC",
                    help="install a seeded fault plan, e.g. "
                         "'provider_miss@0.3;nan@0.2;straggler@0.1'")
    ap.add_argument("--faults-seed", type=int, default=0)
    ap.add_argument("--log-level", default="info",
                    choices=sorted(obs.log.LEVELS))
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="append the stats row to a JSON list file")
    ap.add_argument("--metrics", default=None, metavar="PATH",
                    help="write serving metrics as Prometheus text; '-' "
                         "prints to stdout")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="write phase spans as Chrome trace-event JSON")
    args = ap.parse_args(argv)
    obs.configure(args.log_level)
    mesh_shape = None
    if args.mesh:
        if args.parts:
            raise SystemExit(
                "--mesh and --parts are mutually exclusive (--parts P "
                "is the 1-D form of --mesh 1xP; pick one)")
        try:
            r, c = (int(t) for t in args.mesh.lower().split("x"))
            if r < 1 or c < 1:
                raise ValueError(args.mesh)
        except ValueError:
            raise SystemExit(
                f"--mesh wants RxC with positive integers (e.g. 2x2), "
                f"got {args.mesh!r}") from None
        mesh_shape = (r, c)
    if args.parts is not None and args.parts < 1:
        raise SystemExit(f"--parts wants a positive part count, got "
                         f"{args.parts}")
    kinds = None
    if args.kinds:
        kinds = [k.strip() for k in args.kinds.split(",")]
        for k in kinds:
            if k not in KINDS:
                raise SystemExit(f"unknown query kind {k!r}; pick from "
                                 f"{KINDS}")
    if (args.parts or mesh_shape) and not kinds:
        kinds = [args.primitive]     # mesh serving runs the mixed path
    dev = resolve_device(args.device)
    bk = B.resolve(args.backend, dev)
    if args.trace:
        obs.reset()
    with (inject.faults(args.faults, args.faults_seed) if args.faults
          else contextlib.nullcontext()) as plan:
        return _serve_main(args, kinds, dev, bk, plan, mesh_shape)


def _mesh_for(dev: torch.device, shape, axes):
    """Part i on ``cuda:(i mod device_count)`` on the card (every part
    on the one card of a one-card machine), on ``dev`` otherwise."""
    from ..core.partition import Mesh
    if dev.type == "cuda":
        return Mesh.over([torch.device("cuda", i)
                          for i in range(torch.cuda.device_count())],
                         shape, axes)
    return Mesh.on(dev, shape, axes)


def _partition(args, g, dev, mesh_shape, kinds, metrics):
    """(runner, placement, row of stats) of a mesh stream: the partition
    and its device view built once, under the "partition" and "shard"
    setup spans."""
    from ..core.distributed import exchange_bytes_per_step
    from ..core.partition import partition_1d, partition_2d
    need = args.parts if args.parts else mesh_shape[0] * mesh_shape[1]
    with obs.span("partition", category="setup", args={"parts": need}):
        if mesh_shape:
            pg = partition_2d(g, *mesh_shape)
            mesh, axis = _mesh_for(dev, mesh_shape, ("row", "col")), \
                ("row", "col")
        else:
            pg = partition_1d(g, args.parts)
            mesh, axis = _mesh_for(dev, (args.parts,), ("graph",)), "graph"
    with obs.span("shard", category="setup", args={"parts": need}):
        runner = make_sharded_runner(pg, mesh, axis)
    bal = pg.balance()
    log.info(f"partition: "
             + (f"{mesh_shape[0]}x{mesh_shape[1]} mesh" if mesh_shape
                else f"{need} parts")
             + f" on {len(mesh.distinct())} device(s), edge imbalance "
               f"{bal['edge_imbalance']}x, vertex imbalance "
               f"{bal['vertex_imbalance']}x")
    per_step = {}
    for kind in kinds:
        try:
            per_step[kind] = exchange_bytes_per_step(pg, kind)
        except ValueError:
            continue                 # a kind without a comm-model entry
        if metrics is not None:
            metrics.gauge("exchange_bytes_per_step", per_step[kind],
                          help="analytic per-device exchange bytes per "
                               "BSP step (comm model)", kind=kind)
    row = {"parts": pg.num_parts, "balance": bal,
           "exchange_bytes_per_step": per_step}
    if mesh_shape:
        row["mesh"] = list(mesh_shape)
    return runner, B.TWOD if mesh_shape else B.SHARDED, row


def _serve_main(args, kinds, dev, bk, plan, mesh_shape=None) -> dict:
    if plan is not None:
        log.warning(f"fault injection ACTIVE: {plan.spec!r} "
                    f"seed={plan.seed}")
    # the device health probe, once at startup
    for name, ok in ft.check_devices().items():
        if not ok:
            log.warning(f"device {name} failed the health probe")
    metrics = Metrics() if args.metrics else None
    with obs.span("build_graph", category="setup",
                  args={"kind": args.graph, "scale": args.scale}):
        g = make_graph(args.graph, args.scale, args.edge_factor,
                       args.seed, index_dtype=args.index_dtype,
                       encoding=args.encoding, device=dev)
        obs.tracing.fence(g.row_offsets)
    if args.validate:
        from ..core.graph import validate_graph
        validate_graph(g)
        log.info("structural validation: CSR/CSC clean")
    storage = resident_bytes(g)
    rng = np.random.default_rng(args.seed)
    runner, placement, mesh_row = None, B.SINGLE, {}
    if args.parts or mesh_shape:
        runner, placement, mesh_row = _partition(args, g, dev, mesh_shape,
                                                 kinds, metrics)
    what = ",".join(kinds) if kinds else args.primitive
    log.info(f"{args.graph} scale={args.scale}: n={g.num_vertices} "
             f"m={g.num_edges} kinds={what} batch={args.batch} "
             f"backend={bk} device={dev} placement={placement}")
    pl = storage["plan"]
    log.info(f"storage: {pl['index_dtype']}/{pl['encoding']} "
             f"{storage['total_bytes'] / 2**20:.1f} MiB resident, "
             f"{storage['bytes_per_edge']} column bytes/edge "
             f"({storage['total_bytes_per_edge']} total)")

    warm_kinds = kinds or [args.primitive]
    with obs.span("warmup", category="compile",
                  args={"kinds": ",".join(warm_kinds)}):
        for _ in range(args.warmup):
            for k in warm_kinds:
                srcs = rng.integers(0, g.num_vertices, args.batch)
                try:
                    out = (runner(k, srcs, bk, args.hops) if runner
                           else _run_kind(g, k, srcs, bk, args.hops))
                    _host(out[0])
                except B.ProviderMissError as exc:
                    if not exc.injected:
                        raise        # a real miss: no fallback
                    # an injected miss may hit warmup; the first flush
                    # then pays the kernels' first launch
                    log.warning(f"warmup {k} failed "
                                f"({type(exc).__name__}: {exc})")
    if kinds:
        queries = [(kinds[i % len(kinds)],
                    int(rng.integers(0, g.num_vertices)))
                   for i in range(args.requests)]
        budget = (ft.Budget(max_iters=args.max_iters,
                            wall_ms=args.deadline_ms)
                  if (args.max_iters or args.deadline_ms) else None)
        admission = (ft.AdmissionPolicy(max_pending=args.max_pending)
                     if args.max_pending else None)
        with obs.span("serve", category="serve",
                      args={"requests": args.requests}):
            stats = serve_mixed(g, queries, args.batch, bk,
                                hops=args.hops, validate=args.validate,
                                metrics=metrics, budget=budget,
                                admission=admission,
                                retry=ft.RetryPolicy(retries=args.retries),
                                runner=runner, placement=placement)
        stats.update(mesh_row)
    else:
        sources = rng.integers(0, g.num_vertices, args.requests)
        with obs.span("serve", category="serve",
                      args={"requests": args.requests}):
            stats = serve(g, args.primitive, sources, args.batch, bk,
                          validate=args.validate, metrics=metrics)
    stats["storage"] = storage
    stats["resident_bytes"] = storage["total_bytes"]
    stats["device"] = str(dev)
    log.info(f"{stats['requests']} queries in "
             f"{stats['total_s']:.2f}s = {stats['qps']:.1f} q/s  "
             f"(lat ms mean {stats.get('lat_ms_mean', 0)} "
             f"p50 {stats.get('lat_ms_p50', 0)} "
             f"p95 {stats.get('lat_ms_p95', 0)} "
             f"p99 {stats.get('lat_ms_p99', 0)}, n={stats['samples']})")
    counts = stats.get("status_counts")
    if counts and any(counts[s] for s in STATUSES if s != "ok"):
        log.info("statuses: " + " ".join(
            f"{s}={counts[s]}" for s in STATUSES if counts[s]))
    for k, row in stats.get("per_kind", {}).items():
        log.info(f"  {k:9s} {row['requests']:4d} queries  "
                 f"lat ms mean {row['lat_ms_mean']} "
                 f"p50 {row['lat_ms_p50']} p95 {row['lat_ms_p95']} "
                 f"p99 {row['lat_ms_p99']}")
    if stats["overflow"]:
        log.warning(f"{stats['overflow']} BFS discoveries dropped by "
                    f"capped frontiers — rerun the affected queries "
                    f"with idempotence=False")
    if args.validate:
        log.info(f"validation failures: {stats['validation_failures']}")
        if stats["validation_failures"]:
            raise SystemExit("validation failed")
    if args.metrics:
        text = metrics.render()
        if args.metrics == "-":
            # reprolint: disable=RL005 -- CLI output channel
            print(text, end="")
        else:
            with open(args.metrics, "w") as f:
                f.write(text)
            log.info(f"wrote Prometheus metrics to {args.metrics}")
    if args.trace:
        n_ev = obs.export_chrome_trace(args.trace)
        log.info(f"wrote {n_ev} trace events to {args.trace}")
    if args.json:
        try:
            with open(args.json) as f:
                rows = json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            rows = []
        rows.append(stats)
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
    return stats


if __name__ == "__main__":
    main()
