"""Single- and multi-source shortest path (paper §6.2), counterpart of
``repro.core.primitives.sssp``.

Delta-stepping over Gunrock's two-level priority queue (§5.1.5): each
relax step compacts the near pile ("compact"), advances it
("advance_batch", at the smallest capacity tier holding the pile's
degree sum), min-merges the candidate distances, records the winning
predecessor and splits the improved vertices into near/far piles by the
bucket threshold; when a lane's near pile drains its bucket advances and
the far pile is re-split.

Ties between equal candidates for one vertex go to the LAST winning
expansion slot, the order in which the reference's scatter applies its
updates (``operators.scatter_last``), so ``preds`` match it bit for
bit: the slot order of the strategy's expansion — LB's, TWC's over its
size-class order, THREAD's CSR order. ``strategy`` ("LB" | "TWC" |
"THREAD") selects the relax advance's load balancing (the paper's Fig.
20); THREAD keeps the top capacity tier. ``dist[u] + w`` is a single
float32 add on both sides. ``sssp`` is a squeezed batch of one.

``telemetry=True`` also returns a ``TelemetryBuffer`` with the
reference's columns: frontier (the near pile, B), tier, bucket (B) and
relaxations (B) a step. ``budget=`` caps the steps (``converged`` False
on lanes cut short: their ``dist`` is an upper bound).
``sssp_bellman_ford`` is the Ligra baseline: the priority queue off.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ...analysis import sanitize
from .. import backend as B
from .. import operators as ops
from ..enactor import run_until_any, select_lanes, tiered_step
from ..frontier import BatchedDenseFrontier, tier_index
from ..graph import Graph

INF = float("inf")


class SSSPState(NamedTuple):
    dist: torch.Tensor         # (B, n) float32
    preds: torch.Tensor        # (B, n) int32
    near: torch.Tensor         # (B, n) bool near-pile membership
    far: torch.Tensor          # (B, n) bool far-pile membership
    bucket: torch.Tensor       # (B,) int32 current priority level
    n_near: torch.Tensor       # (B,) int32
    relaxations: torch.Tensor  # (B,) int32 edge relaxations per lane


class SSSPResult(NamedTuple):
    dist: torch.Tensor
    preds: torch.Tensor
    iterations: torch.Tensor
    relaxations: torch.Tensor
    converged: torch.Tensor


def _bucket_of(d: torch.Tensor, delta_t: torch.Tensor) -> torch.Tensor:
    """The bucket whose threshold ``(b + 1)·δ`` lies above distance
    ``d``: ``trunc(d / δ)``, one more where float rounding puts that
    threshold at or below ``d`` (d = 8, δ = fl(8/7): 8/δ rounds to
    6.9999995 and 7·δ to 8.0). The reference takes ``trunc(d / δ)``
    alone, and its near pile then never refills: the loop spins to its
    bound with ``d`` unrelaxed (ROADMAP C-ref-11). Wherever the
    reference's run finishes, the two agree."""
    b = (d / delta_t).to(torch.int32)
    return torch.where((b.to(torch.float32) + 1.0) * delta_t <= d, b + 1, b)


def _run(graph: Graph, srcs: torch.Tensor, delta: float, use_delta: bool,
         strategy: str, backend: str, tiered: bool, telemetry: bool = False,
         budget=None):
    n, m = graph.num_vertices, graph.num_edges
    b = int(srcs.shape[0])
    dev = graph.device
    # THREAD's static sweep is cut at cap_out, not sized by the workload,
    # so a smaller tier would drop edges: it keeps the top tier
    caps_e = (B.tier_plan("advance", m, device=dev)
              if tiered and m > 0 and strategy != "THREAD"
              else (max(m, 1),))
    deg = graph.degrees
    delta_t = torch.tensor(delta, dtype=torch.float32, device=dev)
    lane = torch.arange(b, device=dev)
    dist = torch.full((b, n), INF, dtype=torch.float32, device=dev)
    dist[lane, srcs.long()] = 0.0
    near = torch.zeros((b, n), dtype=torch.bool, device=dev)
    near[lane, srcs.long()] = True
    zeros = torch.zeros((b,), dtype=torch.int32, device=dev)
    state = SSSPState(dist=dist,
                      preds=torch.full((b, n), -1, dtype=torch.int32,
                                       device=dev),
                      near=near, far=torch.zeros_like(near), bucket=zeros,
                      n_near=zeros + 1, relaxations=zeros)

    def relax_at(cap_t: int, need: int):
        def relax_step(st: SSSPState) -> SSSPState:
            frontier = BatchedDenseFrontier(st.near).to_sparse(
                n, backend=backend)
            res, _ = ops.advance_batch(graph, frontier, cap_t,
                                       strategy=strategy, backend=backend)
            if strategy != "THREAD":
                # LB's and TWC's live slots are a prefix no longer than
                # the largest near-pile degree sum: the rest is dead
                # weight (one dead slot stays when the pile has no
                # edges, e.g. an isolated source, so the gathers below
                # see a non-empty row). THREAD's lie anywhere in CSR
                # order.
                k = max(min(cap_t, need), 1)
                res = ops.AdvanceResult(*(t[:, :k] if t.dim() == 2 else t
                                          for t in res))
            valid = res.valid
            # bf16 weights widen to float32 exactly, as the reference's
            # float32 + bfloat16 promotes them
            w = (graph.edge_values[torch.where(valid, res.edge_id, 0).long()]
                 .to(torch.float32)
                 if m else torch.zeros(valid.shape, device=dev))
            safe_src = torch.where(valid, res.src, 0).long()
            cand = torch.gather(st.dist, 1, safe_src) + w
            # atomicMin replacement: min-merge into dist
            new_dist = ops.scatter_min(cand, res.dst, valid, st.dist)
            improved = new_dist < st.dist
            safe_dst = torch.where(valid, res.dst, 0).long()
            winner = valid & (cand <= torch.gather(new_dist, 1, safe_dst))
            preds = ops.scatter_last(res.src, res.dst, winner, st.preds)
            thresh = (st.bucket.to(torch.float32) + 1.0) * delta_t
            if use_delta:
                add_near = improved & (new_dist < thresh[:, None])
                add_far = improved & (new_dist >= thresh[:, None])
            else:
                add_near = improved
                add_far = torch.zeros_like(improved)
            far = (st.far | add_far) & ~add_near
            return st._replace(dist=new_dist, preds=preds, near=add_near,
                               far=far,
                               n_near=add_near.sum(dim=1, dtype=torch.int32),
                               relaxations=st.relaxations + res.total)
        return relax_step

    def relax_step(st: SSSPState, need: int) -> SSSPState:
        return tiered_step(need, caps_e,
                           lambda cap_t: relax_at(cap_t, need), st)

    def pop_far(st: SSSPState) -> SSSPState:
        # near pile empty: advance the bucket to the smallest far distance
        far_min = torch.where(st.far, st.dist, INF).min(dim=1).values
        new_bucket = torch.where(torch.isfinite(far_min),
                                 _bucket_of(far_min, delta_t),
                                 st.bucket + 1)
        thresh = (new_bucket.to(torch.float32) + 1.0) * delta_t
        near = st.far & (st.dist < thresh[:, None])
        return st._replace(near=near, far=st.far & ~near, bucket=new_bucket,
                           n_near=near.sum(dim=1, dtype=torch.int32))

    def cond(st: SSSPState) -> torch.Tensor:
        return (st.n_near > 0) | st.far.any(dim=1)

    def plan(st: SSSPState) -> torch.Tensor:
        need = torch.where(st.near, deg[None, :], 0).sum(
            dim=1, dtype=torch.int32).max()
        return torch.cat([(st.n_near > 0).to(torch.int32), need[None]])

    def body(st: SSSPState, active: list, p: list) -> SSSPState:
        has_near, need = p[:b], p[b]
        if all(has_near):
            return relax_step(st, need)
        if not any(has_near):
            return pop_far(st)
        # lanes disagree (relax vs bucket pop): compute both, select
        return select_lanes(st.n_near > 0, relax_step(st, need),
                            pop_far(st))

    probe = buf = None
    if telemetry:
        from ...obs.telemetry import TelemetryBuffer
        i32 = torch.int32
        buf = TelemetryBuffer.make(4 * n + 8, {
            "frontier": ((b,), i32), "tier": ((), i32),
            "bucket": ((b,), i32), "relaxations": ((b,), i32)}, dev)

        def probe(prev: SSSPState, new: SSSPState, p: list) -> dict:
            # a bucket-pop step records the tier of its empty near pile
            return {"frontier": new.n_near,
                    "tier": caps_e[tier_index(p[b], tuple(caps_e))],
                    "bucket": new.bucket,
                    "relaxations": new.relaxations - prev.relaxations}

    final, lane_iters, _, *rest = run_until_any(
        cond, plan, body, state, max_iter=4 * n + 8, probe=probe,
        telemetry=buf, budget=budget)
    result = SSSPResult(dist=final.dist, preds=final.preds,
                        iterations=torch.tensor(lane_iters,
                                                dtype=torch.int32,
                                                device=dev),
                        relaxations=final.relaxations,
                        converged=~cond(final))
    return (result, rest[0]) if telemetry else result


def _auto_delta(graph: Graph) -> float:
    """Average weight × average degree / 2 (Davidson et al.). The mean
    is a float32 sum whose order may differ from the reference's, so
    parity tests pass ``delta`` explicitly."""
    mean_w = float(graph.edge_values.mean())
    avg_deg = max(graph.num_edges / max(graph.num_vertices, 1), 1.0)
    return mean_w * avg_deg / 2.0


@B.draw_scope()
def sssp_batch(graph: Graph, srcs, *, delta: Optional[float] = None,
               strategy: str = "LB", backend: Optional[str] = None,
               tiered: bool = True, telemetry: bool = False, budget=None):
    """Multi-source delta-stepping in one batched loop; lane i is
    bit-identical to ``sssp(graph, srcs[i])``. ``tiered=False`` pins
    relax sweeps to the top capacity tier (identical results).
    ``telemetry=True`` returns ``(SSSPResult, TelemetryBuffer)`` with a
    result bit-identical to ``telemetry=False``; ``budget`` caps the
    BSP steps."""
    if not graph.weighted:
        raise ValueError("SSSP needs edge weights")
    if delta is None:
        delta = _auto_delta(graph)
    delta = float(delta)
    use_delta = delta > 0 and delta != INF and delta == delta
    bk = B.resolve(backend, graph.device)
    srcs = torch.as_tensor(srcs, dtype=torch.int32).reshape(-1).to(
        graph.device)
    key = (int(srcs.shape[0]), bk, delta, strategy, tiered)
    with sanitize.setup_probe("sssp", graph.cache, key):
        return _run(graph, srcs, delta, use_delta, strategy, bk, tiered,
                    telemetry, budget)


@B.draw_scope()
def sssp(graph: Graph, src: int, *, telemetry: bool = False, **kw):
    """Delta-stepping SSSP — a squeezed batch-of-1 ``sssp_batch``. With
    ``telemetry=True``: ``(SSSPResult, TelemetryBuffer)``."""
    r = sssp_batch(graph, [src], telemetry=telemetry, **kw)
    if telemetry:
        res, buf = r
        return SSSPResult(*(t[0] for t in res)), buf
    return SSSPResult(*(t[0] for t in r))


@B.draw_scope()
def sssp_bellman_ford(graph: Graph, src: int, *, strategy: str = "LB",
                      backend: Optional[str] = None) -> SSSPResult:
    """Bellman-Ford-style full relaxation (the Ligra comparison
    baseline): a batch-of-1 run with the priority queue off — every
    improved vertex joins the next near pile."""
    if not graph.weighted:
        raise ValueError("SSSP needs edge weights")
    bk = B.resolve(backend, graph.device)
    srcs = torch.tensor([src], dtype=torch.int32, device=graph.device)
    r = _run(graph, srcs, 1e30, False, strategy, bk, True)
    return SSSPResult(*(t[0] for t in r))
