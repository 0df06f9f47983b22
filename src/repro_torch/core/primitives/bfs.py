"""Breadth-first search (paper §6.1), counterpart of
``repro.core.primitives.bfs``.

  * LB push: one fused "advance_filter" dispatch per iteration
    (expansion + visited test + exact first-occurrence culling +
    compaction), run at the smallest power-of-two capacity tier holding
    the frontier's degree sum;
  * TWC / THREAD push (the paper's Fig. 20 ablation): the unfused step
    at full capacity (m slots a lane) — advance with a visited functor,
    an idempotent depth write, the visited bits set, the expansion
    compacted to a wide frontier, then ``filter_frontier_batch`` into
    the min(n, m) vertex frontier, with hash culling when
    ``idempotence`` (the Fig. 19 flag) and exact uniquification
    otherwise; the clamp's dropped discoveries add to ``overflow``;
  * direction-optimized push↔pull switching with do_a / do_b; the pull
    step's new bitmap is compacted back to a queue through "compact";
  * predecessor recording: an LB push predecessor is the discoverer in
    the smallest expansion slot, an unfused one the discoverer in the
    LARGEST slot of the strategy's expansion order (the reference's
    scatter, ``operators.scatter_last``), a pull predecessor the largest
    active in-neighbour — the reference's tie rules.

``bfs_batch`` runs B traversals over one topology in one batched BSP
loop (``enactor.run_until_any``); ``bfs`` is a squeezed batch of one.
Every output equals the reference's, bit for bit. ``idempotence``
acts on the unfused TWC / THREAD step only: LB's fused culling is exact
anyway. A nonzero ``overflow`` (possible only under hash culling) means
a capped frontier dropped discoveries: rerun with ``idempotence=False``.
Such a frontier of duplicates can pass int32 in a lane's degree sum;
there the reference's scan wraps and the port's saturates, so the two
part ways (every slot below cap_out is then the true expansion's).

``telemetry=True`` also returns a ``TelemetryBuffer`` with the
reference's columns: frontier (B,), tier, direction (B,) and overflow
(B,) a step. ``budget=`` caps the steps; lanes cut short come back
partial with ``converged`` False.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ...analysis import sanitize
from .. import backend as B
from .. import operators as ops
from ..direction import PULL, PUSH, DirectionParams, decide_direction
from ..enactor import run_until_any, select_lanes, tiered_step
from ..frontier import (BatchedDenseFrontier, BatchedSparseFrontier,
                        from_ids_batch, tier_index)
from ..graph import Graph


class BFSState(NamedTuple):
    labels: torch.Tensor       # (B, n) int32 depth, -1 unvisited
    preds: torch.Tensor        # (B, n) int32 predecessor, -1 none
    frontier: BatchedSparseFrontier  # (B, cap_v) push queue
    dense: torch.Tensor        # (B, n) bool current frontier bitmap
    visited: torch.Tensor      # (B, n) bool
    n_f: torch.Tensor          # (B,) int32 frontier size
    n_u: torch.Tensor          # (B,) int32 unvisited count
    depth: torch.Tensor        # (B,) int32
    mode: torch.Tensor         # (B,) int32 PUSH/PULL
    pull_iters: torch.Tensor   # (B,) int32
    overflow: torch.Tensor     # (B,) int32 discoveries dropped by cap_v


class BFSResult(NamedTuple):
    labels: torch.Tensor
    preds: torch.Tensor
    iterations: torch.Tensor
    pull_iters: torch.Tensor
    edges_visited: torch.Tensor
    overflow: torch.Tensor
    converged: torch.Tensor


def _scatter_rows(target: torch.Tensor, ids: torch.Tensor,
                  values: torch.Tensor) -> torch.Tensor:
    """``target[b, ids[b, j]] = values[b, j]`` where ``ids >= 0``; the
    ids of a row are distinct. -1 entries land in a junk column that is
    sliced away (the reference's ``mode="drop"``)."""
    b, n = target.shape
    hit = torch.zeros((b, n + 1), dtype=torch.bool, device=target.device)
    tgt = torch.where(ids >= 0, ids, n).long()
    hit.scatter_(1, tgt, True)
    buf = torch.empty((b, n + 1), dtype=target.dtype, device=target.device)
    buf.scatter_(1, tgt, values.expand_as(ids).to(target.dtype))
    return torch.where(hit[:, :n], buf[:, :n], target)


def _run(graph: Graph, srcs: torch.Tensor, do_a: float, do_b: float,
         direction: bool, idempotence: bool, strategy: str,
         record_preds: bool, backend: str, tiered: bool,
         telemetry: bool = False, budget=None):
    n, m = graph.num_vertices, graph.num_edges
    b = int(srcs.shape[0])
    dev = graph.device
    # vertex frontiers are post-uniquify: min(n, m) slots suffice
    cap_v = max(min(n, m), 1)
    cap_e = m
    # only LB's fused push is tiered; TWC / THREAD run at full capacity
    caps_e = (B.tier_plan("advance_filter", cap_e, device=graph.device)
              if tiered and strategy == "LB" and cap_e > 0
              else (max(cap_e, 1),))
    params = DirectionParams(do_a=do_a, do_b=do_b, enabled=direction)
    deg = graph.degrees

    lane = torch.arange(b, device=dev)
    labels = torch.full((b, n), -1, dtype=torch.int32, device=dev)
    labels[lane, srcs.long()] = 0
    visited = torch.zeros((b, n), dtype=torch.bool, device=dev)
    visited[lane, srcs.long()] = True
    zeros = torch.zeros((b,), dtype=torch.int32, device=dev)
    state = BFSState(labels=labels,
                     preds=torch.full((b, n), -1, dtype=torch.int32,
                                      device=dev),
                     frontier=from_ids_batch(srcs, cap_v), dense=visited,
                     visited=visited, n_f=zeros + 1, n_u=zeros + (n - 1),
                     depth=zeros, mode=zeros + PUSH, pull_iters=zeros,
                     overflow=zeros)

    def fused_push_at(cap_t: int):
        def push_step(st: BFSState) -> BFSState:
            depth1 = st.depth + 1
            front, srcs_, totals = ops.advance_filter_batch(
                graph, st.frontier, st.visited, cap_t, cap_front=cap_v,
                backend=backend)
            ids = front.ids
            # one surviving slot per discovery: conflict-free scatters
            labels = _scatter_rows(st.labels, ids, depth1[:, None])
            preds = (_scatter_rows(st.preds, ids, srcs_) if record_preds
                     else st.preds)
            visited = _scatter_rows(st.visited, ids,
                                    torch.ones((), dtype=torch.bool,
                                               device=dev))
            ovf = torch.clamp(totals - front.lengths, min=0)
            return st._replace(labels=labels, preds=preds, frontier=front,
                               dense=visited, visited=visited,
                               n_f=front.lengths,
                               n_u=st.n_u - front.lengths, depth=depth1,
                               overflow=st.overflow + ovf)
        return push_step

    def unfused_push_step(st: BFSState) -> BFSState:
        depth1 = st.depth + 1

        def functor(s, d, e, rank, valid, visited):
            # discover unvisited destinations (duplicates all pass)
            safe = torch.where(valid, d, 0).long()
            return valid & ~torch.gather(visited, 1, safe), visited

        res, _ = ops.advance_batch(graph, st.frontier, cap_e,
                                   functor=functor, data=st.visited,
                                   strategy=strategy, backend=backend)
        # idempotent depth write: every duplicate writes the same value
        found = ops.scatter_or(res.dst, res.valid,
                               torch.zeros_like(st.visited))
        labels = torch.where(found, depth1[:, None], st.labels)
        preds = (ops.scatter_last(res.src, res.dst, res.valid, st.preds)
                 if record_preds else st.preds)
        visited = st.visited | found
        # the whole expansion compacted, then uniquified into the cap_v
        # vertex frontier: hash culling's leftover duplicates are the
        # only way past cap_v, and the clamp counts what it drops
        wide = ops.advance_to_vertex_frontier_batch(res, cap_e,
                                                    backend=backend)
        front, _, ovf = ops.filter_frontier_batch(
            wide, n=n, uniquify="hash" if idempotence else "exact",
            cap=cap_v, backend=backend)
        return st._replace(labels=labels, preds=preds, frontier=front,
                           dense=visited, visited=visited,
                           n_f=front.lengths, n_u=st.n_u - front.lengths,
                           depth=depth1, overflow=st.overflow + ovf)

    def push_step(st: BFSState, need: int) -> BFSState:
        if strategy != "LB":
            return unfused_push_step(st)
        return tiered_step(need, caps_e, fused_push_at, st)

    def pull_step(st: BFSState) -> BFSState:
        depth1 = st.depth + 1
        new_dense, pull_preds = ops.advance_pull_batch(
            graph, BatchedDenseFrontier(~st.visited),
            BatchedDenseFrontier(st.dense), return_preds=True)
        flags = new_dense.flags
        labels = torch.where(flags, depth1[:, None], st.labels)
        preds = (torch.where(flags, pull_preds, st.preds) if record_preds
                 else st.preds)
        n_new = new_dense.lengths
        sparse = new_dense.to_sparse(cap_v, backend=backend)
        return st._replace(labels=labels, preds=preds, frontier=sparse,
                           dense=flags, visited=st.visited | flags,
                           n_f=n_new, n_u=st.n_u - n_new, depth=depth1,
                           pull_iters=st.pull_iters + 1)

    def next_mode(st: BFSState) -> torch.Tensor:
        return decide_direction(st.mode, st.n_f, st.n_u, n, m, params)

    def plan(st: BFSState) -> torch.Tensor:
        # the host needs the tier's workload bound and, with direction
        # optimization on, every lane's next direction
        need = ops.frontier_workload(graph, st.frontier).max()[None]
        if not direction:
            return need
        return torch.cat([next_mode(st), need])

    def body(st: BFSState, active: list, p: list) -> BFSState:
        need = p[-1]
        if not direction:
            return push_step(st, need)
        modes = p[:b]
        # pull needs the dense rep of the *current* frontier (push keeps
        # `dense` = visited)
        st = st._replace(mode=torch.tensor(modes, dtype=torch.int32,
                                           device=dev),
                         dense=st.frontier.to_dense(n).flags)
        if b == 1:
            return pull_step(st) if modes[0] == PULL else push_step(st, need)
        # only active lanes count toward a homogeneous direction
        live = [md for md, a in zip(modes, active) if a]
        if all(md == PUSH for md in live):
            return push_step(st, need)
        if all(md == PULL for md in live):
            return pull_step(st)
        return select_lanes(st.mode == PULL, pull_step(st),
                            push_step(st, need))

    probe = buf = None
    if telemetry:
        from ...obs.telemetry import TelemetryBuffer
        i32 = torch.int32
        buf = TelemetryBuffer.make(n + 1, {
            "frontier": ((b,), i32), "tier": ((), i32),
            "direction": ((b,), i32), "overflow": ((b,), i32)}, dev)

        def probe(prev: BFSState, new: BFSState, p: list) -> dict:
            # the tier the step's workload (the host's need) selected
            return {"frontier": new.n_f,
                    "tier": caps_e[tier_index(p[-1], tuple(caps_e))],
                    "direction": new.mode,
                    "overflow": new.overflow - prev.overflow}

    final, lane_iters, _, *rest = run_until_any(
        lambda st: st.n_f > 0, plan, body, state, max_iter=n + 1,
        probe=probe, telemetry=buf, budget=budget)
    edges = torch.where(final.labels >= 0, deg[None, :], 0).sum(
        dim=1, dtype=torch.int32)
    result = BFSResult(labels=final.labels, preds=final.preds,
                       iterations=torch.tensor(lane_iters,
                                               dtype=torch.int32,
                                               device=dev),
                       pull_iters=final.pull_iters, edges_visited=edges,
                       overflow=final.overflow, converged=final.n_f == 0)
    return (result, rest[0]) if telemetry else result


@B.draw_scope()
def bfs_batch(graph: Graph, srcs, *, direction: bool = True,
              do_a: float = 0.001, do_b: float = 0.2,
              idempotence: bool = True, strategy: str = "LB",
              record_preds: bool = True, backend: Optional[str] = None,
              tiered: bool = True, telemetry: bool = False, budget=None):
    """Multi-source BFS: one batched BSP loop over ``srcs``; lane i is
    bit-identical to ``bfs(graph, srcs[i])``. ``tiered=False`` pins
    every push to the top capacity tier (identical results).

    ``telemetry=True`` returns ``(BFSResult, TelemetryBuffer)``; the
    result is bit-identical to ``telemetry=False``. ``budget`` (an
    ``ft.Budget``) caps the BSP steps: lanes cut short keep partial
    labels and report ``converged`` False."""
    if direction and not graph.has_csc:
        direction = False
    bk = B.resolve(backend, graph.device)
    srcs = torch.as_tensor(srcs, dtype=torch.int32).reshape(-1).to(
        graph.device)
    # one configuration: the batch width and the static options
    key = (int(srcs.shape[0]), bk, direction, idempotence, strategy,
           record_preds, tiered)
    with sanitize.setup_probe("bfs", graph.cache, key):
        return _run(graph, srcs, float(do_a), float(do_b), direction,
                    idempotence, strategy, record_preds, bk, tiered,
                    telemetry, budget)


@B.draw_scope()
def bfs(graph: Graph, src: int, *, telemetry: bool = False, **kw):
    """BFS from ``src`` — a squeezed batch-of-1 ``bfs_batch`` call. With
    ``telemetry=True``: ``(BFSResult, TelemetryBuffer)``, the buffer
    keeping its lane axis."""
    r = bfs_batch(graph, [src], telemetry=telemetry, **kw)
    if telemetry:
        res, buf = r
        return BFSResult(*(t[0] for t in res)), buf
    return BFSResult(*(t[0] for t in r))
