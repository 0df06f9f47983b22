"""Betweenness centrality (paper §6.3) — Brandes's two-phase formulation,
batched over sources; counterpart of ``repro.core.primitives.bc``.

Phase 1 (forward): a level-synchronous BFS that also accumulates sigma,
the shortest-path counts. Phase 2 (backward): the BFS levels in reverse,
accumulating the dependency deltas edge-parallel (Jia et al.). Both run
B Brandes passes at once, with per-lane level counters: the batched
loop (``enactor.run_until_any``) freezes shallow lanes while deep ones
finish.

The reference sweeps all m edges at every level under a depth mask.
Here each level first selects the (lane, edge) pairs whose source lies
on the lane's level — one gather and compare over the (B, m) edge
sweep — and does the rest of the level's work on those pairs only. The
depths, sigma (integers, exact in float32 below 2^24) and the
dependencies are the reference's; the float sums of the dependencies
may run in another order.

``bc(graph)`` with no ``src`` is exact BC: every vertex as a root, in
batched chunks of ``chunk`` roots. ``samples=k`` draws k distinct roots
uniformly (the reference's seeded draw) and scales by n/k (the
Brandes–Pich estimator). ``telemetry=True`` (one pass: ``src`` or
``bc_batch``) also returns a ``TelemetryBuffer`` of the forward
phase's frontier (B) a level.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ...analysis import sanitize
from .. import backend as B
from ..enactor import run_until_any
from ..graph import Graph


class FwdState(NamedTuple):
    depth: torch.Tensor     # (B, n) int32
    sigma: torch.Tensor     # (B, n) float32
    level: torch.Tensor     # (B,) int32
    n_f: torch.Tensor       # (B,) int32


class BwdState(NamedTuple):
    delta: torch.Tensor     # (B, n) float32
    lvl: torch.Tensor       # (B,) int32


class BCResult(NamedTuple):
    bc: torch.Tensor        # per-source dependency (B, n) / (n,)
    sigma: torch.Tensor
    depth: torch.Tensor
    max_level: torch.Tensor  # (B,) one past each lane's deepest level


class MultiBCResult(NamedTuple):
    bc: torch.Tensor           # (n,) exact or estimated centrality
    num_sources: torch.Tensor  # () int32 roots accumulated
    chunks: int                # batched passes run


def _edge_sources(graph: Graph) -> torch.Tensor:
    if graph.row_seg is not None:
        return graph.row_seg
    return torch.repeat_interleave(
        torch.arange(graph.num_vertices, dtype=torch.int32,
                     device=graph.device), graph.degrees.long())


def _level_pairs(depth, lvl, active, esrc, edst):
    """Flat (B·n) indices of both ends of every (lane, edge) pair whose
    source lies on the lane's level ``lvl``, for the active lanes, and
    each pair's lane."""
    b, n = depth.shape
    on = torch.index_select(depth, 1, esrc) == lvl[:, None]
    on &= active[:, None]
    lane, e = on.nonzero(as_tuple=True)
    del on
    base = lane * n
    fu = base + torch.index_select(esrc, 0, e)
    fv = base + torch.index_select(edst, 0, e)
    return fu, fv, lane


def _bc_impl(graph: Graph, esrc: torch.Tensor, srcs: torch.Tensor,
             weights: torch.Tensor, telemetry: bool = False):
    """B Brandes passes in one batched program; ``weights`` (B,) scales
    each lane's dependencies (0 masks a padding lane). One set-up scope
    a batch width (a ragged chunk is a second one)."""
    with sanitize.setup_probe("bc", graph.cache, (int(srcs.shape[0]),)):
        return _bc_pass(graph, esrc, srcs, weights, telemetry)


def _bc_pass(graph: Graph, esrc: torch.Tensor, srcs: torch.Tensor,
             weights: torch.Tensor, telemetry: bool):
    n = graph.num_vertices
    dev = graph.device
    edst = graph.cols()
    b = int(srcs.shape[0])
    lane_ids = torch.arange(b, device=dev)

    def fwd_body(st: FwdState, active, _params) -> FwdState:
        act = torch.tensor(active, dtype=torch.bool, device=dev)
        fu, fv, lane = _level_pairs(st.depth, st.level, act, esrc, edst)
        lvl1 = torch.index_select(st.level + 1, 0, lane)
        depth = st.depth.reshape(-1).clone()
        disc = depth[fv] < 0
        depth[fv[disc]] = lvl1[disc]
        # sigma flows along every edge u(level) -> v(level + 1)
        tree = depth[fv] == lvl1
        sigma = st.sigma.reshape(-1).clone()
        sigma.index_add_(0, fv[tree], st.sigma.reshape(-1)[fu[tree]])
        depth = depth.view(b, n)
        n_f = (depth == (st.level + 1)[:, None]).sum(dim=1,
                                                     dtype=torch.int32)
        return FwdState(depth=depth, sigma=sigma.view(b, n),
                        level=st.level + 1, n_f=n_f)

    depth0 = torch.full((b, n), -1, dtype=torch.int32, device=dev)
    depth0[lane_ids, srcs.long()] = 0
    sigma0 = torch.zeros((b, n), dtype=torch.float32, device=dev)
    sigma0[lane_ids, srcs.long()] = 1.0
    zeros = torch.zeros((b,), dtype=torch.int32, device=dev)
    probe = buf = None
    if telemetry:
        # the forward (BFS) phase's levels; the backward phase replays
        # them in reverse
        from ...obs.telemetry import TelemetryBuffer
        buf = TelemetryBuffer.make(n + 1, {"frontier": ((b,), torch.int32)},
                                   dev)

        def probe(prev, new, _params):
            return {"frontier": new.n_f}

    fwd, *_ = run_until_any(
        lambda st: st.n_f > 0, lambda st: zeros[:0], fwd_body,
        FwdState(depth=depth0, sigma=sigma0, level=zeros, n_f=zeros + 1),
        max_iter=n + 1, probe=probe, telemetry=buf)
    depth_f = fwd.depth.reshape(-1)
    sigma_f = fwd.sigma.reshape(-1)

    def bwd_body(st: BwdState, active, _params) -> BwdState:
        act = torch.tensor(active, dtype=torch.bool, device=dev)
        fu, fv, lane = _level_pairs(fwd.depth, st.lvl, act, esrc, edst)
        lvl1 = torch.index_select(st.lvl + 1, 0, lane)
        sv = sigma_f[fv]
        tree = (depth_f[fv] == lvl1) & (sv > 0)
        fu, fv, sv = fu[tree], fv[tree], sv[tree]
        delta = st.delta.reshape(-1)
        contrib = (sigma_f[fu] / torch.clamp(sv, min=1e-30)
                   * (1.0 + delta[fv]))
        delta = delta.clone().index_add_(0, fu, contrib)
        return BwdState(delta=delta.view(b, n), lvl=st.lvl - 1)

    bwd, _, _ = run_until_any(
        lambda st: st.lvl >= 0, lambda st: zeros[:0], bwd_body,
        BwdState(delta=torch.zeros((b, n), dtype=torch.float32,
                                   device=dev), lvl=fwd.level - 1),
        max_iter=n + 1)
    bc_lanes = bwd.delta.clone()
    bc_lanes[lane_ids, srcs.long()] = 0.0
    result = BCResult(bc=bc_lanes * weights[:, None], sigma=fwd.sigma,
                      depth=fwd.depth, max_level=fwd.level)
    return (result, buf) if telemetry else result


@B.draw_scope()
def bc_batch(graph: Graph, srcs, weights=None, *,
             backend: Optional[str] = None, telemetry: bool = False):
    """One batched Brandes pass: lane i holds the dependencies of
    ``srcs[i]`` (scaled by ``weights[i]`` if given). ``backend`` is
    accepted for a uniform primitive interface: both phases are
    gather/scatter algebra with no kernel of their own.
    ``telemetry=True`` returns ``(BCResult, TelemetryBuffer)``."""
    B.resolve(backend, graph.device)
    dev = graph.device
    srcs = torch.as_tensor(np.asarray(srcs, np.int32).reshape(-1),
                           device=dev)
    if weights is None:
        weights = torch.ones(srcs.shape, dtype=torch.float32, device=dev)
    weights = torch.as_tensor(weights, dtype=torch.float32, device=dev)
    return _bc_impl(graph, _edge_sources(graph), srcs, weights, telemetry)


@B.draw_scope()
def bc(graph: Graph, src: Optional[int] = None, *, chunk: int = 32,
       samples: Optional[int] = None, seed: int = 0,
       backend: Optional[str] = None, telemetry: bool = False):
    """Betweenness centrality.

    * ``src`` given — one Brandes pass; the per-source ``BCResult`` (a
      squeezed batch of one, like bfs/sssp).
    * ``src=None`` — exact BC: every vertex as a root, in batched chunks
      of ``chunk`` sources. Returns ``MultiBCResult``.
    * ``samples=k`` — sampled BC: k distinct uniform roots, contributions
      scaled by n/k. Returns ``MultiBCResult``.
    """
    if src is not None:
        r = bc_batch(graph, [src], backend=backend, telemetry=telemetry)
        if telemetry:
            res, buf = r
            return BCResult(*(t[0] for t in res)), buf
        return BCResult(*(t[0] for t in r))
    if telemetry:
        raise ValueError("telemetry= is per pass; pass src= (or use "
                         "bc_batch) to collect a trajectory")
    B.resolve(backend, graph.device)
    n = graph.num_vertices
    dev = graph.device
    if samples is None:
        roots = np.arange(n, dtype=np.int32)
        scale = 1.0
    else:
        samples = min(samples, n)
        roots = np.random.default_rng(seed).choice(
            n, size=samples, replace=False).astype(np.int32)
        scale = n / max(samples, 1)
    chunk = max(1, min(chunk, len(roots))) if len(roots) else 1
    esrc = _edge_sources(graph)
    total = torch.zeros((n,), dtype=torch.float32, device=dev)
    chunks = 0
    for lo in range(0, len(roots), chunk):
        sl = roots[lo:lo + chunk]
        pad = chunk - len(sl)
        # padding lanes repeat root 0 with weight 0
        srcs = np.concatenate([sl, np.zeros(pad, np.int32)])
        w = np.concatenate([np.full(len(sl), scale, np.float32),
                            np.zeros(pad, np.float32)])
        r = _bc_impl(graph, esrc, torch.from_numpy(srcs).to(dev),
                     torch.from_numpy(w).to(dev))
        total = total + r.bc.sum(dim=0)
        chunks += 1
    return MultiBCResult(bc=total, num_sources=torch.tensor(
        len(roots), dtype=torch.int32, device=dev), chunks=chunks)
