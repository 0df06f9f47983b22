"""Connected components (paper §6.4) — hooking + pointer jumping
(Soman et al. style) on an edge frontier, counterpart of
``repro.core.primitives.cc``.

Each outer iteration:
  hooking      — every live edge hooks the higher component id of its
                 endpoints onto the lower one (a scatter-min: the race
                 the paper notes is resolved by min-reduction);
  pointer-jump — component trees are flattened to stars (cid = cid[cid]
                 until a fixpoint);
  filter       — edges whose endpoints now share a component leave the
                 edge frontier.
Converges when the edge frontier is empty. The reference sweeps all m
edges every iteration under a live mask; here the frontier is compacted
to its live edges, which gives the same labels and iteration count with
work proportional to the live edges. ``telemetry=True`` also returns a
``TelemetryBuffer`` of the live edges left after each iteration.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ...analysis import sanitize
from .. import backend as B
from ..graph import Graph, row_segments_of
from ..operators import scatter_min


class CCResult(NamedTuple):
    labels: torch.Tensor          # (n,) int32 component id = its min vertex
    num_components: torch.Tensor  # () int32
    iterations: int


def _pointer_jump(cid: torch.Tensor) -> torch.Tensor:
    while True:
        nxt = torch.index_select(cid, 0, cid)
        if torch.equal(nxt, cid):
            return cid
        cid = nxt


@B.draw_scope()
def connected_components(graph: Graph, *, backend: Optional[str] = None,
                         telemetry: bool = False):
    """Hooking + pointer-jumping CC. ``backend`` is accepted for a
    uniform primitive interface: CC is scatter/gather algebra with no
    kernel of its own, on both backends. ``telemetry=True`` returns
    ``(CCResult, TelemetryBuffer)`` with the result unchanged."""
    bk = B.resolve(backend, graph.device)
    with sanitize.setup_probe("cc", graph.cache, (bk,)):
        return _cc(graph, telemetry)


def _cc(graph: Graph, telemetry: bool):
    n = graph.num_vertices
    dev = graph.device
    src = (graph.row_seg if graph.row_seg is not None
           else row_segments_of(graph.row_offsets))
    dst = graph.cols()
    cid = torch.arange(n, dtype=torch.int32, device=dev)
    buf = None
    if telemetry:
        from ...obs.telemetry import TelemetryBuffer
        buf = TelemetryBuffer.make(n + 1, {"live_edges": ((), torch.int32)},
                                   dev)
    iterations = 0
    while int(src.shape[0]) and iterations < n + 1:
        cu = torch.index_select(cid, 0, src)
        cv = torch.index_select(cid, 0, dst)
        live = cu != cv
        cid = scatter_min(torch.minimum(cu, cv), torch.maximum(cu, cv),
                          live, cid)
        del cu, cv
        cid = _pointer_jump(cid)
        still = live & (torch.index_select(cid, 0, src)
                        != torch.index_select(cid, 0, dst))
        src, dst = src[still], dst[still]
        if buf is not None:           # the compaction's length, a host int
            buf.record(live_edges=int(src.shape[0]))
        iterations += 1
    ncomp = (cid == torch.arange(n, dtype=torch.int32, device=dev)).sum(
        dtype=torch.int32)
    result = CCResult(labels=cid, num_components=ncomp,
                      iterations=iterations)
    return (result, buf) if telemetry else result
