"""Triangle counting (paper §6.6) — masked semiring SpGEMM, counterpart
of ``repro.core.primitives.tc``.

Stage 1 (host, 'forming edge lists'): orient each undirected edge from
the higher-(degree, id) endpoint to the lower — the paper's workload
reduction that removes ~5/6 of the intersection work. The oriented
edges are the nnz pattern of the output mask M and induce a DAG G'.

Stage 2 (device): ``C⟨M⟩ = A' ⊗ A'ᵀ`` over the ⟨plus, and⟩ semiring,
``C[u,v] = |N'(u) ∩ N'(v)|``, so every triangle is counted exactly once
at its mask edge. The product runs through the ``"mxm"`` registry op:
on the cuda backend K3 expands the smaller row of each mask edge and K5
locates each of its columns in the larger row.

The expansion has Σ over mask edges of min(deg'(u), deg'(v)) slots
(``linalg.mxm_plan``), which must fit int32: rmat (edge factor 16)
scale 18 needs 6.6e8, scale 19 1.7e9, scale 20 4.4e9 (PERF.md §4).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ... import linalg
from ...analysis import sanitize
from .. import backend as B
from ..graph import Graph, edge_list, from_edge_list


class TCResult(NamedTuple):
    total: torch.Tensor       # () int32 global triangle count
    per_edge: torch.Tensor    # (m',) int32 per-oriented-edge counts
    edge_src: np.ndarray      # (m',) oriented edge sources (host)
    edge_dst: np.ndarray      # (m',) oriented edge destinations (host)


def _orient(graph: Graph) -> tuple[Graph, np.ndarray, np.ndarray]:
    """Filter stage: orient each undirected edge high→low (deg, id)."""
    src, dst = edge_list(graph)
    deg = np.diff(graph.row_offsets.cpu().numpy())
    keep = (deg[src] > deg[dst]) | ((deg[src] == deg[dst]) & (src > dst))
    sub = from_edge_list(src[keep], dst[keep], n=graph.num_vertices,
                         undirected=False, build_csc=False,
                         deduplicate=False, remove_self_loops=False,
                         device=graph.device)
    ssrc, sdst = edge_list(sub)
    return sub, ssrc, sdst


@B.draw_scope()
def triangle_count(graph: Graph, *, backend: Optional[str] = None,
                   telemetry: bool = False):
    """Exact TC via ``C⟨G'⟩ = G' ⊗ G'ᵀ`` over ⟨plus, and⟩. The graph must
    be undirected (both edge directions present), with sorted neighbour
    lists (``from_edge_list`` guarantees it). ``telemetry=True`` returns
    ``(TCResult, TelemetryBuffer)``: TC has no BSP loop, so its one row
    records the oriented workload (the edges kept)."""
    bk = B.resolve(backend, graph.device)
    # the orientation is per-call host work, as in the reference: the
    # set-up scope covers the product (one oriented edge count, one key)
    sub, ssrc, sdst = _orient(graph)
    with sanitize.setup_probe("tc", graph.cache, (bk, sub.num_edges)):
        result = _count(graph, sub, ssrc, sdst, bk)
    if not telemetry:
        return result
    from ...obs.telemetry import TelemetryBuffer
    buf = TelemetryBuffer.make(1, {"oriented_edges": ((), torch.int32)},
                               graph.device)
    return result, buf.record(oriented_edges=sub.num_edges)


def _count(graph: Graph, sub: Graph, ssrc, sdst, bk: str) -> TCResult:
    if sub.num_edges == 0:
        zero = torch.zeros((), dtype=torch.int32, device=graph.device)
        result = TCResult(zero, torch.zeros((0,), dtype=torch.int32,
                                            device=graph.device),
                          ssrc, sdst)
    else:
        counts = linalg.mxm(sub, sub, (ssrc, sdst),
                            semiring=linalg.plus_and, b_transpose=True,
                            structural=True, backend=bk).to(torch.int32)
        result = TCResult(total=counts.sum(dtype=torch.int32),
                          per_edge=counts, edge_src=ssrc, edge_dst=sdst)
    return result


@B.draw_scope()
def triangle_count_full(graph: Graph, *,
                        backend: Optional[str] = None) -> torch.Tensor:
    """Unfiltered variant ('tc-intersection-full' in Fig. 25): the same
    masked SpGEMM over BOTH directions of every edge, divided by 6 — the
    baseline that shows the orientation's ~6x workload reduction. The
    per-edge counts are summed as integers (the reference sums them in
    float32, which is exact only while the sum stays below 2^24)."""
    bk = B.resolve(backend, graph.device)
    if graph.num_edges == 0:
        return torch.zeros((), dtype=torch.int32, device=graph.device)
    src, dst = edge_list(graph)
    counts = linalg.mxm(graph, graph, (src, dst), semiring=linalg.plus_and,
                        b_transpose=True, structural=True, backend=bk)
    total = counts.sum(dtype=torch.int64) // 6
    return total.to(torch.int32)
