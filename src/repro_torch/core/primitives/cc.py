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
work proportional to the live edges.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

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


def connected_components(graph: Graph, *,
                         backend: Optional[str] = None) -> CCResult:
    """Hooking + pointer-jumping CC. ``backend`` is accepted for a
    uniform primitive interface: CC is scatter/gather algebra with no
    kernel of its own, on both backends."""
    B.resolve(backend, graph.device)
    n = graph.num_vertices
    dev = graph.device
    src = (graph.row_seg if graph.row_seg is not None
           else row_segments_of(graph.row_offsets))
    dst = graph.col_indices
    cid = torch.arange(n, dtype=torch.int32, device=dev)
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
        iterations += 1
    ncomp = (cid == torch.arange(n, dtype=torch.int32, device=dev)).sum(
        dtype=torch.int32)
    return CCResult(labels=cid, num_components=ncomp, iterations=iterations)
