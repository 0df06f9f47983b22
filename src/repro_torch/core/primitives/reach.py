"""k-hop reachability, or-and batched over sources (counterpart of
``repro.core.primitives.reach``) — an algebraic BFS.

``reach_batch`` answers B reachability queries against one topology:
the frontier matrix R (n, B) holds one 0/1 column per source lane, and
each hop is one dense-accumulator SpMM over the or-and semiring through
the CSC mirror (``R'[v, b] = ⋁_u A[u, v] ∧ R[u, b]``), ⊕-merged into R.
Rows every lane has already reached cannot change (R only grows under
⋁), so the complement of the all-reached set is the SpMM's row mask —
the algebraic twin of BFS's visited culling. On the cuda backend each
hop is one launch of the SpMM kernel (K4m).

Every result field carries a leading batch axis; ``reach`` is a
squeezed batch-of-1 call. Oracle: lane b of ``reached`` equals
``0 <= bfs depth <= k``. ``budget=`` clamps k to its ``max_iters``: the
clamped run answers the smaller neighbourhood, ``hops`` says which, and
``converged`` is False.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ...linalg import semiring as SR
from .. import backend as B
from ..graph import Graph


class ReachResult(NamedTuple):
    reached: torch.Tensor    # (B, n) bool — within k hops of srcs[b]
    counts: torch.Tensor     # (B,) int32 reachable-set sizes
    hops: int                # the k that was run
    converged: bool = True   # all requested hops ran (False: budget cut k)


@B.draw_scope()
def reach_batch(graph: Graph, srcs, k: int = 3, *,
                backend: Optional[str] = None,
                placement: Optional[str] = None,
                budget=None) -> ReachResult:
    """B-source k-hop reachability: k or-and SpMMs over the CSC mirror,
    each masked to the rows some lane has not reached yet. ``budget``
    (an ``ft.Budget``) clamps k. ``graph`` may be a ``ShardedGraph`` /
    ``Sharded2DGraph``: each hop's SpMM then runs through its
    placement's provider (the same answer, bit for bit)."""
    if not graph.has_csc:
        raise ValueError("reach uses the CSC transpose (pull sweeps)")
    bk = B.resolve(backend, graph.device)
    pl, ctx = B.resolve_graph_placement(graph, placement)
    with ctx:
        return _reach(graph, srcs, k, bk, pl, budget)


def _reach(graph, srcs, k, bk, pl, budget) -> ReachResult:
    spmm = B.dispatch("spmm", bk, pl)
    csc = B.storage_arg("spmm", bk, pl, graph=graph, side="csc")
    n = graph.num_vertices
    dev = graph.device
    srcs = torch.as_tensor(srcs, dtype=torch.int32, device=dev).reshape(-1)
    b = int(srcs.shape[0])
    r = torch.zeros((n, b), dtype=torch.float32, device=dev)
    r[srcs.long(), torch.arange(b, device=dev)] = 1.0
    k_eff = int(k) if budget is None else budget.cap_iters(int(k))
    for _ in range(k_eff):
        need = torch.amin(r, dim=1) < 1.0
        new = spmm(graph.csc_offsets, csc, None, r, SR.or_and,
                   graph.csc_ell_width, need, graph.csc_row_seg,
                   cache=graph.cache)
        r = torch.maximum(r, new)
    reached = r.T > 0
    return ReachResult(reached=reached,
                       counts=reached.sum(dim=1, dtype=torch.int32),
                       hops=k_eff, converged=k_eff >= int(k))


@B.draw_scope()
def reach(graph: Graph, src: int, k: int = 3, *,
          backend: Optional[str] = None) -> ReachResult:
    """Single-source k-hop reachability — a squeezed batch-of-1 call."""
    r = reach_batch(graph, [src], k, backend=backend)
    return ReachResult(reached=r.reached[0], counts=r.counts[0],
                       hops=r.hops, converged=r.converged)
