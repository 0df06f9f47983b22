"""Subgraph matching (paper §6.7), counterpart of
``repro.core.primitives.subgraph`` — the filtering-and-joining
procedure. Finds every embedding of a small connected query pattern:

  filter phase — the candidates of query vertex 0, pruned by degree (and
      an optional label): a stable compaction of the vertex ids
      (``frontier.compact_values``, K2 on the cuda backend);
  join phase   — query vertices are bound one at a time in BFS order;
      each extension LB-expands the neighbour list of one bound anchor
      (``operators.lb_expand``), probes every other bound anchor's
      adjacency through the ``"segment_search"`` op (K5, found mode, on
      the cuda backend), drops candidates equal to a bound vertex, and
      compacts the surviving (embedding, candidate) slots in slot order
      (the ``"compact"`` op again).

The partial-embedding table is a fixed-capacity (cap, n_q) buffer:
matches beyond ``cap`` are dropped and ``truncated`` is set.
Embeddings are ordered maps query → data vertex, so each undirected
match is found once per query automorphism (6 per triangle). The
expansion of one join step (Σ over partial embeddings of the anchor's
degree — about Σ deg² for a triangle) must fit int32.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from .. import backend as B
from ..frontier import compact_values_batch
from ..graph import Graph
from ..operators import INT32_MAX, lb_expand


class MatchResult(NamedTuple):
    embeddings: torch.Tensor   # (cap, n_q) int32, -1 padded
    count: int
    truncated: bool


def _bfs_order_ok(n_q: int, q_edges) -> bool:
    seen = {0}
    for k in range(1, n_q):
        if not any((a in seen) for a, b in q_edges if b == k) and \
           not any((b in seen) for a, b in q_edges if a == k):
            return False
        seen.add(k)
    return True


def subgraph_match(graph: Graph, n_q: int, q_edges: Sequence[tuple],
                   cap: int = 4096, labels=None,
                   q_labels: Optional[Sequence[int]] = None, *,
                   backend: Optional[str] = None) -> MatchResult:
    """Enumerate the embeddings of an undirected query pattern.

    ``q_edges``: (a, b) query edges over vertices 0..n_q-1, ordered so
    that every vertex k > 0 has an edge to an earlier one (BFS order).
    ``labels`` / ``q_labels``: optional vertex labels for the filter.
    The graph must hold both directions of every edge, with sorted
    neighbour lists (``from_edge_list`` guarantees it)."""
    if not _bfs_order_ok(n_q, q_edges):
        raise ValueError("query must be BFS-ordered")
    if cap < 1:
        raise ValueError("cap must be at least 1")
    bk = B.resolve(backend, graph.device)
    search = B.dispatch("segment_search", bk)
    q_edges = [(int(a), int(b)) for a, b in q_edges]
    qdeg = np.zeros(n_q, np.int32)
    for a, b in q_edges:
        qdeg[a] += 1
        qdeg[b] += 1
    dev = graph.device
    n = graph.num_vertices
    ro, ci = graph.row_offsets, graph.col_indices
    deg = graph.degrees
    use_labels = labels is not None and q_labels is not None
    if use_labels:
        labels = torch.as_tensor(labels, device=dev)

    # ---- filter phase: candidates of query vertex 0 ----------------------
    keep = deg >= int(qdeg[0])
    if use_labels:
        keep = keep & (labels == int(q_labels[0]))
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    cand0, _, totals = compact_values_batch(ids[None], keep[None], cap,
                                            backend=bk)
    truncated = int(totals[0]) > cap
    count = min(int(totals[0]), cap)
    emb = torch.full((cap, n_q), -1, dtype=torch.int32, device=dev)
    emb[:, 0] = cand0[0]
    del keep, ids, cand0

    # ---- join phase: bind query vertices 1..n_q-1 ------------------------
    for k in range(1, n_q):
        anchors = sorted({a for a, b in q_edges if b == k} |
                         {b for a, b in q_edges if a == k})
        anchors = [a for a in anchors if a < k]
        # the live partial embeddings (at least one lane, so the
        # expansion's gathers have a row to clamp to)
        rows = emb[:max(count, 1)]
        live = torch.arange(int(rows.shape[0]), device=dev) < count
        base = torch.where(live, rows[:, anchors[0]], 0)
        sizes = torch.where(live, torch.index_select(ro, 0, base + 1)
                            - torch.index_select(ro, 0, base), 0)
        cap_out = max(int(sizes.sum(dtype=torch.int64)), 1)
        if cap_out > INT32_MAX:
            raise ValueError(
                f"subgraph_match: a join step expands {cap_out:,} slots, "
                f"beyond int32")
        exp = lb_expand(sizes.to(torch.int32), live, cap_out)
        src_row = exp.in_pos
        eidx = torch.index_select(ro, 0, torch.index_select(base, 0, src_row))
        eidx = torch.where(exp.valid, eidx + exp.rank, 0)
        cand = torch.index_select(ci, 0, eidx) if int(ci.shape[0]) else (
            torch.zeros_like(eidx))
        ok = exp.valid & (torch.index_select(deg, 0, cand) >= int(qdeg[k]))
        del exp, eidx
        if use_labels:
            ok = ok & (torch.index_select(labels, 0, cand)
                       == int(q_labels[k]))
        # adjacency probes against the other bound anchors
        for a in anchors[1:]:
            av = torch.where(ok, torch.index_select(rows[:, a], 0, src_row),
                             0)
            lo = torch.index_select(ro, 0, av)
            hi = torch.index_select(ro, 0, av + 1)
            del av
            ok = ok & search(ci, lo, hi, cand)
            del lo, hi
        # distinctness: the candidate differs from every bound vertex
        for j in range(k):
            ok = ok & (cand != torch.index_select(rows[:, j].contiguous(), 0,
                                                  src_row))
        # compact the surviving (embedding, candidate) slots in order
        slots = torch.arange(cap_out, dtype=torch.int32, device=dev)
        sel, _, totals = compact_values_batch(slots[None], ok[None], cap,
                                              backend=bk)
        del ok, slots
        sel, raw = sel[0], int(totals[0])
        truncated = truncated or raw > cap
        count = min(raw, cap)
        sel = sel[:count]
        new_emb = torch.full((cap, n_q), -1, dtype=torch.int32, device=dev)
        new_emb[:count] = torch.index_select(
            rows, 0, torch.index_select(src_row, 0, sel))
        new_emb[:count, k] = torch.index_select(cand, 0, sel)
        emb = new_emb
        del src_row, cand, sel, rows, new_emb

    return MatchResult(embeddings=emb, count=count, truncated=truncated)


def subgraph_match_ref(graph: Graph, n_q: int, q_edges) -> int:
    """Brute-force oracle: the number of ordered embeddings (host
    Python, the reference's oracle; small graphs only)."""
    ro = graph.row_offsets.cpu().numpy()
    ci = graph.cols_np()
    n = len(ro) - 1
    adj = [set(ci[ro[u]:ro[u + 1]].tolist()) for u in range(n)]
    q_adj = [[] for _ in range(n_q)]
    for a, b in q_edges:
        q_adj[b].append(a)
        q_adj[a].append(b)
    count = 0
    stack = [(v,) for v in range(n)]
    while stack:
        partial = stack.pop()
        k = len(partial)
        if k == n_q:
            count += 1
            continue
        anchors = [a for a in q_adj[k] if a < k]
        cands = set(adj[partial[anchors[0]]]) if anchors else set(range(n))
        for a in anchors[1:]:
            cands &= adj[partial[a]]
        for c in cands:
            if c not in partial:
                stack.append(partial + (c,))
    return count
