"""Host-side oracles of the primitives (counterpart of
``repro.core.ref.ref_graph``), independent of the code under test and
vectorised so that they finish at the card's sizes (rmat scale 22; the
reference's own TC/CC/BC/LP/SALSA oracles loop in Python):

  bfs_ref      — level-synchronous BFS hop counts in vectorized numpy;
  sssp_ref     — scipy's Dijkstra (float64, cast to float32; the graph's
                 integer weights keep every distance exact);
  pagerank_ref — float64 power iteration over a scipy sparse matrix;
  cc_ref       — scipy's connected components, each labelled by its
                 smallest vertex id (what hooking to the min converges
                 to);
  bc_ref       — level-synchronous Brandes in numpy, float64;
  tc_ref       — row-chunked scipy products over the oriented adjacency;
  reach_ref    — BFS depth within [0, k];
  label_propagation_ref — synchronous LP with a sort-based per-vertex
                 mode (the reference counts every label of every vertex,
                 O(n²) per iteration); also returns the sweep count;
  ppr_ref      — float64 personalized PageRank: the reference's
                 ``np.add.at`` becomes a scipy product of Aᵀ (the CSR
                 arrays read as a CSC matrix), which scatters the edges in
                 the same ascending order, so the sums are the same bits;
  salsa_ref    — float64 SALSA over the hubs' out-edges with
                 ``np.bincount(weights=)``, again the add.at order.

The semantics are the reference's: -1 / inf for unreachable vertices,
dangling mass redistributed uniformly. ``PR_RTOL`` is the PageRank
check both the CLI and ``chip_smoke.py`` apply.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
from scipy.sparse import csgraph


# PageRank (float32) against the float64 oracle, per vertex relative:
# float32 folds of up to ~1.6e5 in-edges drift by ~1e-6..1e-5. Ranks
# average 1/n (2.4e-7 at rmat scale 22), so an absolute limit of 1e-6
# would pass almost any vector.
PR_RTOL = 1e-4


def _csr(graph):
    ro = graph.row_offsets.cpu().numpy().astype(np.int64)
    ci = graph.cols_np().astype(np.int64)
    w = (None if graph.edge_values is None
         else graph.edge_values.float().cpu().numpy().astype(np.float64))
    return ro, ci, w


def _out_edges(ro, ci, frontier):
    """(u, v) of every out-edge of the vertices in ``frontier``."""
    starts = ro[frontier]
    lens = ro[frontier + 1] - starts
    pos = np.repeat(starts - np.cumsum(lens) + lens, lens) + np.arange(
        lens.sum())
    return np.repeat(frontier, lens), ci[pos]


def _unreached(n: int, v: np.ndarray, depth: np.ndarray) -> np.ndarray:
    """The distinct ids among ``v`` with no depth yet, ascending — the set
    ``np.unique`` would give, by an (n,) mask instead of a sort of every
    edge of the level."""
    mask = np.zeros(n, dtype=bool)
    mask[v] = True
    mask &= depth < 0
    return np.flatnonzero(mask)


def bfs_ref(graph, src: int) -> np.ndarray:
    """Breadth-first search depths (-1 = unreachable)."""
    ro, ci, _ = _csr(graph)
    n = len(ro) - 1
    depth = np.full(n, -1, dtype=np.int32)
    depth[src] = 0
    frontier = np.array([src], dtype=np.int64)
    d = 0
    while len(frontier):
        d += 1
        nbrs = _unreached(n, _out_edges(ro, ci, frontier)[1], depth)
        depth[nbrs] = d
        frontier = nbrs
    return depth


def sssp_ref(graph, srcs) -> np.ndarray:
    """Dijkstra distances from each of ``srcs`` (an int or a list),
    float32, inf = unreachable; (n,) for an int, (len(srcs), n) else."""
    ro, ci, w = _csr(graph)
    if w is None:
        raise ValueError("sssp needs edge weights")
    n = len(ro) - 1
    a = sp.csr_matrix((w, ci, ro), shape=(n, n))
    dist = csgraph.dijkstra(a, directed=True, indices=srcs)
    return dist.astype(np.float32)


def pagerank_ref(graph, damping: float = 0.85, iters: int = 20
                 ) -> np.ndarray:
    """Power-iteration PageRank with uniform teleport (float64)."""
    ro, ci, _ = _csr(graph)
    n = len(ro) - 1
    deg = np.diff(ro)
    at = sp.csc_matrix((np.ones(len(ci)), ci, ro), shape=(n, n))   # Aᵀ
    pr = np.full(n, 1.0 / n)
    for _ in range(iters):
        contrib = np.where(deg > 0, pr / np.maximum(deg, 1), 0.0)
        dangling = pr[deg == 0].sum() / n
        pr = (1 - damping) / n + damping * (at @ contrib + dangling)
    return pr.astype(np.float32)


def pagerank_rel_err(rank, want) -> float:
    """Largest per-vertex |rank - want| / want (``want`` from
    :func:`pagerank_ref`, every entry > 0); inf for a rank vector of the
    wrong shape or with a non-finite entry."""
    rank = np.asarray(rank, np.float64)
    want = np.asarray(want, np.float64)
    if rank.shape != want.shape or not np.isfinite(rank).all():
        return float("inf")
    return float((np.abs(rank - want) / want).max()) if len(want) else 0.0


def cc_ref(graph) -> np.ndarray:
    """Connected-component labels: each vertex's label is the smallest
    vertex id of its (weakly connected) component."""
    ro, ci, _ = _csr(graph)
    n = len(ro) - 1
    a = sp.csr_matrix((np.ones(len(ci), np.int8), ci, ro), shape=(n, n))
    _, comp = csgraph.connected_components(a, directed=True,
                                           connection="weak")
    first = np.full(comp.max() + 1 if n else 0, n, dtype=np.int64)
    np.minimum.at(first, comp, np.arange(n))
    return first[comp].astype(np.int32)


def bc_ref(graph, src: int) -> np.ndarray:
    """Brandes dependencies of every vertex for one source (float64,
    cast to float32): level-synchronous sigma accumulation, then the
    levels in reverse; the source's own entry is 0."""
    ro, ci, _ = _csr(graph)
    n = len(ro) - 1
    depth = np.full(n, -1, dtype=np.int64)
    depth[src] = 0
    sigma = np.zeros(n)
    sigma[src] = 1.0
    levels = [np.array([src], dtype=np.int64)]
    while True:
        d = len(levels)
        u, v = _out_edges(ro, ci, levels[-1])
        new = _unreached(n, v, depth)
        depth[new] = d
        tree = depth[v] == d
        sigma += np.bincount(v[tree], weights=sigma[u[tree]], minlength=n)
        if not len(new):
            break
        levels.append(new)
    delta = np.zeros(n)
    for front in reversed(levels):
        u, v = _out_edges(ro, ci, front)
        tree = (depth[v] == depth[u] + 1) & (sigma[v] > 0)
        u, v = u[tree], v[tree]
        delta += np.bincount(u, weights=sigma[u] / sigma[v] * (1 + delta[v]),
                             minlength=n)
    delta[src] = 0.0
    return delta.astype(np.float32)


def tc_ref(graph, rows_per_chunk: int = 1 << 14) -> int:
    """Exact triangle count of an undirected graph: orient each edge from
    the higher (degree, id) endpoint to the lower, then count, for every
    oriented edge (u, v), the common out-neighbours of u and v —
    ``(A'[rows] @ A'ᵀ) ∘ A'[rows]`` summed, in row chunks."""
    ro, ci, _ = _csr(graph)
    n = len(ro) - 1
    deg = np.diff(ro)
    src = np.repeat(np.arange(n), deg)
    keep = (deg[src] > deg[ci]) | ((deg[src] == deg[ci]) & (src > ci))
    a = sp.csr_matrix((np.ones(int(keep.sum(dtype=np.int64)), np.int64),
                       (src[keep], ci[keep])), shape=(n, n))
    at = a.T.tocsr()
    total = 0
    for lo in range(0, n, rows_per_chunk):
        rows = a[lo:lo + rows_per_chunk]
        total += int((rows @ at).multiply(rows).sum())
    return total


def reach_ref(graph, src: int, k: int) -> np.ndarray:
    """k-hop reachability: BFS depth within [0, k]."""
    depth = bfs_ref(graph, src)
    return (depth >= 0) & (depth <= k)


def label_propagation_ref(graph, max_iter: int = 30, labels=None
                          ) -> tuple[np.ndarray, int]:
    """Synchronous label propagation, the device rule: every vertex with
    out-neighbours adopts their most frequent label (ties → smallest),
    all at once, until a sweep changes nothing or ``max_iter`` sweeps.
    Returns (labels int32, sweeps run — the one that changed nothing
    included, as the device loop counts it)."""
    ro, ci, _ = _csr(graph)
    n = len(ro) - 1
    lab = (np.arange(n, dtype=np.int64) if labels is None
           else np.asarray(labels, np.int64).copy())
    src = np.repeat(np.arange(n, dtype=np.int64), np.diff(ro))
    sweeps = 0
    for sweeps in range(1, max_iter + 1):
        new = lab.copy()
        if len(ci):
            span = int(lab.max()) + 1
            # (vertex, neighbour label) keys, sorted: one run per pair
            key = np.sort(src * span + lab[ci])
            head = np.flatnonzero(np.r_[True, key[1:] != key[:-1]])
            votes = np.diff(np.r_[head, len(key)])
            u, lbl = key[head] // span, key[head] % span
            # per vertex (runs ascending by label): the first largest
            first = np.flatnonzero(np.r_[True, u[1:] != u[:-1]])
            best = np.maximum.reduceat(votes, first)
            top = votes == np.repeat(best, np.diff(np.r_[first,
                                                        len(votes)]))
            cand = np.flatnonzero(top)
            pick = cand[np.r_[True, u[cand][1:] != u[cand][:-1]]]
            new[u[pick]] = lbl[pick]
        if np.array_equal(new, lab):
            break
        lab = new
    else:
        sweeps = max_iter
    return lab.astype(np.int32), sweeps


def ppr_ref(graph, src: int, damping: float = 0.85,
            iters: int = 30) -> np.ndarray:
    """Personalized PageRank with teleport to ``src`` (float64, cast to
    float32)."""
    ro, ci, _ = _csr(graph)
    n = len(ro) - 1
    deg = np.diff(ro)
    at = sp.csc_matrix((np.ones(len(ci)), ci, ro), shape=(n, n))   # Aᵀ
    pr = np.zeros(n)
    pr[src] = 1.0
    for _ in range(iters):
        contrib = np.where(deg > 0, pr / np.maximum(deg, 1), 0.0)
        nxt = at @ contrib
        dangling = pr[deg == 0].sum()
        new = damping * nxt
        new[src] += (1 - damping) + damping * dangling
        pr = new
    return pr.astype(np.float32)


def salsa_ref(graph, hubs: np.ndarray, iters: int = 10):
    """Bipartite SALSA on the subgraph of ``hubs`` (a bool mask over the
    vertices) and their out-neighbours. Returns (hub_scores,
    auth_scores), float32."""
    ro, ci, _ = _csr(graph)
    n = len(ro) - 1
    hubs = np.asarray(hubs, dtype=bool)
    src = np.repeat(np.arange(n, dtype=np.int64), np.diff(ro))
    live = hubs[src]
    e_hub, e_auth = src[live], ci[live]
    if not len(e_hub):
        return np.zeros(n, np.float32), np.zeros(n, np.float32)
    hub_deg = np.bincount(e_hub, minlength=n).astype(np.float64)
    auth_deg = np.bincount(e_auth, minlength=n).astype(np.float64)
    h = hubs / max(hubs.sum(dtype=np.int64), 1)
    a = np.zeros(n)
    for _ in range(iters):
        contrib = np.where(hub_deg > 0, h / np.maximum(hub_deg, 1), 0.0)
        a = np.bincount(e_auth, weights=contrib[e_hub], minlength=n)
        contrib = np.where(auth_deg > 0, a / np.maximum(auth_deg, 1), 0.0)
        h = np.bincount(e_hub, weights=contrib[e_auth], minlength=n)
    return h.astype(np.float32), a.astype(np.float32)
