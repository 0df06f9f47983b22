"""Host-side oracles for BFS, SSSP and PageRank (counterpart of
``repro.core.ref.ref_graph``), fast enough for rmat scale 22:

  bfs_ref      — level-synchronous BFS hop counts in vectorized numpy;
  sssp_ref     — scipy's Dijkstra (float64, cast to float32; the graph's
                 integer weights keep every distance exact);
  pagerank_ref — float64 power iteration over a scipy sparse matrix.

The semantics are the reference's: -1 / inf for unreachable vertices,
dangling mass redistributed uniformly.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
from scipy.sparse import csgraph


def _csr(graph):
    ro = graph.row_offsets.cpu().numpy().astype(np.int64)
    ci = graph.col_indices.cpu().numpy().astype(np.int64)
    w = (None if graph.edge_values is None
         else graph.edge_values.cpu().numpy().astype(np.float64))
    return ro, ci, w


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
        starts, ends = ro[frontier], ro[frontier + 1]
        lens = ends - starts
        pos = np.repeat(starts - np.cumsum(lens) + lens, lens) + np.arange(
            lens.sum())
        nbrs = np.unique(ci[pos])
        nbrs = nbrs[depth[nbrs] < 0]
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
    at = sp.csr_matrix((np.ones(len(ci)), ci, ro), shape=(n, n)).T.tocsr()
    pr = np.full(n, 1.0 / n)
    for _ in range(iters):
        contrib = np.where(deg > 0, pr / np.maximum(deg, 1), 0.0)
        dangling = pr[deg == 0].sum() / n
        pr = (1 - damping) / n + damping * (at @ contrib + dangling)
    return pr.astype(np.float32)
