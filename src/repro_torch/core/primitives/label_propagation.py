"""Label-propagation community detection (counterpart of
``repro.core.primitives.label_propagation``) — an algebraic primitive.

Synchronous LP: every vertex adopts the most frequent label among its
out-neighbours (ties → smallest label, no votes → keep). One iteration
is a plus-times SpMM against the one-hot label matrix followed by a
max-argmax row reduction under the ⟨max count, min label⟩ merge. The
label space is swept in blocks of ``block`` columns: each block is one
SpMM through the ``"spmm"`` registry op (one launch of K4m on the cuda
backend), and blocks merge into a running (best count, best label)
pair, so memory stays O(n·block) while all L labels are covered.

Cost: m·L/block gathers of ``block`` floats per iteration over a label
domain of L — m·n products with the default ``labels0 = arange(n)``;
communities collapse the active labels quickly, but every block is
swept, as in the reference. The loop runs through ``enactor.run_until``
with one host read per iteration (the changed-label count).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ...linalg import semiring as SR
from .. import backend as B
from ..enactor import run_until
from ..graph import Graph


class LPResult(NamedTuple):
    labels: torch.Tensor     # (n,) int32 community labels
    iterations: int


@B.draw_scope()
def label_propagation(graph: Graph, *, labels0=None,
                      num_labels: Optional[int] = None,
                      max_iter: int = 30, block: Optional[int] = None,
                      backend: Optional[str] = None,
                      placement: Optional[str] = None) -> LPResult:
    """Synchronous LP until the labelling is stable (or ``max_iter``).

    ``labels0`` defaults to every vertex its own community
    (``arange(n)``); ``num_labels`` bounds the label domain (default n)
    and ``block`` the SpMM column-block width (default min(32, L)).
    Labels spread along out-neighbours; pass an undirected graph for
    community detection. ``graph`` may be a ``ShardedGraph`` /
    ``Sharded2DGraph``: the one-hot SpMM blocks then run through its
    placement's provider, and the labels equal the single-device run's.
    """
    bk = B.resolve(backend, graph.device)
    pl, ctx = B.resolve_graph_placement(graph, placement)
    with ctx:
        return _label_propagation(graph, labels0, num_labels, max_iter,
                                  block, bk, pl)


def _label_propagation(graph, labels0, num_labels, max_iter, block, bk,
                       pl) -> LPResult:
    spmm = B.dispatch("spmm", bk, pl)
    cols_store = B.storage_arg("spmm", bk, pl, graph=graph)
    n = graph.num_vertices
    dev = graph.device
    if labels0 is None:
        labels0 = torch.arange(n, dtype=torch.int32, device=dev)
    else:
        labels0 = torch.as_tensor(labels0, dtype=torch.int32, device=dev)
    num_labels = n if num_labels is None else int(num_labels)
    block = max(1, min(32, num_labels)) if block is None else int(block)
    nblk = -(-num_labels // block)
    lanes = torch.arange(block, dtype=torch.int32, device=dev)

    def body(state):
        labels, _ = state
        best = torch.zeros((n,), dtype=torch.float32, device=dev)
        bestl = labels
        for i in range(nblk):
            cols = i * block + lanes
            onehot = (labels[:, None] == cols[None, :]).to(torch.float32)
            # votes[v, j] = number of v's neighbours labelled cols[j]
            votes = spmm(graph.row_offsets, cols_store, None, onehot,
                         SR.plus_times, graph.ell_width, None,
                         graph.row_seg, cache=graph.cache)
            # torch.argmax documents the first maximum: the min label
            arg = torch.argmax(votes, dim=1)
            bs = torch.gather(votes, 1, arg[:, None])[:, 0]
            bl = torch.index_select(cols, 0, arg)
            # ⟨max, min⟩ merge: a higher count wins, an equal count goes to
            # the smaller label; zero-vote candidates never displace
            take = (bs > best) | ((bs == best) & (bs > 0) & (bl < bestl))
            best = torch.where(take, bs, best)
            bestl = torch.where(take, bl, bestl)
        changed = (bestl != labels).sum(dtype=torch.int32)
        return bestl, changed

    state = (labels0, torch.ones((), dtype=torch.int32, device=dev))
    (labels, _), iters = run_until(lambda st: st[1] > 0, body, state,
                                   max_iter=max_iter)
    return LPResult(labels=labels, iterations=iters)
