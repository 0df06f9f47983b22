"""Gunrock's graph operators in PyTorch (counterpart of
``repro.core.operators``).

  advance        — neighbor expansion under one of the paper's
                   load-balancing strategies (Fig. 20): LB, an exclusive
                   scan of the frontier's degrees, then one sorted search
                   per output slot for (input lane, rank), then the CSR
                   gathers (registry ops "advance" / "advance_batch");
                   TWC, the same expansion over the lanes stably
                   reordered by size class (``twc_order``), ``in_pos``
                   mapped back; THREAD, the static per-vertex mapping: a
                   sweep of every CSR slot, kept where its source is in
                   the frontier. THREAD has no kernel in the reference on
                   any backend, so it runs plain PyTorch on both of the
                   port's backends.
  advance_filter — advance fused with the visited test, exact
                   first-occurrence culling (the smallest expansion slot
                   wins per destination) and compaction of the survivors
                   in ascending slot order. Registry ops
                   "advance_filter" / "advance_filter_batch".
  advance_pull   — pull over the CSC mirror: for every unvisited vertex,
                   the largest active in-neighbour (a segment max), which
                   is also the predecessor it records.
  filter_frontier — predicate + compaction ("compact"), with exact
                   (the LAST lane of each id survives) or hash (the
                   history table of §5.2.1: the last kept lane of a slot
                   owns it) uniquification; the batched form reports
                   the survivors the capacity clamp dropped.
  partition_frontier, neighborhood_reduce, compute — the two-way split,
                   advance + per-lane segmented reduction, per-item map.
  segmented_intersect — SmallLarge intersection of paired neighbour
                   lists: LB expansion of the smaller list, a bounded
                   binary search in the larger ("segment_search"),
                   compaction of the matches.
  scatter_*      — the atomic-replacement scatters; ``scatter_last`` is
                   the reference's scatter with duplicate targets, where
                   the largest slot's write stands.

The ``"torch"`` providers registered here are the plain twins of the
reference's ``xla`` providers, bit for bit, and the plain versions the
CUDA kernels are held against. The single-lane ops are batch-of-1 calls
of the batched ones, on both backends.

Functors see whole tensors: ``functor(src, dst, edge_id, rank, valid,
data) -> (keep, data)`` gets (B, cap) tensors from ``advance_batch`` and
(cap,) tensors from ``advance``; a filter functor is ``functor(ids,
valid, data) -> (keep, data)``.

Columns are read through the graph's storage plan: the traversal
providers take the column store (a dense array at any index dtype, or
the delta stream) and decode per touched edge (``storage.gather_cols``);
a provider that declared only ``"dense"`` gets the dense view through
``backend.storage_arg``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..analysis import sanitize
from . import backend as B
from . import storage as S
from .frontier import (INVALID, BatchedDenseFrontier, BatchedSparseFrontier,
                       DenseFrontier, SparseFrontier, _scatter_flags,
                       compact_values, compact_values_batch)
from .graph import Graph, row_segments_of

INT32_MIN = -2 ** 31
INT32_MAX = 2 ** 31 - 1


class Expansion(NamedTuple):
    in_pos: torch.Tensor   # (..., cap_out) input lane of each output slot
    rank: torch.Tensor     # (..., cap_out) index within that lane's segment
    valid: torch.Tensor    # (..., cap_out) bool
    total: torch.Tensor    # (...,) int32 true number of output items


def lb_scan(sizes: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The exclusive scan of ``sizes`` (B, cap_in) and its totals (B,),
    int32, saturating at INT32_MAX as the kernels' scan does: a frontier
    of duplicates can hold more slots than int32 counts (the reference's
    int32 scan wraps there), and every slot below INT32_MAX keeps its
    true lane."""
    incl = torch.cumsum(sizes, dim=1, dtype=torch.int64)
    offsets = (incl - sizes).clamp_(max=INT32_MAX).to(torch.int32)
    if sizes.shape[1]:
        total = incl[:, -1].clamp(max=INT32_MAX).to(torch.int32)
    else:
        total = torch.zeros((sizes.shape[0],), dtype=torch.int32,
                            device=sizes.device)
    return offsets, total


def lb_expand(sizes: torch.Tensor, valid_in: torch.Tensor,
              cap_out: int) -> Expansion:
    """Merge-based load-balanced expansion (paper §5.1.3): for each
    output slot, the input lane (sorted search of the exclusive degree
    scan) and the rank within its segment. ``sizes`` is (cap_in,) or
    (B, cap_in); every output carries the same leading shape."""
    sizes = torch.where(valid_in, sizes, 0).to(torch.int32)
    squeeze = sizes.dim() == 1
    if squeeze:
        sizes = sizes[None]
    b, cap_in = sizes.shape
    offsets, total = lb_scan(sizes)
    slots = torch.arange(cap_out, dtype=torch.int32, device=sizes.device)
    slots = slots[None, :].expand(b, cap_out).contiguous()
    in_pos = torch.searchsorted(offsets.contiguous(), slots, right=True,
                                out_int32=True) - 1
    in_pos = torch.clamp(in_pos, 0, max(cap_in - 1, 0))
    rank = slots - torch.gather(offsets, 1, in_pos.long())
    valid = slots < total[:, None]
    exp = Expansion(in_pos=in_pos, rank=rank, valid=valid,
                    total=total.to(torch.int32))
    return Expansion(*(t[0] for t in exp)) if squeeze else exp


@B.register("advance_batch", B.TORCH, encodings=("dense", "delta"))
def _advance_batch_torch(row_offsets: torch.Tensor, col_indices: S.ColStore,
                         base: torch.Tensor, sizes: torch.Tensor,
                         cap_out: int, cache=None):
    """Plain batched advance: LB sorted search + CSR gathers as separate
    passes. Returns (src, dst, edge_id, in_pos, rank, valid, totals),
    (B, cap_out) each and totals (B,); src/dst/edge_id are -1 and rank 0
    on dead slots, in_pos is left unmasked (the reference's contract).
    ``col_indices`` is the column store, decoded per touched edge with
    the expansion's own source as the delta row; ``cache`` is unused
    here (the kernel keeps its decoded views in it)."""
    del cache
    exp = lb_expand(sizes, torch.ones_like(sizes, dtype=torch.bool),
                    cap_out)
    src = torch.gather(base, 1, exp.in_pos.long())
    edge_id = row_offsets[src.long()] + exp.rank
    edge_id = torch.where(exp.valid, edge_id, 0)
    m = S.store_num_edges(col_indices)
    dst = S.gather_cols(col_indices, edge_id.clamp(0, max(m - 1, 0)), src)
    return (torch.where(exp.valid, src, INVALID),
            torch.where(exp.valid, dst, INVALID),
            torch.where(exp.valid, edge_id, INVALID), exp.in_pos,
            torch.where(exp.valid, exp.rank, 0), exp.valid, exp.total)


@B.register("advance", B.TORCH, encodings=("dense", "delta"))
def _advance_torch(row_offsets, col_indices, base, sizes, cap_out: int,
                   cache=None):
    """Single-lane "advance": a batch-of-1 ``_advance_batch_torch``."""
    out = _advance_batch_torch(row_offsets, col_indices, base[None],
                               sizes[None], cap_out, cache)
    return tuple(t[0] for t in out)


class AdvanceResult(NamedTuple):
    src: torch.Tensor      # (..., cap_out) int32 source of each slot
    dst: torch.Tensor      # (..., cap_out) int32 destination
    edge_id: torch.Tensor  # (..., cap_out) int32 CSR edge index
    in_pos: torch.Tensor   # (..., cap_out) int32 input lane of each slot
    valid: torch.Tensor    # (..., cap_out) bool
    total: torch.Tensor    # (...,) int32 valid outputs before the functor


def _base_and_sizes(graph: Graph, ids: torch.Tensor, valid: torch.Tensor,
                    input_kind: str):
    """Base vertex each input item expands, and its masked degree."""
    ids = torch.where(valid, ids, 0)
    if input_kind == "edge":
        # an edge item expands the neighbor list of its destination
        ids = S.gather_cols(graph.col_store, ids)
    elif input_kind != "vertex":
        raise ValueError(f"unknown input_kind {input_kind}")
    ro = graph.row_offsets
    deg = ro[ids.long() + 1] - ro[ids.long()]
    return ids, torch.where(valid, deg, 0).to(torch.int32)


def _apply_functor(res: AdvanceResult, rank, functor, data):
    if functor is None:
        return res, data
    keep, data = functor(res.src, res.dst, res.edge_id, rank, res.valid,
                         data)
    keep = keep & res.valid
    return AdvanceResult(src=torch.where(keep, res.src, INVALID),
                         dst=torch.where(keep, res.dst, INVALID),
                         edge_id=torch.where(keep, res.edge_id, INVALID),
                         in_pos=res.in_pos, valid=keep,
                         total=res.total), data


def twc_order(sizes: torch.Tensor) -> torch.Tensor:
    """TWC's size-class grouping (paper §5.1.2), as the reference emulates
    it: a stable sort of the lanes into ≤ 32 ("thread"), ≤ 256 ("warp")
    and larger ("block") segments, along the last axis (per lane of a
    batch). Returns the permutation, int64."""
    cls = torch.where(sizes <= 32, 0, torch.where(sizes <= 256, 1, 2))
    return torch.sort(cls.to(torch.int8), dim=-1, stable=True).indices


def _thread_expand(graph: Graph, ids: torch.Tensor, valid: torch.Tensor,
                   cap_out: int) -> AdvanceResult:
    """THREAD (ThreadExpand, §5.1.1): every CSR slot in order, live where
    its source is in the frontier, cut at ``cap_out`` (so the result has
    min(cap_out, m) slots); ``in_pos`` is the slot's source VERTEX and
    ``total`` counts the whole O(m) sweep. Plain PyTorch on every
    backend: the reference has no kernel for it either."""
    n, m = graph.num_vertices, graph.num_edges
    k = min(cap_out, m)
    flags = _scatter_flags(ids, valid, n)                  # (B, n)
    src_of = (graph.row_seg if graph.row_seg is not None
              else row_segments_of(graph.row_offsets))[:k]
    live = torch.index_select(flags, 1, src_of)            # (B, k)
    slot = torch.arange(k, dtype=torch.int32, device=ids.device)
    dst = S.gather_cols(graph.col_store, slot, src_of)
    total = torch.where(flags, graph.degrees[None, :], 0).sum(
        dim=1, dtype=torch.int32)
    return AdvanceResult(src=torch.where(live, src_of, INVALID),
                         dst=torch.where(live, dst, INVALID),
                         edge_id=torch.where(live, slot, INVALID),
                         in_pos=src_of.expand(live.shape), valid=live,
                         total=total)


def _expand(graph: Graph, ids: torch.Tensor, valid: torch.Tensor,
            cap_out: int, input_kind: str, strategy: str, bk: str):
    """The expansion of one frontier (``ids`` (cap,), the "advance" op)
    or of a batch ((B, cap), "advance_batch") under ``strategy`` →
    (AdvanceResult, rank), before any functor. THREAD is plain
    PyTorch."""
    if strategy == "THREAD":
        if input_kind != "vertex":
            raise ValueError("THREAD expands vertex frontiers only")
        if ids.dim() == 1:
            res = AdvanceResult(*(t[0] for t in _thread_expand(
                graph, ids[None], valid[None], cap_out)))
        else:
            res = _thread_expand(graph, ids, valid, cap_out)
        return res, torch.zeros_like(res.src)
    if strategy not in ("LB", "TWC"):
        raise ValueError(f"unknown strategy {strategy}")
    base, sizes = _base_and_sizes(graph, ids, valid, input_kind)
    order = None
    if strategy == "TWC":
        # expand the lanes grouped by size class, then map each slot's
        # lane back; K3's dead slots carry lane cap_in - 1, which maps
        # to order[cap_in - 1] as in the reference
        order = twc_order(sizes)
        base = torch.gather(base, -1, order)
        sizes = torch.gather(sizes, -1, order)
    op = "advance" if ids.dim() == 1 else "advance_batch"
    cols = B.storage_arg(op, bk, graph=graph)
    src, dst, edge_id, in_pos, rank, valid, total = B.dispatch(op, bk)(
        graph.row_offsets, cols, base, sizes, cap_out, graph.cache)
    if order is not None and order.shape[-1]:
        in_pos = torch.gather(order, -1, in_pos.long()).to(torch.int32)
    return AdvanceResult(src=src, dst=dst, edge_id=edge_id, in_pos=in_pos,
                         valid=valid, total=total), rank


def advance_batch(graph: Graph, frontier: BatchedSparseFrontier,
                  cap_out: int, functor: Optional[Callable] = None,
                  data=None, input_kind: str = "vertex",
                  strategy: str = "LB", *,
                  backend: Optional[str] = None
                  ) -> tuple[AdvanceResult, object]:
    """Multi-source push advance: expand B frontier lanes at once under
    ``strategy`` ("LB" | "TWC" | "THREAD"). Fields of the result are
    (B, cap_out) (THREAD: (B, min(cap_out, m))), ``total`` (B,)."""
    bk = B.resolve(backend, graph.device)
    res, rank = _expand(graph, frontier.ids, frontier.valid_mask, cap_out,
                        input_kind, strategy, bk)
    return _apply_functor(res, rank, functor, data)


def advance(graph: Graph, frontier: SparseFrontier, cap_out: int,
            functor: Optional[Callable] = None, data=None,
            input_kind: str = "vertex", strategy: str = "LB", *,
            backend: Optional[str] = None
            ) -> tuple[AdvanceResult, object]:
    """Gunrock advance (push) of one frontier, LB and TWC through the
    single-lane "advance" registry op."""
    bk = B.resolve(backend, graph.device)
    res, rank = _expand(graph, frontier.ids, frontier.valid_mask, cap_out,
                        input_kind, strategy, bk)
    return _apply_functor(res, rank, functor, data)


def frontier_workload(graph: Graph, frontier) -> torch.Tensor:
    """Upper bound on the advance output of ``frontier``: the sum of the
    out-degrees of its live vertices — (B,) for a batched frontier, ()
    for a single one."""
    _, sizes = _base_and_sizes(graph, frontier.ids, frontier.valid_mask,
                               "vertex")
    return sizes.sum(dim=-1, dtype=torch.int32)


@B.register("advance_filter_batch", B.TORCH, encodings=("dense", "delta"))
def _advance_filter_batch_torch(row_offsets, col_indices, base, sizes,
                                visited: torch.Tensor, cap_out: int,
                                cap_front: int, cache=None):
    """Plain fused advance→filter, the twin of the reference's
    ``_advance_filter_xla`` over a batch: LB expansion, the visited
    test, exact first-occurrence culling (min-slot winner per
    destination, so survivors stay in ascending slot order), compaction
    of (dst, src) into ``cap_front``. Returns (ids, srcs, lengths,
    totals). ``cache`` is unused here (the kernel keeps scratch in it)."""
    del cache
    src, dst, _, _, _, valid, _ = _advance_batch_torch(
        row_offsets, col_indices, base, sizes, cap_out)
    b, n = visited.shape
    safe = torch.where(valid, dst, 0).long()
    keep = valid & ~torch.gather(visited, 1, safe)
    lane = torch.arange(cap_out, dtype=torch.int32, device=dst.device)
    lane = lane[None, :].expand(b, cap_out)
    first = torch.full((b, n), cap_out, dtype=torch.int32,
                       device=dst.device)
    first.scatter_reduce_(1, safe, torch.where(keep, lane, cap_out),
                          "amin")
    keep = keep & (torch.gather(first, 1, safe) == lane)
    ids, lengths, _ = compact_values_batch(dst, keep, cap_front,
                                           backend=B.TORCH)
    srcs, _, _ = compact_values_batch(src, keep, cap_front,
                                      backend=B.TORCH)
    return ids, srcs, lengths, keep.sum(dim=1, dtype=torch.int32)


@B.register("advance_filter", B.TORCH, encodings=("dense", "delta"))
def _advance_filter_torch(row_offsets, col_indices, base, sizes, visited,
                          cap_out: int, cap_front: int, cache=None):
    """Single-lane "advance_filter": a batch-of-1 call."""
    out = _advance_filter_batch_torch(row_offsets, col_indices, base[None],
                                      sizes[None], visited[None], cap_out,
                                      cap_front, cache)
    return tuple(t[0] for t in out)


def advance_filter_batch(graph: Graph, frontier: BatchedSparseFrontier,
                         visited: torch.Tensor, cap_out: int,
                         cap_front: Optional[int] = None, *,
                         backend: Optional[str] = None
                         ) -> tuple[BatchedSparseFrontier, torch.Tensor,
                                    torch.Tensor]:
    """Multi-source fused advance→filter: expand, keep destinations whose
    ``visited`` (B, n) bit is clear, cull duplicates exactly (first
    discovering slot wins), compact. Returns ``(new_frontier, srcs,
    totals)``: the discovered frontier (capacity ``cap_front``), the
    discovering source of each survivor, and the pre-clamp counts."""
    bk = B.resolve(backend, graph.device)
    cap_front = frontier.capacity if cap_front is None else cap_front
    base, sizes = _base_and_sizes(graph, frontier.ids, frontier.valid_mask,
                                  "vertex")
    cols = B.storage_arg("advance_filter_batch", bk, graph=graph)
    ids, srcs, lengths, totals = B.dispatch("advance_filter_batch", bk)(
        graph.row_offsets, cols, base, sizes,
        visited.to(torch.bool), cap_out, cap_front, graph.cache)
    return BatchedSparseFrontier(ids=ids, lengths=lengths), srcs, totals


def advance_filter(graph: Graph, frontier: SparseFrontier,
                   visited: torch.Tensor, cap_out: int,
                   cap_front: Optional[int] = None, *,
                   backend: Optional[str] = None
                   ) -> tuple[SparseFrontier, torch.Tensor, torch.Tensor]:
    """Single-lane fused advance→filter through the "advance_filter"
    registry op; ``visited`` is (n,)."""
    bk = B.resolve(backend, graph.device)
    cap_front = frontier.capacity if cap_front is None else cap_front
    base, sizes = _base_and_sizes(graph, frontier.ids, frontier.valid_mask,
                                  "vertex")
    cols = B.storage_arg("advance_filter", bk, graph=graph)
    ids, srcs, length, total = B.dispatch("advance_filter", bk)(
        graph.row_offsets, cols, base, sizes,
        visited.to(torch.bool), cap_out, cap_front, graph.cache)
    return SparseFrontier(ids=ids, length=length), srcs, total


def advance_to_vertex_frontier_batch(res: AdvanceResult,
                                     cap: Optional[int] = None,
                                     backend: Optional[str] = None
                                     ) -> BatchedSparseFrontier:
    """Per-lane compaction of a batched advance's destinations."""
    cap = int(res.dst.shape[1]) if cap is None else cap
    buf, lengths, _ = compact_values_batch(res.dst, res.valid, cap,
                                           backend=backend)
    return BatchedSparseFrontier(ids=buf, lengths=lengths)


def advance_to_vertex_frontier(res: AdvanceResult,
                               cap: Optional[int] = None,
                               backend: Optional[str] = None
                               ) -> SparseFrontier:
    """Compact an advance result's destinations into a vertex frontier."""
    batched = AdvanceResult(*(t[None] for t in res))
    return advance_to_vertex_frontier_batch(batched, cap, backend).lane(0)


def advance_to_edge_frontier(res: AdvanceResult,
                             cap: Optional[int] = None,
                             backend: Optional[str] = None
                             ) -> SparseFrontier:
    """Compact a single advance result's edge ids into an edge frontier
    (an ``input_kind="edge"`` advance expands their destinations)."""
    cap = int(res.edge_id.shape[0]) if cap is None else cap
    buf, length = compact_values(res.edge_id, res.valid, cap,
                                 backend=backend)
    return SparseFrontier(ids=buf, length=length)


# ---------------------------------------------------------------------------
# filter (paper §4.2, §5.2.1)
# ---------------------------------------------------------------------------


def _uniquify_exact(ids: torch.Tensor, keep: torch.Tensor,
                    n: int) -> torch.Tensor:
    """One surviving lane per id along the last axis: the LAST kept lane
    of each id (the reference's max-lane scatter), so the survivors keep
    the order of their last occurrences."""
    lane = torch.arange(ids.shape[-1], dtype=torch.int32, device=ids.device)
    lane = lane.expand(ids.shape)
    safe = torch.where(keep, ids, 0).long()
    last = torch.full((*ids.shape[:-1], n), INVALID, dtype=torch.int32,
                      device=ids.device)
    last.scatter_reduce_(-1, safe, torch.where(keep, lane, INVALID), "amax")
    return keep & (torch.gather(last, -1, safe) == lane)


def _uniquify_hash(ids: torch.Tensor, keep: torch.Tensor,
                   hash_size: int) -> torch.Tensor:
    """Heuristic history-table culling (§5.2.1) along the last axis: a
    kept lane is culled when its table slot (id mod ``hash_size``) is
    owned by ANOTHER lane holding the same id. A slot's owner is its last
    kept lane — the reference's two ``.set`` scatters as XLA applies them
    on the CPU, in lane order — picked here by an explicit max, so the
    card gives the same owner; the owner's id is read from the owner's
    lane. Removes only some duplicates, never a valid item."""
    lane = torch.arange(ids.shape[-1], dtype=torch.int32, device=ids.device)
    lane = lane.expand(ids.shape)
    slot = torch.where(keep, torch.remainder(ids, hash_size),
                       hash_size).long()
    owner = torch.full((*ids.shape[:-1], hash_size + 1), INVALID,
                       dtype=torch.int32, device=ids.device)
    owner.scatter_reduce_(-1, slot, torch.where(keep, lane, INVALID),
                          "amax")
    own = torch.gather(owner, -1, slot)
    own_id = torch.gather(ids, -1, own.clamp(min=0).long())
    return keep & ~((own_id == ids) & (own != lane))


def _filter_keep(ids, valid, functor, data, n, uniquify, hash_size):
    keep = valid
    if functor is not None:
        fkeep, data = functor(ids, valid, data)
        keep = keep & fkeep
    if uniquify == "exact":
        if n is None:
            raise ValueError("exact uniquify needs the vertex count n")
        keep = _uniquify_exact(ids, keep, n)
    elif uniquify == "hash":
        keep = _uniquify_hash(ids, keep, hash_size)
    elif uniquify != "none":
        raise ValueError(f"unknown uniquify {uniquify!r}")
    return keep, data


def filter_frontier(frontier: SparseFrontier,
                    functor: Optional[Callable] = None, data=None,
                    n: Optional[int] = None, uniquify: str = "none",
                    cap: Optional[int] = None, hash_size: int = 1024,
                    backend: Optional[str] = None
                    ) -> tuple[SparseFrontier, object]:
    """Gunrock filter: predicate + compaction ("compact") +
    uniquification. ``functor(ids, valid, data) -> (keep, data)``;
    ``uniquify`` is 'none', 'exact' (one lane per id, needs ``n``) or
    'hash' (the heuristic history table of ``hash_size`` slots)."""
    keep, data = _filter_keep(frontier.ids, frontier.valid_mask, functor,
                              data, n, uniquify, hash_size)
    cap = frontier.capacity if cap is None else cap
    buf, length = compact_values(frontier.ids, keep, cap, backend=backend)
    return SparseFrontier(ids=buf, length=length), data


def filter_frontier_batch(frontier: BatchedSparseFrontier,
                          functor: Optional[Callable] = None, data=None,
                          n: Optional[int] = None, uniquify: str = "none",
                          cap: Optional[int] = None, hash_size: int = 1024,
                          backend: Optional[str] = None
                          ) -> tuple[BatchedSparseFrontier, object,
                                     torch.Tensor]:
    """Per-lane filter (the functor sees (B, cap) tensors) → (frontier,
    data, overflow): ``overflow`` (B,) counts the survivors the capacity
    clamp dropped — nonzero only when hash culling leaves more than
    ``cap`` duplicates, the sign that a capped run must not be trusted."""
    keep, data = _filter_keep(frontier.ids, frontier.valid_mask, functor,
                              data, n, uniquify, hash_size)
    cap = frontier.capacity if cap is None else cap
    buf, lengths, totals = compact_values_batch(frontier.ids, keep, cap,
                                                backend=backend)
    overflow = torch.clamp(totals - cap, min=0)
    return BatchedSparseFrontier(ids=buf, lengths=lengths), data, overflow


def partition_frontier(frontier: SparseFrontier, predicate: torch.Tensor,
                       cap_near: Optional[int] = None,
                       cap_far: Optional[int] = None,
                       backend: Optional[str] = None
                       ) -> tuple[SparseFrontier, SparseFrontier]:
    """Two-way split (the two-level priority queue, §5.1.5): items whose
    ``predicate`` holds go to the near pile, the others to the far one."""
    valid = frontier.valid_mask
    cap_near = frontier.capacity if cap_near is None else cap_near
    cap_far = frontier.capacity if cap_far is None else cap_far
    nbuf, nlen = compact_values(frontier.ids, valid & predicate, cap_near,
                                backend=backend)
    fbuf, flen = compact_values(frontier.ids, valid & ~predicate, cap_far,
                                backend=backend)
    return SparseFrontier(nbuf, nlen), SparseFrontier(fbuf, flen)


_REDUCE = {"add": ("sum", 0.0), "max": ("amax", float("-inf")),
           "min": ("amin", float("inf"))}


def neighborhood_reduce(graph: Graph, frontier: SparseFrontier,
                        cap_out: int, edge_map: Callable,
                        reduce_op: str = "add", init=None, data=None,
                        strategy: str = "LB",
                        backend: Optional[str] = None) -> torch.Tensor:
    """Advance + per-lane segmented reduction (paper §8.2.3):
    ``edge_map(src, dst, edge_id, valid, data)`` gives a value per slot,
    reduced by ``in_pos`` into (capacity,) values aligned with the input
    lanes. A lane with no live slot holds the reduction's identity (0,
    -inf, inf); ``init`` replaces it on the frontier's invalid lanes.
    Under THREAD ``in_pos`` is the source vertex, as in the reference,
    and slots whose vertex is no lane index are dropped. A float sum's
    order may differ from the reference's (its last bits)."""
    res, _ = advance(graph, frontier, cap_out, strategy=strategy,
                     backend=backend)
    vals = edge_map(res.src, res.dst, res.edge_id, res.valid, data)
    how, neutral = _REDUCE[reduce_op]
    neutral = torch.full((), neutral, dtype=vals.dtype, device=vals.device)
    vals = torch.where(res.valid, vals, neutral)
    cap = frontier.capacity
    seg = torch.where(res.in_pos < cap, res.in_pos, cap).long()
    out = neutral.expand(cap + 1).clone()
    if how == "sum":
        out.index_add_(0, seg, vals)
    else:
        out.scatter_reduce_(0, seg, vals, how)
    out = out[:cap]
    if init is not None:
        out = torch.where(frontier.valid_mask, out,
                          torch.as_tensor(init, dtype=out.dtype,
                                          device=out.device))
    return out


def compute(frontier: SparseFrontier, functor: Callable, data):
    """Per-item operation over a frontier (paper §3 'compute'):
    ``functor(ids, valid, data) -> data``, invalid lanes' ids read 0."""
    return functor(torch.where(frontier.valid_mask, frontier.ids, 0),
                   frontier.valid_mask, data)


def _long_seg(graph: Graph) -> torch.Tensor:
    """The CSC edge→row map as int64 (scatter's index type), built once
    per graph."""
    seg = graph.cache.get("csc_row_seg64")
    if seg is None:
        seg = (graph.csc_row_seg if graph.csc_row_seg is not None
               else row_segments_of(graph.csc_offsets)).long()
        graph.cache["csc_row_seg64"] = seg
        sanitize.note_setup()
    return seg


def advance_pull_batch(graph: Graph, unvisited: BatchedDenseFrontier,
                       current: BatchedDenseFrontier,
                       return_preds: bool = False):
    """Pull advance per lane (paper §5.1.4): for every vertex, the
    largest in-neighbour in the current frontier (a segment max over the
    CSC mirror; INT32_MIN where the vertex has no in-edges, -1 where
    none is active). The new frontier is the unvisited vertices with one.
    One sweep of the edge list per lane."""
    if not graph.has_csc:
        raise ValueError("pull advance requires a CSC mirror")
    n, m = graph.num_vertices, graph.num_edges
    b = current.flags.shape[0]
    # the sweep reads every CSC slot: the dense int32 view, decoded or
    # widened once per graph
    csc = S.dense_view(graph.csc_store, graph.cache)
    pred_active = torch.index_select(current.flags, 1, csc)
    pred_id = torch.where(pred_active, csc[None, :], -1)
    preds = torch.full((b, n), INT32_MIN, dtype=torch.int32,
                       device=csc.device)
    preds.scatter_reduce_(1, _long_seg(graph)[None, :].expand(b, m),
                          pred_id, "amax")
    new = BatchedDenseFrontier((preds >= 0) & unvisited.flags)
    return (new, preds) if return_preds else new


def advance_pull(graph: Graph, unvisited: DenseFrontier,
                 current: DenseFrontier, return_preds: bool = False):
    """Single-lane pull advance: a batch-of-1 ``advance_pull_batch``."""
    out = advance_pull_batch(graph, BatchedDenseFrontier(unvisited.flags[None]),
                             BatchedDenseFrontier(current.flags[None]),
                             return_preds=return_preds)
    if return_preds:
        return DenseFrontier(out[0].flags[0]), out[1][0]
    return DenseFrontier(out.flags[0])


# ---------------------------------------------------------------------------
# segmented intersection (paper §4.3)
# ---------------------------------------------------------------------------


def _searchsorted_segment(haystack: torch.Tensor, lo: torch.Tensor,
                          hi: torch.Tensor, needles: torch.Tensor,
                          iters: int = 32, locate: bool = False
                          ) -> torch.Tensor:
    """Bounded lower-bound search of ``needles[i]`` in the sorted
    ``haystack[lo[i]:hi[i])``, every lane ``iters`` steps; returns True
    where found — or, with ``locate=True``, the matched position (-1
    when absent). The SmallLarge probe (§4.3), the plain version of K5.
    ``lo`` and ``hi`` are offsets into the haystack. An empty haystack
    is never read: nothing is found in it."""
    lo = lo.to(torch.int32)
    hi = hi.to(torch.int32)
    m = int(haystack.shape[0])
    if m == 0:
        if locate:
            return torch.full_like(needles, -1, dtype=torch.int32)
        return torch.zeros_like(needles, dtype=torch.bool)
    lo_ = lo
    hi_ = hi
    for _ in range(iters):
        live = lo_ < hi_
        mid = lo_ + ((hi_ - lo_) >> 1)
        mid_val = torch.index_select(haystack, 0, mid.clamp(0, m - 1))
        go_right = mid_val < needles
        lo_ = torch.where(go_right & live, mid + 1, lo_)
        hi_ = torch.where(~go_right & live, mid, hi_)
    found = (lo_ < hi) & (torch.index_select(
        haystack, 0, lo_.clamp(0, m - 1)) == needles)
    if locate:
        return torch.where(found, lo_, -1).to(torch.int32)
    return found


@B.register("segment_search", B.TORCH)
def _segment_search_torch(haystack, lo, hi, needles) -> torch.Tensor:
    """found[i] = needles[i] in sorted haystack[lo[i]:hi[i]) (bool)."""
    return _searchsorted_segment(haystack, lo, hi, needles)


def _segment_locate_torch(haystack, lo, hi, needles) -> torch.Tensor:
    """Position of needles[i] in haystack[lo[i]:hi[i]), -1 when absent
    (int32) — the probe of the semiring SpGEMM (``linalg.mxm``)."""
    return _searchsorted_segment(haystack, lo, hi, needles, locate=True)


class IntersectResult(NamedTuple):
    items: torch.Tensor    # (cap_out,) intersected vertex ids (compacted)
    pair_of: torch.Tensor  # (cap_out,) which input pair produced the item
    length: torch.Tensor   # () int32
    counts: torch.Tensor   # (cap_in,) per-pair intersection sizes
    total: torch.Tensor    # () int32 global intersection count


def _intersect_probes(graph: Graph, fa: SparseFrontier, fb: SparseFrontier,
                      cap_out: int, bk: str):
    """The probes of a segmented intersection: the smaller list of each
    pair expanded (LB, "advance"), each element to be searched in the
    larger one. Returns (needles, lo, hi, pair, valid), (cap_out,) each:
    ``haystack[lo:hi)`` is the larger endpoint's neighbour list."""
    valid_pair = fa.valid_mask & fb.valid_mask
    a = torch.where(valid_pair, fa.ids, 0)
    b = torch.where(valid_pair, fb.ids, 0)
    ro = graph.row_offsets
    deg_a = ro[a.long() + 1] - ro[a.long()]
    deg_b = ro[b.long() + 1] - ro[b.long()]
    a_small = deg_a <= deg_b
    small = torch.where(a_small, a, b)
    large = torch.where(a_small, b, a)
    sizes = torch.where(valid_pair, torch.where(a_small, deg_a, deg_b),
                        0).to(torch.int32)
    # fused expansion: dst of the small-side advance IS the probe needle
    _, needles, _, pair, _, valid, _ = B.dispatch("advance", bk)(
        ro, B.storage_arg("advance", bk, graph=graph), small, sizes, cap_out,
        graph.cache)
    l_vert = torch.index_select(large, 0, pair)
    lo = torch.index_select(ro, 0, l_vert)
    hi = torch.index_select(ro, 0, l_vert + 1)
    return needles, lo, hi, pair, valid


def segmented_intersect(graph: Graph, fa: SparseFrontier,
                        fb: SparseFrontier, cap_out: int, *,
                        backend: Optional[str] = None) -> IntersectResult:
    """Intersect the neighbour lists of paired items of two frontiers
    (sorted adjacency lists, as ``from_edge_list`` builds them).

    SmallLarge: expand the *smaller* list of each pair (LB, "advance"),
    binary-search each element in the larger list ("segment_search"),
    compact the matches ("compact"). An edgeless graph runs the same
    providers: the kernels take m = 0, and the search reads nothing."""
    bk = B.resolve(backend, graph.device)
    needles, lo, hi, pair, valid = _intersect_probes(graph, fa, fb,
                                                     cap_out, bk)
    # the probe searches column values in place: a dense store at its
    # index dtype, or the decoded view of a delta one
    found = B.dispatch("segment_search", bk)(
        B.storage_arg("segment_search", bk, graph=graph), lo, hi, needles)
    found = found & valid
    counts = torch.zeros((fa.capacity,), dtype=torch.int32,
                         device=graph.device)
    counts.index_add_(0, pair, found.to(torch.int32))
    items, length = compact_values(needles, found, cap_out, backend=bk)
    pair_c, _ = compact_values(pair, found, cap_out, backend=bk)
    return IntersectResult(items=items, pair_of=pair_c, length=length,
                           counts=counts,
                           total=counts.sum(dtype=torch.int32))


def _safe_index(index: torch.Tensor, valid: torch.Tensor,
                size: int) -> torch.Tensor:
    """``index`` where valid; dead lanes aim at spread-out slots (their
    value is the reduction's identity there). Sending every dead lane to
    one slot, as the reference does, makes that slot's atomics serialize
    on the card."""
    spread = torch.arange(index.shape[-1], device=index.device) % size
    return torch.where(valid, index.long(), spread)


def scatter_min(values: torch.Tensor, index: torch.Tensor,
                valid: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """atomicMin replacement: min-merge ``values`` into ``target`` at
    ``index`` along the last axis (order-independent)."""
    safe = _safe_index(index, valid, target.shape[-1])
    if target.dtype.is_floating_point:
        big = float("inf")
    else:
        big = torch.iinfo(target.dtype).max
    vals = torch.where(valid, values, torch.full((), big, dtype=target.dtype,
                                                 device=target.device))
    return target.scatter_reduce(-1, safe, vals, "amin")


def scatter_add(values: torch.Tensor, index: torch.Tensor,
                valid: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """atomicAdd replacement along the last axis."""
    safe = _safe_index(index, valid, target.shape[-1])
    vals = torch.where(valid, values, torch.zeros((), dtype=target.dtype,
                                                  device=target.device))
    return target.scatter_add(-1, safe, vals)


def scatter_or(index: torch.Tensor, valid: torch.Tensor,
               target: torch.Tensor) -> torch.Tensor:
    """Idempotent visited-bit set along the last axis."""
    safe = _safe_index(index, valid, target.shape[-1])
    out = target.to(torch.int32).scatter_reduce(-1, safe,
                                                valid.to(torch.int32),
                                                "amax")
    return out.to(target.dtype)


def scatter_last(values: torch.Tensor, index: torch.Tensor,
                 valid: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """``target[..., index[j]] = values[j]`` for every valid slot j along
    the last axis; where several slots hit one target the LARGEST slot's
    write stands — the reference's ``.at[].set`` with duplicate indices,
    which XLA applies in slot order on the CPU. Picked by an explicit max,
    so the card gives the same winner."""
    n = target.shape[-1]
    if index.shape[-1] == 0:
        return target
    slot = torch.arange(index.shape[-1], dtype=torch.int32,
                        device=index.device)
    last = torch.full(target.shape, -1, dtype=torch.int32,
                      device=index.device)
    last.scatter_reduce_(-1, _safe_index(index, valid, n),
                         torch.where(valid, slot, -1), "amax")
    won = torch.gather(values, -1, last.clamp(min=0).long())
    return torch.where(last >= 0, won.to(target.dtype), target)
