"""Gunrock's graph operators in PyTorch (counterpart of
``repro.core.operators``, the main-path subset).

  advance        — load-balanced (LB) neighbor expansion: exclusive scan
                   of the frontier's degrees, then one sorted search per
                   output slot for (input lane, rank), then the CSR
                   gathers. Registry ops "advance" / "advance_batch".
  advance_filter — advance fused with the visited test, exact
                   first-occurrence culling (the smallest expansion slot
                   wins per destination) and compaction of the survivors
                   in ascending slot order. Registry ops
                   "advance_filter" / "advance_filter_batch".
  advance_pull   — pull over the CSC mirror: for every unvisited vertex,
                   the largest active in-neighbour (a segment max), which
                   is also the predecessor it records.
  segmented_intersect — SmallLarge intersection of paired neighbour
                   lists: LB expansion of the smaller list, a bounded
                   binary search in the larger ("segment_search"),
                   compaction of the matches.
  scatter_*      — the atomic-replacement scatters.

The ``"torch"`` providers registered here are the plain twins of the
reference's ``xla`` providers, bit for bit, and the plain versions the
CUDA kernels are held against. The single-lane ops are batch-of-1 calls
of the batched ones, on both backends.

Functors see whole tensors: ``functor(src, dst, edge_id, rank, valid,
data) -> (keep, data)`` gets (B, cap) tensors from ``advance_batch`` and
(cap,) tensors from ``advance``. Only the LB strategy is ported; TWC and
THREAD (the paper's Fig. 20 ablation) come with a later slice.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from . import backend as B
from .frontier import (INVALID, BatchedDenseFrontier, BatchedSparseFrontier,
                       DenseFrontier, SparseFrontier, compact_values,
                       compact_values_batch)
from .graph import Graph, row_segments_of

INT32_MIN = -2 ** 31
INT32_MAX = 2 ** 31 - 1


def _strategy(strategy: str) -> None:
    if strategy in ("TWC", "THREAD"):
        raise NotImplementedError(
            f"strategy={strategy!r} (the load-balancing ablation) is not "
            f"ported yet; it comes with a later slice of the port — use "
            f"strategy='LB'")
    if strategy != "LB":
        raise ValueError(f"unknown strategy {strategy}")


class Expansion(NamedTuple):
    in_pos: torch.Tensor   # (..., cap_out) input lane of each output slot
    rank: torch.Tensor     # (..., cap_out) index within that lane's segment
    valid: torch.Tensor    # (..., cap_out) bool
    total: torch.Tensor    # (...,) int32 true number of output items


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
    offsets = torch.cumsum(sizes, dim=1, dtype=torch.int32) - sizes
    if cap_in:
        total = offsets[:, -1] + sizes[:, -1]
    else:
        total = torch.zeros((b,), dtype=torch.int32, device=sizes.device)
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


@B.register("advance_batch", B.TORCH)
def _advance_batch_torch(row_offsets: torch.Tensor, col_indices: torch.Tensor,
                         base: torch.Tensor, sizes: torch.Tensor,
                         cap_out: int):
    """Plain batched advance: LB sorted search + CSR gathers as separate
    passes. Returns (src, dst, edge_id, in_pos, rank, valid, totals),
    (B, cap_out) each and totals (B,); src/dst/edge_id are -1 and rank 0
    on dead slots, in_pos is left unmasked (the reference's contract)."""
    exp = lb_expand(sizes, torch.ones_like(sizes, dtype=torch.bool),
                    cap_out)
    src = torch.gather(base, 1, exp.in_pos.long())
    edge_id = row_offsets[src.long()] + exp.rank
    edge_id = torch.where(exp.valid, edge_id, 0)
    m = col_indices.shape[0]
    dst = col_indices[edge_id.clamp(0, max(m - 1, 0)).long()] if m else (
        torch.zeros_like(edge_id))
    return (torch.where(exp.valid, src, INVALID),
            torch.where(exp.valid, dst, INVALID),
            torch.where(exp.valid, edge_id, INVALID), exp.in_pos,
            torch.where(exp.valid, exp.rank, 0), exp.valid, exp.total)


@B.register("advance", B.TORCH)
def _advance_torch(row_offsets, col_indices, base, sizes, cap_out: int):
    """Single-lane "advance": a batch-of-1 ``_advance_batch_torch``."""
    out = _advance_batch_torch(row_offsets, col_indices, base[None],
                               sizes[None], cap_out)
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
        ids = graph.col_indices[ids.long()]
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


def advance_batch(graph: Graph, frontier: BatchedSparseFrontier,
                  cap_out: int, functor: Optional[Callable] = None,
                  data=None, input_kind: str = "vertex",
                  strategy: str = "LB", *,
                  backend: Optional[str] = None
                  ) -> tuple[AdvanceResult, object]:
    """Multi-source push advance: expand B frontier lanes at once.
    Fields of the result are (B, cap_out), ``total`` (B,)."""
    _strategy(strategy)
    bk = B.resolve(backend, graph.device)
    base, sizes = _base_and_sizes(graph, frontier.ids, frontier.valid_mask,
                                  input_kind)
    src, dst, edge_id, in_pos, rank, valid, total = B.dispatch(
        "advance_batch", bk)(graph.row_offsets, graph.col_indices, base,
                             sizes, cap_out)
    res = AdvanceResult(src=src, dst=dst, edge_id=edge_id, in_pos=in_pos,
                        valid=valid, total=total)
    return _apply_functor(res, rank, functor, data)


def advance(graph: Graph, frontier: SparseFrontier, cap_out: int,
            functor: Optional[Callable] = None, data=None,
            input_kind: str = "vertex", strategy: str = "LB", *,
            backend: Optional[str] = None
            ) -> tuple[AdvanceResult, object]:
    """Gunrock advance (push) of one frontier, through the single-lane
    "advance" registry op."""
    _strategy(strategy)
    bk = B.resolve(backend, graph.device)
    base, sizes = _base_and_sizes(graph, frontier.ids, frontier.valid_mask,
                                  input_kind)
    src, dst, edge_id, in_pos, rank, valid, total = B.dispatch(
        "advance", bk)(graph.row_offsets, graph.col_indices, base, sizes,
                       cap_out)
    res = AdvanceResult(src=src, dst=dst, edge_id=edge_id, in_pos=in_pos,
                        valid=valid, total=total)
    return _apply_functor(res, rank, functor, data)


def frontier_workload(graph: Graph, frontier) -> torch.Tensor:
    """Upper bound on the advance output of ``frontier``: the sum of the
    out-degrees of its live vertices — (B,) for a batched frontier, ()
    for a single one."""
    _, sizes = _base_and_sizes(graph, frontier.ids, frontier.valid_mask,
                               "vertex")
    return sizes.sum(dim=-1, dtype=torch.int32)


@B.register("advance_filter_batch", B.TORCH)
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


@B.register("advance_filter", B.TORCH)
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
    ids, srcs, lengths, totals = B.dispatch("advance_filter_batch", bk)(
        graph.row_offsets, graph.col_indices, base, sizes,
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
    ids, srcs, length, total = B.dispatch("advance_filter", bk)(
        graph.row_offsets, graph.col_indices, base, sizes,
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


def _long_seg(graph: Graph) -> torch.Tensor:
    """The CSC edge→row map as int64 (scatter's index type), built once
    per graph."""
    seg = graph.cache.get("csc_row_seg64")
    if seg is None:
        seg = (graph.csc_row_seg if graph.csc_row_seg is not None
               else row_segments_of(graph.csc_offsets)).long()
        graph.cache["csc_row_seg64"] = seg
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
    csc = graph.csc_indices
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
        ro, graph.col_indices, small, sizes, cap_out)
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
    found = B.dispatch("segment_search", bk)(graph.col_indices, lo, hi,
                                             needles)
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
