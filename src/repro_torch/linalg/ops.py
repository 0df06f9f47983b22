"""Semiring SpMV, SpMM, SpMSpV and masked SpGEMM (counterpart of
``repro.linalg.ops``, the "spmv", "spmm" and "mxm" ops).

``y⟨mask⟩ = A ⊗ x``: y[i] = ⊕ over row i's edges of (value ⊗ x[dst]).
The reference fixes the grouping of every row's fold, and both backends
here replay it exactly:

  * the first ``width`` edges of a row (``width`` = the graph's ELL
    width) are ⊕-folded by an explicit pairwise halving tree over
    pow2(width) lanes, padded with the ⊕-identity;
  * the edges past ``width`` continue the fold one at a time, in
    ascending edge order (the build-time ``over_pos``/``over_row``
    lists).

Empty rows and masked-out rows hold the ⊕-identity. ``values=None`` is a
structural matrix (every entry the ⊗-identity, so the product is the
gathered ``x``, rounded by the semiring's ``round_prod``). The column
operand is a column store of any storage plan: the ``torch`` providers
decode per touched edge (``storage.gather_cols``). ``precision="bf16"``
on the public wrappers rounds each ⊗ to bfloat16
(``semiring.with_precision``).

Registry contracts (shared with the CUDA providers):
  "spmv" (offsets, indices, values|None, x (nx,), sr, ell_width,
          mask|None, row_seg|None, over_pos, over_row) → y (n,) float32
  "spmm" (offsets, indices, values|None, x (nx, k), sr, ell_width,
          mask|None, row_seg|None) → y (n, k) float32 — the torch
         provider ⊕-folds each row's products in ascending edge order
         (the reference's ``_spmm_xla`` segment reduce), the CUDA kernel
         too on rows of at most ``kernels.ops.SPMM_SPLIT`` edges, and a
         longer row in contiguous shares merged in order (the same bits
         for min, max and exact sums); no ELL tree, so ``ell_width`` is
         unused;
  "mxm"  (a_off, a_idx, a_vals|None, bt_off, bt_idx, bt_vals|None,
          base (E,), probe_rows (E,), sr, cap_out) → c (E,) float32 —
         the dot formulation over a mask pattern: row ``base[e]`` of the
         expansion structure is LB-expanded ("advance"), each emitted
         column id is located in row ``probe_rows[e]`` of the
         B-transpose structure (the K5 probe), and the matches are
         ⊗-combined and ⊕-reduced per mask edge.

The same three ops carry ``"sharded"`` and ``"2d"`` providers
(``core.distributed``): the public wrappers route a ``ShardedGraph`` /
``Sharded2DGraph`` operand (or ``placement=``) there, and the results
equal the single-device ones bit for bit.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..analysis import sanitize
from ..core import backend as B
from ..core import operators as O
from ..core import storage as St
from ..core.graph import Graph, row_segments_of
from . import semiring as S
from .semiring import Semiring, plus_times


def ordered_scatter_accum(sr: Semiring, target: torch.Tensor,
                          index: torch.Tensor, vals: torch.Tensor
                          ) -> torch.Tensor:
    """``sr.scatter_accum`` whose plus fold adds in ascending index order
    on the card too, row by row from the target's value:
    ``((target[r] + v1) + v2) + …``. On the CPU that is ``index_add``
    itself. On the card ``index_add`` adds with atomics in no fixed
    order, so a card tensor goes through ``index_put_(accumulate=True)``,
    which sorts the targets stably and sums each target's run in order:
    the target's own value rides first in its run (onto a zero
    background, exact), and every row carries at least two columns,
    since a one-column run is summed by a warp-wide reduction instead.
    Min and max need no order.

    The order on the card rests on how PyTorch's CUDA
    ``index_put_(accumulate=True)`` works inside (a stable sort, a serial
    sum of each run where a row is wider than one column, a warp
    reduction at width one), which PyTorch does not document; it was
    checked on PyTorch 2.11 (CUDA 12.8). A new PyTorch may change it,
    and with it the bits of distributed PageRank on the card:
    ``tests/test_torch_cuda.py::test_ordered_scatter_accum_on_the_card_is_the_cpu_fold``
    and ``chip_smoke.py``'s path (h) are the guards."""
    if sr.add != "plus" or target.device.type != "cuda":
        return sr.scatter_accum(target, index, vals)
    n = int(target.shape[0])
    t2 = target.reshape(n, -1)
    v2 = vals.reshape(int(vals.shape[0]), -1).to(target.dtype)
    cols = int(t2.shape[1])
    if cols == 1:
        t2, v2 = t2.expand(-1, 2), v2.expand(-1, 2)
    idx = torch.cat([torch.arange(n, device=target.device), index.long()])
    out = torch.zeros(t2.shape, dtype=target.dtype, device=target.device)
    out.index_put_((idx,), torch.cat([t2, v2]), accumulate=True)
    return out[:, :cols].reshape(target.shape)


def _masked_overflow(offsets, m: int, width: int, edge_valid, cache):
    """(positions, rows) of the edges whose within-row rank is at least
    ``width``, in ascending edge order, among the ``edge_valid`` slots —
    a part's twin of the build-time ``over_pos`` / ``over_row`` (the
    reference's masked drop-scatter over every edge adds the same
    products in the same order). Kept in ``cache`` per offsets tensor."""
    key = ("overflow", offsets.data_ptr(), int(offsets.shape[0]), m,
           int(width))
    if cache is not None and key in cache:
        return cache[key]
    seg = row_segments_of(offsets)
    if int(seg.shape[0]) < m:             # pad slots past offsets[-1]
        seg = torch.cat([seg, seg.new_zeros(m - int(seg.shape[0]))])
    rank = (torch.arange(m, dtype=torch.int64, device=offsets.device)
            - offsets[:-1].long()[seg.long()])
    over = rank >= width
    if edge_valid is not None:
        over = over & edge_valid
    pos = torch.nonzero(over).reshape(-1)
    out = (pos, seg[pos])
    if cache is not None:
        cache[key] = out
        sanitize.note_setup()
    return out


def hybrid_ell_reduce(offsets, indices, values, x, sr: Semiring,
                      width: int, over_pos, over_row, *, edge_valid=None,
                      cache=None) -> torch.Tensor:
    """The fixed-grouping row fold (see the module docstring). Returns
    the raw (rows,) vector; callers clamp empty rows and apply masks.
    ``over_pos=None`` (a part's slice, which has no build-time lists)
    takes the overflow edges from the offsets, among the ``edge_valid``
    slots (padding lanes of a part's edge array)."""
    m = St.store_num_edges(indices)
    width = max(int(width), 1)
    wp = 1
    while wp < width:
        wp *= 2
    starts = offsets[:-1]
    deg = offsets[1:] - offsets[:-1]
    lanes = torch.arange(wp, dtype=torch.int32, device=offsets.device)
    e = torch.clamp(starts[:, None] + lanes[None, :], max=max(m - 1, 0))
    e = e.long()
    lane_ok = lanes[None, :] < torch.clamp(deg, max=width)[:, None]
    xi = x[torch.clamp(St.gather_cols(indices, e), 0, x.shape[0] - 1).long()]
    prod = sr.round_prod(xi) if values is None else sr.mul_op(values[e], xi)
    prod = torch.where(lane_ok, prod, sr.zero)
    k = wp
    while k > 1:                      # explicit halving: grouping fixed
        k //= 2
        prod = sr.add_op(prod[:, :k], prod[:, k:2 * k])
    y = prod[:, 0]
    accum = sr.scatter_accum
    if over_pos is None:
        over_pos, over_row = _masked_overflow(offsets, m, width,
                                              edge_valid, cache)
        # a part's sweep must give the single-device bits on the card too
        accum = lambda t, i, v: ordered_scatter_accum(sr, t, i, v)
    if int(over_pos.shape[0]):
        pos = over_pos.long()
        ov = x[St.gather_cols(indices, pos).long()]
        ov = sr.round_prod(ov) if values is None else sr.mul_op(values[pos],
                                                                ov)
        y = accum(y, over_row, ov)
    return y


def fold_products(offsets, prods, sr: Semiring, width: int, *,
                  edge_valid=None, cache=None) -> torch.Tensor:
    """``hybrid_ell_reduce``'s twin over products already made: fold an
    (m,) per-slot product vector into per-row values with the same
    dataflow — the same ELL gather, the same halving tree, the same
    ascending-order overflow fold. The 2-D vertex cut ⊕-merges its
    blocks' products first (disjoint slots, so the merge meets only
    identities) and then lands on the single-device sweep's bits for
    every semiring. Slots past ``offsets[-1]`` are padding that
    ``edge_valid`` keeps out of the overflow fold."""
    m = int(prods.shape[0])
    width = max(int(width), 1)
    wp = 1
    while wp < width:
        wp *= 2
    starts = offsets[:-1]
    deg = offsets[1:] - offsets[:-1]
    lanes = torch.arange(wp, dtype=torch.int32, device=offsets.device)
    e = torch.clamp(starts[:, None] + lanes[None, :], max=max(m - 1, 0))
    lane_ok = lanes[None, :] < torch.clamp(deg, max=width)[:, None]
    p = torch.where(lane_ok, prods[e.long()], sr.zero)
    k = wp
    while k > 1:                      # explicit halving: grouping fixed
        k //= 2
        p = sr.add_op(p[:, :k], p[:, k:2 * k])
    y = p[:, 0]
    pos, rows = _masked_overflow(offsets, m, width, edge_valid, cache)
    if int(pos.shape[0]):
        y = ordered_scatter_accum(sr, y, rows, prods[pos])
    return y


@B.register("spmv", B.TORCH, encodings=("dense", "delta"))
def _spmv_torch(offsets, indices, values, x, sr: Semiring, ell_width,
                mask, row_seg=None, over_pos=None, over_row=None,
                cache=None):
    """Plain SpMV, the twin of the reference's ``_spmv_xla`` hybrid
    path (and the plain version of the CUDA SpMV kernel). ``cache`` is
    unused here (the kernel keeps its decoded columns in it)."""
    del row_seg, cache
    n = int(offsets.shape[0]) - 1
    m = St.store_num_edges(indices)
    if m == 0:
        y = torch.full((n,), sr.zero, dtype=torch.float32,
                       device=offsets.device)
    else:
        if ell_width is None or over_pos is None:
            raise ValueError(
                "spmv needs the graph's build-time ELL width and overflow "
                "lists; build the Graph with Graph.from_csr / "
                "from_edge_list")
        y = hybrid_ell_reduce(offsets, indices, values, x, sr,
                              int(ell_width), over_pos, over_row)
    deg = offsets[1:] - offsets[:-1]
    y = torch.where(deg > 0, y, sr.zero)
    if mask is not None:
        y = torch.where(mask, y, sr.zero)
    return y.to(torch.float32)


def _segment_fold(sr: Semiring, seg: torch.Tensor, prod: torch.Tensor,
                  n: int) -> torch.Tensor:
    """(n, k) ⊕-fold of the (m, k) ``prod`` rows by the sorted segment
    ids ``seg``, as the reference's ``segment_sum`` / ``segment_min`` /
    ``segment_max``: a plus fold starts from 0 and adds in edge order (on
    the CPU), a min / max fold covers only the row's own products. Rows
    with no products keep the ⊕-identity."""
    k = int(prod.shape[1])
    y = torch.full((n, k), sr.zero, dtype=torch.float32, device=prod.device)
    if sr.add == "plus":
        return y.index_add_(0, seg, prod)
    idx = seg.long()[:, None].expand(-1, k)
    return y.scatter_reduce_(0, idx, prod,
                             "amin" if sr.add == "min" else "amax",
                             include_self=False)


@B.register("spmm", B.TORCH, encodings=("dense", "delta"))
def _spmm_torch(offsets, indices, values, x, sr: Semiring, ell_width,
                mask, row_seg=None, cache=None):
    """Plain SpMM, the twin of the reference's ``_spmm_xla`` (and the
    plain version of the CUDA SpMM kernel): gather ``x[cols]`` as (m, k),
    ⊗ with the stored values, ⊕-fold per row, the ⊕-identity on empty and
    masked-out rows."""
    del ell_width, cache
    n = int(offsets.shape[0]) - 1
    deg = offsets[1:] - offsets[:-1]
    if row_seg is None:
        row_seg = row_segments_of(offsets)
    xv = torch.index_select(x, 0, St.decode_cols(indices))
    prod = (sr.round_prod(xv) if values is None
            else sr.mul_op(values[:, None], xv))
    y = _segment_fold(sr, row_seg, prod.to(torch.float32), n)
    y = torch.where((deg > 0)[:, None], y, sr.zero)
    if mask is not None:
        y = torch.where(mask[:, None], y, sr.zero)
    return y.to(torch.float32)


def _csr_side(a, transpose: bool):
    """(offsets, column store, values, ell_width, row_seg, over_pos,
    over_row) of a Graph's CSR, or of its CSC mirror with
    ``transpose=True``: the column slot is the graph's native store,
    which the wrappers coerce for the provider that runs. A
    ``ShardedGraph`` gives its per-part tuples, a ``Sharded2DGraph`` its
    per-block tuples with a ``Blocks2D`` column store (no row_seg or
    overflow lists: the placement providers derive them per part)."""
    from ..core.partition import Sharded2DGraph, ShardedGraph
    if not isinstance(a, (Graph, ShardedGraph, Sharded2DGraph)):
        raise TypeError(f"expected a Graph, ShardedGraph or "
                        f"Sharded2DGraph, got {type(a).__name__}")
    if transpose:
        if not a.has_csc:
            raise ValueError("transpose=True needs the CSC mirror "
                             "(build_csc=True)")
        return (a.csc_offsets, a.csc_store, a.csc_edge_values,
                a.csc_ell_width, a.csc_row_seg, a.csc_over_pos,
                a.csc_over_row)
    return (a.row_offsets, a.col_store, a.edge_values, a.ell_width,
            a.row_seg, a.over_pos, a.over_row)


def spmv(a: Graph, x, *, semiring=plus_times, mask=None,
         complement: bool = False, transpose: bool = False,
         structural: bool = False, backend: Optional[str] = None,
         placement: Optional[str] = None,
         precision: str = "fp32") -> torch.Tensor:
    """Masked semiring SpMV ``y⟨mask⟩ = A ⊗ x`` over a Graph.
    ``transpose=True`` multiplies by Aᵀ through the CSC mirror (the
    PageRank direction); ``structural=True`` ignores stored values;
    ``complement=True`` flips the (n,) row mask; ``precision="bf16"``
    rounds each ⊗ to bfloat16 (plus semirings only). ``a`` may be a
    ``ShardedGraph`` or ``Sharded2DGraph``: the sweep then runs under
    its placement and equals the single-device result bit for bit."""
    sr = S.with_precision(semiring, precision)
    bk = B.resolve(backend, a.device)
    pl, ctx = B.resolve_graph_placement(a, placement)
    off, idx, vals, width, seg, opos, orow = _csr_side(a, transpose)
    idx = B.coerce_store("spmv", bk, pl, store=idx, cache=a.cache)
    if structural:
        vals = None
    mask = _row_mask(mask, complement, a.device)
    x = torch.as_tensor(x, dtype=torch.float32, device=a.device)
    with ctx:
        return B.dispatch("spmv", bk, pl)(off, idx, vals, x, sr, width,
                                          mask, seg, opos, orow,
                                          cache=a.cache)


def _row_mask(mask, complement: bool, device) -> Optional[torch.Tensor]:
    if mask is None:
        if complement:
            raise ValueError("complement=True requires a mask")
        return None
    mask = torch.as_tensor(mask, device=device).to(torch.bool)
    return ~mask if complement else mask


def spmm(a: Graph, x, *, semiring=plus_times, mask=None,
         complement: bool = False, transpose: bool = False,
         structural: bool = False, backend: Optional[str] = None,
         placement: Optional[str] = None,
         precision: str = "fp32") -> torch.Tensor:
    """Dense-accumulator semiring SpMM ``Y⟨mask⟩ = A ⊗ X`` (X (nx, k)):
    each column of X is one lane (a reachability source, a label block).
    Same mask, complement, transpose, structural, placement and
    precision semantics as :func:`spmv`."""
    sr = S.with_precision(semiring, precision)
    bk = B.resolve(backend, a.device)
    pl, ctx = B.resolve_graph_placement(a, placement)
    off, idx, vals, width, seg, _, _ = _csr_side(a, transpose)
    idx = B.coerce_store("spmm", bk, pl, store=idx, cache=a.cache)
    if structural:
        vals = None
    mask = _row_mask(mask, complement, a.device)
    x = torch.as_tensor(x, dtype=torch.float32, device=a.device)
    if x.dim() != 2:
        raise ValueError(f"spmm needs a dense (n, k) operand, got shape "
                         f"{tuple(x.shape)}")
    with ctx:
        return B.dispatch("spmm", bk, pl)(off, idx, vals, x.contiguous(),
                                          sr, width, mask, seg,
                                          cache=a.cache)


def spmsv(a: Graph, ids, xvals=None, *, semiring=plus_times, mask=None,
          complement: bool = False, structural: bool = False,
          cap_out: Optional[int] = None,
          backend: Optional[str] = None) -> torch.Tensor:
    """Sparse-vector semiring product (SpMSpV, the push direction):
    ``y⟨mask⟩[v] = ⊕_{u active} x[u] ⊗ A[u, v]``, with x given as
    frontier ``ids`` (-1 = dead lane) and per-lane ``xvals`` (None = the
    ⊗-identity). One "advance" expansion (K3 on the cuda backend) whose
    functor is ⊗, then a ⊕ scatter into a dense (n,) output. ``cap_out``
    defaults to the exact expansion size (duplicate ids expand once per
    lane), counted on the host. A partitioned graph has no spmsv (the
    push expansion is frontier-shaped), as in the reference."""
    if not isinstance(a, Graph):
        raise ValueError(
            "spmsv has no sharded/2d provider (the push expansion is "
            "frontier-shaped); use spmv/spmm on the partitioned graph, "
            "or run spmsv on the unpartitioned source graph")
    sr = S.get(semiring)
    bk = B.resolve(backend, a.device)
    off, idx, vals = _csr_side(a, transpose=False)[:3]
    # the expansion runs the "advance" op, whose providers decode the
    # delta stream themselves
    idx = B.coerce_store("advance", bk, store=idx, cache=a.cache)
    if structural:
        vals = None
    n = int(off.shape[0]) - 1
    ids = torch.as_tensor(ids, dtype=torch.int32, device=a.device)
    valid_in = ids >= 0
    base = torch.where(valid_in, ids, 0)
    deg = (torch.index_select(off, 0, base + 1)
           - torch.index_select(off, 0, base))
    sizes = torch.where(valid_in, deg, 0).to(torch.int32)
    cap = (int(sizes.sum(dtype=torch.int64)) if cap_out is None
           else int(cap_out))
    _, dst, eid, in_pos, _, valid, _ = B.dispatch("advance", bk)(
        off, idx, base, sizes, max(cap, 1), a.cache)
    sv = (torch.tensor(sr.one, dtype=torch.float32, device=a.device)
          if xvals is None else torch.index_select(
              torch.as_tensor(xvals, dtype=torch.float32, device=a.device),
              0, in_pos))
    av = _gather_vals(vals, eid, sr.one)
    prod = torch.where(valid, sr.mul_op(sv, av), sr.zero).to(torch.float32)
    # dead slots land in a spill entry n that is cut off (the reference's
    # mode="drop")
    y = torch.full((n + 1,), sr.zero, dtype=torch.float32, device=a.device)
    y = sr.scatter_accum(y, torch.where(valid, dst, n), prod)[:n]
    mask = _row_mask(mask, complement, a.device)
    return y if mask is None else torch.where(mask, y, sr.zero)


def _gather_vals(vals: Optional[torch.Tensor], idx: torch.Tensor,
                 one: float) -> torch.Tensor:
    """``vals[clip(idx)]``, or the ⊗-identity for a structural (or
    empty) matrix."""
    m = 0 if vals is None else int(vals.shape[0])
    if m == 0:
        return torch.tensor(one, dtype=torch.float32, device=idx.device)
    return torch.index_select(vals, 0, idx.clamp(0, m - 1)).to(torch.float32)


def make_mxm_impl(expand, locate):
    """A masked-SpGEMM registry provider built from an LB expansion (the
    "advance" contract) and a position-returning probe. The ``torch``
    provider passes the plain ones, ``kernels.ops`` K3 and K5. The
    intermediates are dropped as soon as they are used: at rmat scale
    18, triangle counting expands 6.6e8 slots."""

    def impl(a_off, a_idx, a_vals, bt_off, bt_idx, bt_vals, base,
             probe_rows, sr: Semiring, cap_out: int) -> torch.Tensor:
        e = int(base.shape[0])
        dev = base.device
        sizes = (torch.index_select(a_off, 0, base + 1)
                 - torch.index_select(a_off, 0, base)).to(torch.int32)
        # row-tiled expansion of the mask edges' expansion-side rows: the
        # emitted column id IS the probe needle, in_pos the mask edge
        _, needles, eid, pair, _, valid, _ = expand(a_off, a_idx, base,
                                                    sizes, cap_out)
        rows = torch.index_select(probe_rows, 0, pair)
        lo = torch.index_select(bt_off, 0, rows)
        hi = torch.index_select(bt_off, 0, rows + 1)
        del rows
        pos = locate(bt_idx, lo, hi, needles)
        del lo, hi, needles
        found = (pos >= 0) & valid
        del valid
        sv = _gather_vals(a_vals, eid, sr.one)
        del eid
        lv = _gather_vals(bt_vals, pos, sr.one)
        del pos
        prod = torch.where(found, sr.mul_op(sv, lv), sr.zero)
        del found, sv, lv
        prod = prod.to(torch.float32)
        if sr.add == "plus":
            c = torch.zeros((e,), dtype=torch.float32, device=dev)
            c.index_add_(0, pair, prod)
        else:
            # the segment op's neutral element on empty segments, as
            # jax.ops.segment_min / segment_max give it
            neutral = float("inf") if sr.add == "min" else float("-inf")
            c = torch.full((e,), neutral, dtype=torch.float32, device=dev)
            c.scatter_reduce_(0, pair.long(), prod,
                              "amin" if sr.add == "min" else "amax")
        return torch.where(sizes > 0, c, sr.zero).to(torch.float32)

    return impl


_mxm_torch = B.register("mxm", B.TORCH)(
    make_mxm_impl(O._advance_torch, O._segment_locate_torch))


class CapacityError(ValueError):
    """An ``mxm`` expansion whose positions would pass int32."""


def _expansion_degrees(a) -> np.ndarray:
    """The expansion side's global out-degrees on the host: a Graph's
    offsets, a ShardedGraph's parts laid end to end (pad rows 0), or the
    sum over a Sharded2DGraph's column blocks of each row chunk."""
    from ..core.partition import Sharded2DGraph, ShardedGraph
    if isinstance(a, ShardedGraph):
        return np.concatenate([np.diff(ro.cpu().numpy().astype(np.int64))
                               for ro in a.row_offsets])[:a.num_vertices]
    if isinstance(a, Sharded2DGraph):
        blk = [np.diff(ro.cpu().numpy().astype(np.int64))
               for ro in a.row_offsets]
        rows = [sum(blk[i * a.cols + j] for j in range(a.cols))
                for i in range(a.rows)]
        return np.concatenate(rows)[:a.num_vertices]
    return np.diff(a.row_offsets.cpu().numpy().astype(np.int64))


def mxm_plan(a: Graph, b: Graph, mask, *, b_transpose: bool = False):
    """Host-side plan of ``mxm``: the expansion side's and the probe
    side's (offsets, indices, values), and the (E,) ``base`` rows to
    expand, ``probe_rows`` to probe and the expansion capacity. When
    both sides share one structure (``C = A ⊗ Aᵀ``) each mask edge
    expands its smaller endpoint row and probes the larger — the
    SmallLarge workload reduction of paper §4.3 — so the capacity is
    Σ min(deg(src), deg(dst)) instead of Σ deg(src). A partitioned
    expansion side never shares the probe side's structure."""
    a_off, a_idx, a_vals = _csr_side(a, transpose=False)[:3]
    bt_off, bt_idx, bt_vals = _csr_side(b, transpose=not b_transpose)[:3]
    msrc = np.asarray(mask[0], np.int64)
    mdst = np.asarray(mask[1], np.int64)
    deg_a = _expansion_degrees(a)[msrc]
    deg_b = np.diff(bt_off.cpu().numpy().astype(np.int64))[mdst]
    if a_off is bt_off and a_idx is bt_idx:
        a_small = deg_a <= deg_b
        base = np.where(a_small, msrc, mdst)
        probe_rows = np.where(a_small, mdst, msrc)
        cap = int(np.minimum(deg_a, deg_b).sum())
    else:
        base, probe_rows = msrc, mdst
        cap = int(deg_a.sum())
    dev = a.device

    def t(x):
        return torch.from_numpy(x.astype(np.int32)).to(dev)

    return ((a_off, a_idx, a_vals), (bt_off, bt_idx, bt_vals), t(base),
            t(probe_rows), cap)


def mxm(a: Graph, b: Graph, mask, *, semiring=plus_times,
        b_transpose: bool = False, structural: bool = False,
        cap_out: Optional[int] = None,
        backend: Optional[str] = None,
        placement: Optional[str] = None) -> torch.Tensor:
    """Row-tiled masked semiring SpGEMM (dot formulation):
    ``C⟨M⟩ = A ⊗ B`` computed only at the mask pattern.

    ``mask`` is the nnz pattern of M as ``(src_ids, dst_ids)`` host
    arrays; the result is ``c (E,)`` with
    ``c[e] = ⊕_w A[src_e, w] ⊗ B[w, dst_e]``. ``b_transpose=True``
    computes ``A ⊗ bᵀ`` (column ``dst_e`` of B is row ``dst_e`` of b's
    CSR — triangle counting's ``C = A ⊗ Aᵀ``); otherwise b's CSC mirror
    gives column access. Capacity planning is host-side
    (:func:`mxm_plan`); a capacity beyond int32 raises before anything
    is launched.

    Partitioned: pass a ``ShardedGraph`` / ``Sharded2DGraph`` as ``a``
    (the expansion side is split over the mesh) and a plain Graph as
    ``b`` (the probe side stays replicated; the SmallLarge swap is off,
    the two sides live in different layouts)."""
    from ..core.partition import Sharded2DGraph, ShardedGraph
    sr = S.get(semiring)
    pl, ctx = B.resolve_graph_placement(a, placement)
    if isinstance(b, (ShardedGraph, Sharded2DGraph)):
        raise ValueError(
            "mxm keeps the probe side (b) replicated; pass the "
            "expansion side (a) as a ShardedGraph and b as a plain "
            "Graph (e.g. pg.source)")
    (a_off, a_idx, a_vals), (bt_off, bt_idx, bt_vals), base, probe_rows, \
        cap = mxm_plan(a, b, mask, b_transpose=b_transpose)
    bk = B.resolve(backend, a.device)
    # a delta store reaches the provider decoded (once per graph); a
    # dense one at its index dtype
    a_idx = B.coerce_store("mxm", bk, pl, store=a_idx, cache=a.cache)
    bt_idx = B.coerce_store("mxm", bk, store=bt_idx, cache=b.cache)
    if structural:
        a_vals = bt_vals = None
    cap = max(cap, 1) if cap_out is None else int(cap_out)
    if cap > O.INT32_MAX:
        raise CapacityError(
            f"mxm needs {cap:,} expansion slots, beyond the int32 "
            f"positions of the expansion ({O.INT32_MAX:,})")
    with ctx:
        return B.dispatch("mxm", bk, pl)(a_off, a_idx, a_vals, bt_off,
                                         bt_idx, bt_vals, base, probe_rows,
                                         sr, cap)
