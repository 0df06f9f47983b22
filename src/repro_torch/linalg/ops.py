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
         in another fixed order (the same bits for min, max and exact
         sums); no ELL tree, so ``ell_width`` is unused;
  "mxm"  (a_off, a_idx, a_vals|None, bt_off, bt_idx, bt_vals|None,
          base (E,), probe_rows (E,), sr, cap_out) → c (E,) float32 —
         the dot formulation over a mask pattern: row ``base[e]`` of the
         expansion structure is LB-expanded ("advance"), each emitted
         column id is located in row ``probe_rows[e]`` of the
         B-transpose structure (the K5 probe), and the matches are
         ⊗-combined and ⊕-reduced per mask edge.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core import backend as B
from ..core import operators as O
from ..core import storage as St
from ..core.graph import Graph, row_segments_of
from . import semiring as S
from .semiring import Semiring, plus_times


def hybrid_ell_reduce(offsets, indices, values, x, sr: Semiring,
                      width: int, over_pos, over_row) -> torch.Tensor:
    """The fixed-grouping row fold (see the module docstring). Returns
    the raw (rows,) vector; callers clamp empty rows and apply masks."""
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
    if int(over_pos.shape[0]):
        pos = over_pos.long()
        ov = x[St.gather_cols(indices, pos).long()]
        ov = sr.round_prod(ov) if values is None else sr.mul_op(values[pos],
                                                                ov)
        y = sr.scatter_accum(y, over_row, ov)
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


def _csr_side(a: Graph, transpose: bool):
    """(offsets, column store, values, ell_width, row_seg, over_pos,
    over_row) of a Graph's CSR, or of its CSC mirror with
    ``transpose=True``: the column slot is the graph's native store,
    which the wrappers coerce for the provider that runs. One device
    only: sharded placements are not ported (ROADMAP A13)."""
    if not isinstance(a, Graph):
        raise TypeError(
            f"expected a Graph, got {type(a).__name__}; sharded "
            f"placements are not ported yet (ROADMAP A13)")
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
         precision: str = "fp32") -> torch.Tensor:
    """Masked semiring SpMV ``y⟨mask⟩ = A ⊗ x`` over a Graph.
    ``transpose=True`` multiplies by Aᵀ through the CSC mirror (the
    PageRank direction); ``structural=True`` ignores stored values;
    ``complement=True`` flips the (n,) row mask; ``precision="bf16"``
    rounds each ⊗ to bfloat16 (plus semirings only)."""
    sr = S.with_precision(semiring, precision)
    bk = B.resolve(backend, a.device)
    off, idx, vals, width, seg, opos, orow = _csr_side(a, transpose)
    idx = B.coerce_store("spmv", bk, store=idx, cache=a.cache)
    if structural:
        vals = None
    mask = _row_mask(mask, complement, a.device)
    x = torch.as_tensor(x, dtype=torch.float32, device=a.device)
    return B.dispatch("spmv", bk)(off, idx, vals, x, sr, width, mask, seg,
                                  opos, orow, cache=a.cache)


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
         precision: str = "fp32") -> torch.Tensor:
    """Dense-accumulator semiring SpMM ``Y⟨mask⟩ = A ⊗ X`` (X (nx, k)):
    each column of X is one lane (a reachability source, a label block).
    Same mask, complement, transpose, structural and precision semantics
    as :func:`spmv`."""
    sr = S.with_precision(semiring, precision)
    bk = B.resolve(backend, a.device)
    off, idx, vals, width, seg, _, _ = _csr_side(a, transpose)
    idx = B.coerce_store("spmm", bk, store=idx, cache=a.cache)
    if structural:
        vals = None
    mask = _row_mask(mask, complement, a.device)
    x = torch.as_tensor(x, dtype=torch.float32, device=a.device)
    if x.dim() != 2:
        raise ValueError(f"spmm needs a dense (n, k) operand, got shape "
                         f"{tuple(x.shape)}")
    return B.dispatch("spmm", bk)(off, idx, vals, x.contiguous(), sr, width,
                                  mask, seg, cache=a.cache)


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
    lane), counted on the host."""
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
    cap = int(sizes.sum()) if cap_out is None else int(cap_out)
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


def mxm_plan(a: Graph, b: Graph, mask, *, b_transpose: bool = False):
    """Host-side plan of ``mxm``: the expansion side's and the probe
    side's (offsets, indices, values), and the (E,) ``base`` rows to
    expand, ``probe_rows`` to probe and the expansion capacity. When
    both sides share one structure (``C = A ⊗ Aᵀ``) each mask edge
    expands its smaller endpoint row and probes the larger — the
    SmallLarge workload reduction of paper §4.3 — so the capacity is
    Σ min(deg(src), deg(dst)) instead of Σ deg(src)."""
    a_off, a_idx, a_vals = _csr_side(a, transpose=False)[:3]
    bt_off, bt_idx, bt_vals = _csr_side(b, transpose=not b_transpose)[:3]
    msrc = np.asarray(mask[0], np.int64)
    mdst = np.asarray(mask[1], np.int64)
    deg_a = np.diff(a_off.cpu().numpy().astype(np.int64))[msrc]
    deg_b = np.diff(bt_off.cpu().numpy().astype(np.int64))[mdst]
    if a_off is bt_off and a_idx is bt_idx:
        a_small = deg_a <= deg_b
        base = np.where(a_small, msrc, mdst)
        probe_rows = np.where(a_small, mdst, msrc)
        cap = int(np.minimum(deg_a, deg_b).sum())
    else:
        base, probe_rows = msrc, mdst
        cap = int(deg_a.sum())
    dev = a_off.device

    def t(x):
        return torch.from_numpy(x.astype(np.int32)).to(dev)

    return ((a_off, a_idx, a_vals), (bt_off, bt_idx, bt_vals), t(base),
            t(probe_rows), cap)


def mxm(a: Graph, b: Graph, mask, *, semiring=plus_times,
        b_transpose: bool = False, structural: bool = False,
        cap_out: Optional[int] = None,
        backend: Optional[str] = None) -> torch.Tensor:
    """Row-tiled masked semiring SpGEMM (dot formulation):
    ``C⟨M⟩ = A ⊗ B`` computed only at the mask pattern.

    ``mask`` is the nnz pattern of M as ``(src_ids, dst_ids)`` host
    arrays; the result is ``c (E,)`` with
    ``c[e] = ⊕_w A[src_e, w] ⊗ B[w, dst_e]``. ``b_transpose=True``
    computes ``A ⊗ bᵀ`` (column ``dst_e`` of B is row ``dst_e`` of b's
    CSR — triangle counting's ``C = A ⊗ Aᵀ``); otherwise b's CSC mirror
    gives column access. Capacity planning is host-side
    (:func:`mxm_plan`); a capacity beyond int32 raises before anything
    is launched. Only the single-device placement is ported."""
    sr = S.get(semiring)
    (a_off, a_idx, a_vals), (bt_off, bt_idx, bt_vals), base, probe_rows, \
        cap = mxm_plan(a, b, mask, b_transpose=b_transpose)
    bk = B.resolve(backend, a_off.device)
    # a delta store reaches the provider decoded (once per graph); a
    # dense one at its index dtype
    a_idx = B.coerce_store("mxm", bk, store=a_idx, cache=a.cache)
    bt_idx = B.coerce_store("mxm", bk, store=bt_idx, cache=b.cache)
    if structural:
        a_vals = bt_vals = None
    cap = max(cap, 1) if cap_out is None else int(cap_out)
    if cap > O.INT32_MAX:
        raise CapacityError(
            f"mxm needs {cap:,} expansion slots, beyond the int32 "
            f"positions of the expansion ({O.INT32_MAX:,})")
    return B.dispatch("mxm", bk)(a_off, a_idx, a_vals, bt_off, bt_idx,
                                 bt_vals, base, probe_rows, sr, cap)
