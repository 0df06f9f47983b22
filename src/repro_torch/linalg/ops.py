"""Semiring SpMV (counterpart of ``repro.linalg.ops``, the "spmv" op).

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
gathered ``x``).

Registry contract ("spmv", shared with the CUDA provider):
  (offsets, indices, values|None, x (nx,), sr, ell_width, mask|None,
   row_seg|None, over_pos, over_row) → y (n,) float32
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core import backend as B
from ..core.graph import Graph
from . import semiring as S
from .semiring import Semiring, plus_times


def hybrid_ell_reduce(offsets, indices, values, x, sr: Semiring,
                      width: int, over_pos, over_row) -> torch.Tensor:
    """The fixed-grouping row fold (see the module docstring). Returns
    the raw (rows,) vector; callers clamp empty rows and apply masks."""
    nrows = int(offsets.shape[0]) - 1
    m = int(indices.shape[0])
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
    xi = x[torch.clamp(indices[e], 0, x.shape[0] - 1).long()]
    prod = xi if values is None else sr.mul_op(values[e], xi)
    prod = torch.where(lane_ok, prod, sr.zero)
    k = wp
    while k > 1:                      # explicit halving: grouping fixed
        k //= 2
        prod = sr.add_op(prod[:, :k], prod[:, k:2 * k])
    y = prod[:, 0]
    if int(over_pos.shape[0]):
        pos = over_pos.long()
        ov = x[indices[pos].long()]
        ov = ov if values is None else sr.mul_op(values[pos], ov)
        y = sr.scatter_accum(y, over_row, ov)
    return y


@B.register("spmv", B.TORCH)
def _spmv_torch(offsets, indices, values, x, sr: Semiring, ell_width,
                mask, row_seg=None, over_pos=None, over_row=None):
    """Plain SpMV, the twin of the reference's ``_spmv_xla`` hybrid
    path (and the plain version of the CUDA SpMV kernel)."""
    del row_seg
    n = int(offsets.shape[0]) - 1
    m = int(indices.shape[0])
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


def spmv(a: Graph, x, *, semiring=plus_times, mask=None,
         complement: bool = False, transpose: bool = False,
         structural: bool = False,
         backend: Optional[str] = None) -> torch.Tensor:
    """Masked semiring SpMV ``y⟨mask⟩ = A ⊗ x`` over a Graph.
    ``transpose=True`` multiplies by Aᵀ through the CSC mirror (the
    PageRank direction); ``structural=True`` ignores stored values;
    ``complement=True`` flips the (n,) row mask."""
    sr = S.get(semiring)
    bk = B.resolve(backend, a.device)
    if transpose:
        if not a.has_csc:
            raise ValueError("transpose=True needs the CSC mirror")
        side = (a.csc_offsets, a.csc_indices, a.csc_edge_values,
                a.csc_ell_width, a.csc_row_seg, a.csc_over_pos,
                a.csc_over_row)
    else:
        side = (a.row_offsets, a.col_indices, a.edge_values, a.ell_width,
                a.row_seg, a.over_pos, a.over_row)
    off, idx, vals, width, seg, opos, orow = side
    if structural:
        vals = None
    if mask is None:
        if complement:
            raise ValueError("complement=True requires a mask")
    else:
        mask = torch.as_tensor(mask, device=a.device).to(torch.bool)
        mask = ~mask if complement else mask
    x = torch.as_tensor(x, dtype=torch.float32, device=a.device)
    return B.dispatch("spmv", bk)(off, idx, vals, x, sr, width, mask, seg,
                                  opos, orow)
