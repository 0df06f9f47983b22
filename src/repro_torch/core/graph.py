"""Graph container and generators (counterpart of ``repro.core.graph``).

``Graph`` is a frozen dataclass of int32 tensors on one device:

    row_offsets : (n+1,)  CSR offsets
    col_indices : (m,)    neighbor ids, sorted within each row
    edge_values : (m,)    optional float32 weights

plus the CSC mirror (pull traversal, PageRank's transpose sweep) and the
build-time sweep metadata of the reference: edge→row maps
(``row_seg``/``csc_row_seg``), the compacted ELL-overflow edge lists
(``over_pos``/``over_row`` and their CSC twins) and the two ELL widths.
Storage is dense int32 only (the reference's default plan).

Everything is built on the host with numpy — the same calls in the same
order as the reference, so the arrays come out identical; the two large
stable sorts run through PyTorch on the graph's device, which returns
the same (unique) permutation faster — and moved to the device once. ``device=None`` means the card; the CPU is used only
when asked for.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..kernels.runtime import resolve_device

INT32_MAX = np.iinfo(np.int32).max

# the tensor fields, in the reference's pytree order
TENSOR_FIELDS = ("row_offsets", "col_indices", "edge_values",
                 "csc_offsets", "csc_indices", "csc_edge_values",
                 "csc_edge_ids", "row_seg", "csc_row_seg",
                 "over_pos", "over_row", "csc_over_pos", "csc_over_row")


@dataclass(frozen=True)
class Graph:
    """Static-topology graph in CSR (+ CSC mirror) form."""

    row_offsets: torch.Tensor
    col_indices: torch.Tensor
    edge_values: Optional[torch.Tensor] = None
    csc_offsets: Optional[torch.Tensor] = None
    csc_indices: Optional[torch.Tensor] = None
    csc_edge_values: Optional[torch.Tensor] = None
    csc_edge_ids: Optional[torch.Tensor] = None
    row_seg: Optional[torch.Tensor] = None
    csc_row_seg: Optional[torch.Tensor] = None
    over_pos: Optional[torch.Tensor] = None
    over_row: Optional[torch.Tensor] = None
    csc_over_pos: Optional[torch.Tensor] = None
    csc_over_row: Optional[torch.Tensor] = None
    ell_width: Optional[int] = None
    csc_ell_width: Optional[int] = None
    # derived tensors and kernel scratch that live as long as the graph
    # (reciprocal out-degrees, the fused filter's first-slot table); not
    # part of the graph's value
    cache: dict = field(default_factory=dict, compare=False, repr=False)

    # --- basic properties -------------------------------------------------
    @property
    def num_vertices(self) -> int:
        return int(self.row_offsets.shape[0]) - 1

    @property
    def num_edges(self) -> int:
        return int(self.col_indices.shape[0])

    @property
    def device(self) -> torch.device:
        return self.row_offsets.device

    @property
    def degrees(self) -> torch.Tensor:
        return self.row_offsets[1:] - self.row_offsets[:-1]

    @property
    def has_csc(self) -> bool:
        return self.csc_offsets is not None

    @property
    def weighted(self) -> bool:
        return self.edge_values is not None

    def cols_np(self) -> np.ndarray:
        return self.col_indices.cpu().numpy()

    @classmethod
    def from_csr(cls, row_offsets, col_indices, edge_values=None, *,
                 build_csc: bool = True, sort_neighbors: bool = True,
                 validate: bool = False, device=None) -> "Graph":
        """Build a Graph from host-side CSR arrays; all build-time
        metadata (CSC mirror, edge→row maps, overflow lists, both ELL
        widths) is computed here exactly once. ``validate=True`` runs
        :func:`validate_csr` on the raw input first."""
        dev = resolve_device(device)
        ro = np.asarray(row_offsets, np.int64)
        n = len(ro) - 1
        if validate:
            validate_csr(row_offsets, col_indices, edge_values)
        ci = np.asarray(col_indices, np.int32)
        vals = (None if edge_values is None
                else np.asarray(edge_values, np.float32))
        counts = np.diff(ro)
        if sort_neighbors and len(ci):
            order = np.lexsort((ci, np.repeat(np.arange(n), counts)))
            ci = ci[order]
            if vals is not None:
                vals = vals[order]
        src = np.repeat(np.arange(n, dtype=np.int32), counts)
        ell_w = ell_width_for(counts)
        over = _overflow_edges(ro, src, ell_w)
        csc = (None, None, None, None)
        csc_ell = csc_seg = None
        csc_over = (None, None)
        if build_csc:
            csc = _build_csc(n, src, ci.astype(np.int64), vals, dev)
            csc_ell = ell_width_for(np.diff(csc[0]))
            csc_seg = np.repeat(np.arange(n, dtype=np.int32),
                                np.diff(csc[0]))
            csc_over = _overflow_edges(csc[0], csc_seg, csc_ell)

        def t(a, dtype=np.int32):
            if a is None:
                return None
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

        return cls(row_offsets=t(ro), col_indices=t(ci),
                   edge_values=t(vals, np.float32),
                   csc_offsets=t(csc[0]), csc_indices=t(csc[1]),
                   csc_edge_values=t(csc[2], np.float32),
                   csc_edge_ids=t(csc[3]), row_seg=t(src),
                   csc_row_seg=t(csc_seg), over_pos=t(over[0]),
                   over_row=t(over[1]), csc_over_pos=t(csc_over[0]),
                   csc_over_row=t(csc_over[1]), ell_width=ell_w,
                   csc_ell_width=csc_ell)


class GraphValidationError(ValueError):
    """Structurally invalid CSR input (see :func:`validate_csr`)."""


def validate_csr(row_offsets, col_indices, edge_values=None
                 ) -> tuple[int, int]:
    """Strict structural validation of host-side CSR arrays (the
    reference's checks, against the int32 id range): offsets 1-D,
    starting at 0, non-decreasing, ending at the edge count; every
    column id in ``[0, n)`` and within int32; one finite value per
    edge. Returns ``(n, m)``; raises :class:`GraphValidationError`
    naming the first offending row or edge."""
    ro = np.asarray(row_offsets, np.int64)
    ci = np.asarray(col_indices, np.int64)
    if ro.ndim != 1 or len(ro) < 1:
        raise GraphValidationError(
            f"row_offsets must be a 1-D array of n+1 offsets; got "
            f"shape {ro.shape}")
    n = len(ro) - 1
    if ro[0] != 0:
        raise GraphValidationError(
            f"row_offsets[0] must be 0 (CSR rows start at the origin), "
            f"got {int(ro[0])}")
    bad = np.nonzero(np.diff(ro) < 0)[0]
    if len(bad):
        i = int(bad[0])
        raise GraphValidationError(
            f"non-monotone row_offsets at row {i}: offsets[{i}]="
            f"{int(ro[i])} > offsets[{i + 1}]={int(ro[i + 1])}")
    if int(ro[-1]) != len(ci):
        raise GraphValidationError(
            f"indptr/edge-count mismatch: row_offsets[-1]={int(ro[-1])} "
            f"but col_indices has {len(ci)} entries")
    if len(ci):
        oob = np.nonzero((ci < 0) | (ci >= n))[0]
        if len(oob):
            e = int(oob[0])
            raise GraphValidationError(
                f"column id out of range at edge {e}: {int(ci[e])} not "
                f"in [0, {n})")
    top = max(n - 1, len(ci))
    if top > INT32_MAX:
        raise GraphValidationError(
            f"int32 overflow: the graph needs ids or edge offsets up to "
            f"{top}, beyond int32")
    if edge_values is not None:
        ev = np.asarray(edge_values, np.float64)
        if len(ev) != len(ci):
            raise GraphValidationError(
                f"edge_values length {len(ev)} != edge count {len(ci)}")
        nf = np.nonzero(~np.isfinite(ev))[0]
        if len(nf):
            e = int(nf[0])
            raise GraphValidationError(
                f"non-finite edge value at edge {e}: {ev[e]!r}")
    return n, len(ci)


def validate_graph(g: Graph) -> tuple[int, int]:
    """Re-run :func:`validate_csr` on a built Graph (and its CSC
    mirror), pulling the arrays back to the host."""
    vals = None if g.edge_values is None else g.edge_values.cpu().numpy()
    shape = validate_csr(g.row_offsets.cpu().numpy(), g.cols_np(), vals)
    if g.has_csc:
        validate_csr(g.csc_offsets.cpu().numpy(),
                     g.csc_indices.cpu().numpy())
    return shape


def _overflow_edges(offsets: np.ndarray, seg: np.ndarray,
                    width: int) -> tuple[np.ndarray, np.ndarray]:
    """Positions + owning rows of the edges whose within-row rank ≥
    ``width`` (ascending edge order)."""
    m = len(seg)
    rank = np.arange(m, dtype=np.int64) - np.asarray(offsets)[:-1][seg]
    pos = np.nonzero(rank >= width)[0].astype(np.int32)
    return pos, seg[pos].astype(np.int32)


def ell_width_for(degrees: np.ndarray) -> int:
    """ELL width covering ≥95% of rows, clamped to [1, 1024]."""
    if len(degrees) == 0:
        return 1
    w = int(np.percentile(np.asarray(degrees), 95))
    return max(min(w, 1024), 1)


def _stable_argsort(a: np.ndarray, device) -> np.ndarray:
    """``np.argsort(a, kind="stable")`` — the permutation is unique, so
    PyTorch's parallel stable sort (on the graph's device) returns the
    same one, several times faster than numpy's at scale."""
    t = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return torch.sort(t, stable=True).indices.cpu().numpy()


def _build_csc(n: int, src: np.ndarray, dst: np.ndarray,
               vals: Optional[np.ndarray], device):
    """Transpose an edge list into CSC arrays (host-side arrays; the
    stable sort may run on ``device``)."""
    order = _stable_argsort(dst, device)
    csc_indices = src[order].astype(np.int32)
    csc_edge_ids = order.astype(np.int32)
    counts = np.bincount(dst, minlength=n)
    csc_offsets = np.zeros(n + 1, dtype=np.int32)
    np.cumsum(counts, out=csc_offsets[1:])
    csc_vals = vals[order].astype(np.float32) if vals is not None else None
    return csc_offsets, csc_indices, csc_vals, csc_edge_ids


def from_edge_list(src, dst, n: Optional[int] = None, values=None,
                   undirected: bool = False, build_csc: bool = True,
                   sort_neighbors: bool = True,
                   remove_self_loops: bool = True,
                   deduplicate: bool = True, device=None) -> Graph:
    """Build a Graph from host-side edge arrays: optionally symmetrize,
    drop self loops and duplicate edges, sort rows."""
    device = resolve_device(device)
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    if values is not None:
        values = np.asarray(values, dtype=np.float32)
    if n is None:
        n = (int(max(src.max(initial=-1), dst.max(initial=-1))) + 1
             if len(src) else 0)
    if undirected:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
        if values is not None:
            values = np.concatenate([values, values])
    if remove_self_loops and len(src):
        keep = src != dst
        src, dst = src[keep], dst[keep]
        if values is not None:
            values = values[keep]
    if deduplicate and sort_neighbors and len(src):
        # the sorted unique keys ARE the (src, dst)-sorted edge list and
        # the head of each run of equal keys in a stable sort is its first
        # occurrence — the same arrays as the general path below (and as
        # np.unique(return_index=True)), without its lexsort
        key = src * n + dst
        order = _stable_argsort(key, device)
        key = key[order]
        head = np.ones(len(key), dtype=bool)
        head[1:] = key[1:] != key[:-1]
        first, key = order[head], key[head]
        src, dst = key // n, key % n
        if values is not None:
            values = values[first]
    else:
        if deduplicate and len(src):
            key = src * n + dst
            _, first = np.unique(key, return_index=True)
            first.sort()
            src, dst = src[first], dst[first]
            if values is not None:
                values = values[first]
        if sort_neighbors and len(src):
            order = np.lexsort((dst, src))
        else:
            order = np.argsort(src, kind="stable")
        src, dst = src[order], dst[order]
        if values is not None:
            values = values[order]
    counts = np.bincount(src, minlength=n)
    row_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=row_offsets[1:])
    return Graph.from_csr(row_offsets, dst, values, build_csc=build_csc,
                          sort_neighbors=False, device=device)


def row_segments_of(offsets: torch.Tensor) -> torch.Tensor:
    """The owning row of every edge slot of a CSR (or CSC) offsets array,
    int32 — what the build-time ``row_seg`` / ``csc_row_seg`` hold."""
    n = int(offsets.shape[0]) - 1
    return torch.repeat_interleave(
        torch.arange(n, dtype=torch.int32, device=offsets.device),
        (offsets[1:] - offsets[:-1]).long())


def edge_list(graph: Graph) -> tuple[np.ndarray, np.ndarray]:
    """The graph's (src, dst) edges in CSR order, as int32 host arrays."""
    ro = graph.row_offsets.cpu().numpy()
    src = np.repeat(np.arange(len(ro) - 1, dtype=np.int32), np.diff(ro))
    return src, graph.cols_np()


def rmat(scale: int, edge_factor: int = 16, a: float = 0.57,
         b: float = 0.19, c: float = 0.19, seed: int = 0,
         weighted: bool = False, undirected: bool = True,
         device=None) -> Graph:
    """R-MAT / Kronecker generator with the Graph500 initiator — the
    reference's generator, call for call, so the edges are identical."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = n * edge_factor
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    for level in range(scale):
        r = rng.random(m)
        go_right = ((r >= a) & (r < a + b)) | (r >= a + b + c)
        go_down = r >= a + b
        src |= go_down.astype(np.int64) << level
        dst |= go_right.astype(np.int64) << level
    perm = rng.permutation(n)
    src, dst = perm[src], perm[dst]
    values = (rng.integers(1, 64, size=m).astype(np.float32)
              if weighted else None)
    return from_edge_list(src, dst, n=n, values=values,
                          undirected=undirected, device=device)


def grid2d(side: int, weighted: bool = False, seed: int = 0,
           device=None) -> Graph:
    """2-D grid — the road-network stand-in (large diameter, small
    uniform degree)."""
    rng = np.random.default_rng(seed)
    idx = np.arange(side * side, dtype=np.int64).reshape(side, side)
    right = np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], axis=0)
    down = np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], axis=0)
    src = np.concatenate([right[0], down[0]])
    dst = np.concatenate([right[1], down[1]])
    values = (rng.integers(1, 64, size=len(src)).astype(np.float32)
              if weighted else None)
    return from_edge_list(src, dst, n=side * side, values=values,
                          undirected=True, device=device)

