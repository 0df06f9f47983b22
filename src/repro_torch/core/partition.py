"""Multi-device graph partitioning (counterpart of
``repro.core.partition``; paper §8.2.1 Scale-Out, Pan et al. [56]).

1-D contiguous vertex partition: part d owns vertices
[d·ceil(n/p), (d+1)·ceil(n/p)) and their out-edges (CSR rows); with a
CSC mirror, the mirror is cut the same way (part d owns the in-edges of
its vertices), so pull-direction algebra (PageRank's sweep, reach's CSC
SpMM) runs row-local and bit-equal to the single-device sweep. Per-part
slices are rebased and padded to the largest part (column pad -1).

2-D vertex-cut partition (placement "2d"): edges are blocked on an R×C
mesh — block (i, j) holds the edges whose source lies in row chunk i
(ceil(n/R) vertices) and whose destination lies in column chunk j
(ceil(n/C) vertices). Every vertex has one owner block (``owner_of``);
the other blocks touching it hold mirrors (``balance()``'s
``mirror_factor``).

The host-side containers (``PartitionedGraph``, ``Partitioned2DGraph``)
hold numpy arrays equal to the reference's field by field: the same
padding, ``verts_per_part`` = ceil(n/p), rebased offsets, ``edge_pos``,
``chunk_emax`` and ``balance()``. Whatever the source graph's storage
plan (int16 / int64 ids, delta columns, bf16 values), every part holds
dense int32 columns and float32 values (``SHARD_PLAN``): decoding is
exact, so results stay bit-equal.

The device views (``ShardedGraph``, ``Sharded2DGraph``, made by
``shard(mesh)`` and cached per (mesh, axis)) hold one tensor per part on
that part's device — not a stacked array — each padded exactly as the
reference's row of its stacked array, so stacking the parts gives the
reference's arrays. A ``Mesh`` is the port's stand-in for
``jax.sharding.Mesh``: one process drives every part (see
``core.distributed``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from . import storage as S
from .graph import Graph, ell_width_for

# what every part holds, whatever the source graph's plan chose
SHARD_PLAN = S.StoragePlan(index_dtype="int32", encoding="dense",
                           value_dtype="fp32")


def _indexed(device) -> torch.device:
    """``device`` as the tensors on it report it: a bare "cuda" is the
    current card, "cuda:0" on a one-card machine."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


@dataclass(frozen=True)
class Mesh:
    """The devices of a placement: ``devices`` lists part i's device in
    row-major order over ``shape`` ((p,) or (R, C)), ``axis_names`` names
    the axes. Several parts may share one device (``Mesh.on``)."""

    devices: tuple
    shape: tuple
    axis_names: tuple

    def __post_init__(self):
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} and axes "
                             f"{self.axis_names} differ in rank")
        if int(np.prod(self.shape)) != len(self.devices):
            raise ValueError(f"mesh shape {self.shape} needs "
                             f"{int(np.prod(self.shape))} devices, got "
                             f"{len(self.devices)}")

    @classmethod
    def on(cls, device, shape, axes) -> "Mesh":
        """Every part on one device (the CPU tests; the one card)."""
        shape = tuple(int(s) for s in shape)
        return cls((_indexed(device),) * int(np.prod(shape)), shape,
                   tuple(axes))

    @classmethod
    def over(cls, devices: Sequence, shape, axes) -> "Mesh":
        """Part i on ``devices[i mod len(devices)]`` (several cards)."""
        shape = tuple(int(s) for s in shape)
        devs = [_indexed(d) for d in devices]
        return cls(tuple(devs[i % len(devs)]
                         for i in range(int(np.prod(shape)))),
                   shape, tuple(axes))

    @property
    def root(self) -> torch.device:
        """Where collectives combine and replicated state lives."""
        return self.devices[0]

    def distinct(self) -> tuple:
        """The distinct devices, in part order."""
        return tuple(dict.fromkeys(self.devices))


def check_mesh_axis(mesh: Mesh, axis: str, num_parts: int) -> None:
    """``mesh`` carries a 1-D axis ``axis`` of size ``num_parts``."""
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    if sizes.get(axis) != num_parts:
        raise ValueError(
            f"mesh axis {axis!r} (size {sizes.get(axis)}) must match "
            f"the partition's {num_parts} parts")


def check_mesh_axes(mesh: Mesh, axes, shape) -> None:
    """2-D twin of ``check_mesh_axis``: ``axes`` = (row, col) exist on
    ``mesh`` with sizes ``shape`` = (R, C)."""
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    for ax, want in zip(axes, shape):
        if sizes.get(ax) != want:
            raise ValueError(
                f"mesh axis {ax!r} (size {sizes.get(ax)}) must match "
                f"the 2-D partition's {tuple(shape)} blocks")


def _host_csr(graph: Graph, side: str):
    """(offsets, dense int32 columns, float32 values|None) of a side of
    ``graph`` as host arrays — the decode every part's slice comes
    from."""
    if side == "csr":
        ro, ci, ev = graph.row_offsets, graph.cols(), graph.edge_values
    else:
        ro, ci, ev = (graph.csc_offsets, graph.csc_cols(),
                      graph.csc_edge_values)
    return (ro.cpu().numpy(), ci.cpu().numpy().astype(np.int32),
            None if ev is None else ev.float().cpu().numpy())


def _slice_rows(ro: np.ndarray, ci: np.ndarray, ev: Optional[np.ndarray],
                n: int, num_parts: int, vpp: int):
    """Rebase + pad per-part row slices of one CSR-like structure."""
    max_edges = 0
    slices = []
    for p in range(num_parts):
        lo_v = min(p * vpp, n)
        hi_v = min((p + 1) * vpp, n)
        lo_e, hi_e = int(ro[lo_v]), int(ro[hi_v])
        local_ro = ro[lo_v:hi_v + 1] - ro[lo_v]
        # pad the vertex dim (parts at the tail may own fewer vertices)
        pad_v = vpp - (hi_v - lo_v)
        if pad_v:
            local_ro = np.concatenate(
                [local_ro, np.full(pad_v, local_ro[-1], local_ro.dtype)])
        slices.append((local_ro, ci[lo_e:hi_e],
                       ev[lo_e:hi_e] if ev is not None else None, lo_v))
        max_edges = max(max_edges, hi_e - lo_e)
    max_edges = max(max_edges, 1)
    p_ro = np.stack([s[0] for s in slices]).astype(np.int32)
    p_ci = np.full((num_parts, max_edges), -1, np.int32)
    p_ev = (np.zeros((num_parts, max_edges), np.float32)
            if ev is not None else None)
    base = np.zeros((num_parts,), np.int32)
    for p, (_, c, v, lo_v) in enumerate(slices):
        p_ci[p, :len(c)] = c
        if v is not None:
            p_ev[p, :len(v)] = v
        base[p] = lo_v
    return p_ro, p_ci, p_ev, base


def _put(arr: Optional[np.ndarray], devices) -> Optional[tuple]:
    """One tensor per part: row i of ``arr`` on ``devices[i]``."""
    if arr is None:
        return None
    return tuple(torch.from_numpy(np.ascontiguousarray(arr[i])).to(d)
                 for i, d in enumerate(devices))


def _shard_cache(obj) -> dict:
    cache = obj.__dict__.get("_shard_cache")
    if cache is None:
        object.__setattr__(obj, "_shard_cache", {})   # frozen dataclass
        cache = obj.__dict__["_shard_cache"]
    return cache


@dataclass(frozen=True)
class PartitionedGraph:
    """Host-side stacked per-part CSR (+ CSC) slices (leading axis =
    part). ``source`` keeps the unpartitioned Graph for replicated
    operands (mxm's probe side, oracles, degree vectors)."""

    n: int
    m: int
    num_parts: int
    verts_per_part: int        # ceil(n / p)
    row_offsets: np.ndarray    # (p, vpp+1) rebased local CSR
    col_indices: np.ndarray    # (p, max_local_edges) global dst ids, pad -1
    edge_values: Optional[np.ndarray]
    vertex_base: np.ndarray    # (p,) first global vertex id of each part
    csc_row_offsets: Optional[np.ndarray] = None
    csc_col_indices: Optional[np.ndarray] = None
    csc_edge_values: Optional[np.ndarray] = None
    source: Optional[Graph] = None

    @property
    def max_local_edges(self) -> int:
        return int(self.col_indices.shape[1])

    @property
    def has_csc(self) -> bool:
        return self.csc_row_offsets is not None

    def owner_of(self, v: np.ndarray) -> np.ndarray:
        return v // self.verts_per_part

    def balance(self) -> dict:
        """Per-part load: owned vertex and edge counts and both
        imbalance factors (max/mean; 1.0 is perfect balance)."""
        verts = [int(min((p + 1) * self.verts_per_part, self.n)
                     - min(p * self.verts_per_part, self.n))
                 for p in range(self.num_parts)]
        edges = [int(self.row_offsets[p, -1]) for p in range(self.num_parts)]
        mean_e = max(sum(edges) / max(self.num_parts, 1), 1e-9)
        mean_v = max(sum(verts) / max(self.num_parts, 1), 1e-9)
        return {
            "parts": self.num_parts,
            "vertices_per_part": verts,
            "edges_per_part": edges,
            "edge_imbalance": round(max(edges) / mean_e, 3),
            "vertex_imbalance": round(max(verts) / mean_v, 3),
        }

    def shard(self, mesh: Mesh, axis: str = "graph") -> "ShardedGraph":
        """The device view: part i's slices on ``mesh.devices[i]``,
        made once per (mesh, axis)."""
        check_mesh_axis(mesh, axis, self.num_parts)
        cache = _shard_cache(self)
        key = (mesh, axis)
        if key not in cache:
            d = mesh.devices
            src = self.source
            cache[key] = ShardedGraph(
                row_offsets=_put(self.row_offsets, d),
                col_indices=_put(self.col_indices, d),
                edge_values=_put(self.edge_values, d),
                csc_offsets=_put(self.csc_row_offsets, d),
                csc_indices=_put(self.csc_col_indices, d),
                csc_edge_values=_put(self.csc_edge_values, d),
                vertex_base=self.vertex_base,
                n=self.n, m=self.m, verts_per_part=self.verts_per_part,
                mesh=mesh, axis=axis,
                ell_width=None if src is None else src.ell_width,
                csc_ell_width=None if src is None else src.csc_ell_width,
                source_plan=None if src is None else src.plan)
        return cache[key]


@dataclass(frozen=True)
class ShardedGraph:
    """Per-part graph slices on their devices. Attribute names mirror
    ``Graph``, so primitives written against a Graph run on it with only
    the dispatched op changed: ``row_offsets`` (and every other edge
    field) is a tuple of one tensor per part; the sharded registry
    providers read that layout. ELL widths are the SOURCE graph's (the
    sharded SpMV folds each row with the single-device tree shape)."""

    row_offsets: tuple                # p × (vpp+1,) int32
    col_indices: tuple                # p × (max_local_edges,) int32
    edge_values: Optional[tuple]
    csc_offsets: Optional[tuple]
    csc_indices: Optional[tuple]
    csc_edge_values: Optional[tuple]
    vertex_base: np.ndarray           # (p,) host
    n: int
    m: int
    verts_per_part: int
    mesh: Mesh
    axis: str
    ell_width: Optional[int] = None
    csc_ell_width: Optional[int] = None
    source_plan: Optional[S.StoragePlan] = None
    cache: dict = field(default_factory=dict, compare=False, repr=False)

    # per-part edge→row maps and overflow lists are derived by the
    # providers (local offsets differ per part)
    row_seg = None
    csc_row_seg = None
    over_pos = None
    over_row = None
    csc_over_pos = None
    csc_over_row = None

    __hash__ = object.__hash__
    __eq__ = object.__eq__

    @property
    def num_vertices(self) -> int:
        return self.n

    @property
    def num_edges(self) -> int:
        return self.m

    @property
    def num_parts(self) -> int:
        return len(self.row_offsets)

    @property
    def device(self) -> torch.device:
        """The mesh's root device: replicated state lives there."""
        return self.mesh.root

    @property
    def has_csc(self) -> bool:
        return self.csc_offsets is not None

    @property
    def weighted(self) -> bool:
        return self.edge_values is not None

    @property
    def plan(self) -> S.StoragePlan:
        """The parts' own plan (always SHARD_PLAN); the source graph's
        is ``source_plan``."""
        return SHARD_PLAN

    @property
    def col_store(self) -> tuple:
        return self.col_indices

    @property
    def csc_store(self) -> Optional[tuple]:
        return self.csc_indices

    @property
    def degrees(self) -> torch.Tensor:
        """Global out-degree vector (n,) on the root device (pad rows
        repeat the final offset, so their degree is 0)."""
        root = self.device
        local = [(ro[1:] - ro[:-1]).to(root) for ro in self.row_offsets]
        return torch.cat(local)[:self.n]


# ---------------------------------------------------------------------------
# 2-D vertex-cut partition (placement "2d")
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Blocks2D:
    """The column-store operand of a ``Sharded2DGraph``: per-block
    column ids plus the block↔row-chunk alignment the exact 2-D semiring
    providers need. ``epos`` maps every block edge to its position in
    its row chunk's 1-D CSR slice (``chunk_ro``): the blocks of a mesh
    row scatter their per-edge products into disjoint slots of one
    (chunk_emax,) buffer and ⊕-merge identities only, so the per-row
    fold that follows replays the single-device sequence."""

    cols: tuple           # R·C × (be,) global dst ids, pad -1
    epos: tuple           # R·C × (be,) edge position in the row chunk
    chunk_ro: tuple       # R·C × (vpr+1,) row-chunk offsets (col-repl.)
    chunk_emax: int


def _slice_blocks(ro: np.ndarray, ci: np.ndarray, ev: Optional[np.ndarray],
                  n: int, rows: int, cols: int, vpr: int, vpc: int):
    """Block one CSR-like structure on the R×C vertex cut: stacked
    (R, C, …) block arrays (rebased offsets, global column ids padded
    with -1, values, row-chunk edge positions), the (R, vpr+1) row-chunk
    offsets, the largest chunk's edge count, and the per-block edge
    counts, ELL widths and vertex copies (the mirror table)."""
    blocks: list = []
    chunk_ros = []
    be_max, chunk_emax = 1, 1
    block_edges = np.zeros((rows, cols), np.int64)
    block_ell = np.ones((rows, cols), np.int64)
    mirrors = np.zeros((rows, cols), np.int64)
    for i in range(rows):
        lo_v = min(i * vpr, n)
        hi_v = min((i + 1) * vpr, n)
        lo_e, hi_e = int(ro[lo_v]), int(ro[hi_v])
        cro = (ro[lo_v:hi_v + 1] - ro[lo_v]).astype(np.int64)
        pad_v = vpr - (hi_v - lo_v)
        if pad_v:
            cro = np.concatenate([cro, np.full(pad_v, cro[-1], cro.dtype)])
        chunk_ros.append(cro)
        chunk_emax = max(chunk_emax, hi_e - lo_e)
        c_ci = ci[lo_e:hi_e]
        c_ev = ev[lo_e:hi_e] if ev is not None else None
        epos = np.arange(hi_e - lo_e, dtype=np.int64)
        row_of = np.repeat(np.arange(hi_v - lo_v),
                           np.diff(ro[lo_v:hi_v + 1]))
        row_blocks = []
        for j in range(cols):
            sel = (c_ci >= j * vpc) & (c_ci < (j + 1) * vpc)
            cnt = np.bincount(row_of[sel], minlength=vpr)[:vpr]
            b_ro = np.concatenate([[0], np.cumsum(cnt)]).astype(np.int32)
            b_ci = c_ci[sel]
            row_blocks.append((b_ro, b_ci,
                               c_ev[sel] if c_ev is not None else None,
                               epos[sel]))
            ne = int(sel.sum(dtype=np.int64))
            be_max = max(be_max, ne)
            block_edges[i, j] = ne
            block_ell[i, j] = ell_width_for(cnt[cnt > 0])
            # vertex copies on block (i, j): distinct source rows with a
            # block edge + distinct destinations (counted by a bincount,
            # which gives np.unique's count at a fraction of its time)
            dst = (np.count_nonzero(np.bincount(b_ci - j * vpc))
                   if ne else 0)
            mirrors[i, j] = int((cnt > 0).sum(dtype=np.int64)) + dst
        blocks.append(row_blocks)
    b_ro = np.stack([np.stack([b[0] for b in r]) for r in blocks])
    b_ci = np.full((rows, cols, be_max), -1, np.int32)
    b_ep = np.zeros((rows, cols, be_max), np.int32)
    b_ev = (np.zeros((rows, cols, be_max), np.float32)
            if ev is not None else None)
    for i in range(rows):
        for j in range(cols):
            _, c, v, e = blocks[i][j]
            b_ci[i, j, :len(c)] = c
            b_ep[i, j, :len(e)] = e
            if v is not None:
                b_ev[i, j, :len(v)] = v
    chunk_ro = np.stack(chunk_ros).astype(np.int32)
    return (b_ro, b_ci, b_ev, b_ep, chunk_ro, int(chunk_emax),
            block_edges, block_ell, mirrors)


def partition_1d(graph: Graph, num_parts: int) -> PartitionedGraph:
    """The 1-D row partition of ``graph`` into ``num_parts`` parts
    (dense int32 / float32 slices whatever the source plan)."""
    n = graph.num_vertices
    vpp = -(-n // num_parts)  # ceil
    ro, ci, ev = _host_csr(graph, "csr")
    p_ro, p_ci, p_ev, base = _slice_rows(ro, ci, ev, n, num_parts, vpp)
    c_ro = c_ci = c_ev = None
    if graph.has_csc:
        c_ro, c_ci, c_ev, _ = _slice_rows(*_host_csr(graph, "csc"), n,
                                          num_parts, vpp)
    return PartitionedGraph(n=n, m=graph.num_edges, num_parts=num_parts,
                            verts_per_part=vpp, row_offsets=p_ro,
                            col_indices=p_ci, edge_values=p_ev,
                            vertex_base=base,
                            csc_row_offsets=c_ro, csc_col_indices=c_ci,
                            csc_edge_values=c_ev, source=graph)


@dataclass(frozen=True)
class Partitioned2DGraph:
    """Host-side R×C vertex-cut edge blocks + mirror/balance accounting.
    ``chunk_offsets`` keeps each row chunk's un-blocked 1-D CSR offsets
    (the fold shape the 2-D semiring providers replay after merging
    block products) and ``edge_pos`` aligns every block edge into it."""

    n: int
    m: int
    rows: int                    # R
    cols: int                    # C
    vpr: int                     # ceil(n / R): row-chunk vertices
    vpc: int                     # ceil(n / C): column-chunk vertices
    row_offsets: np.ndarray      # (R, C, vpr+1) rebased block CSR
    col_indices: np.ndarray      # (R, C, be) global dst ids, pad -1
    edge_values: Optional[np.ndarray]
    edge_pos: np.ndarray         # (R, C, be) position in the row chunk
    chunk_offsets: np.ndarray    # (R, vpr+1) row-chunk CSR offsets
    chunk_emax: int
    row_base: np.ndarray         # (R,) first vertex id of each row chunk
    col_base: np.ndarray         # (C,) first vertex id of each col chunk
    block_edges: np.ndarray      # (R, C)
    block_ell_width: np.ndarray  # (R, C)
    mirrors: np.ndarray          # (R, C) vertex copies per block
    csc_row_offsets: Optional[np.ndarray] = None
    csc_col_indices: Optional[np.ndarray] = None
    csc_edge_values: Optional[np.ndarray] = None
    csc_edge_pos: Optional[np.ndarray] = None
    csc_chunk_offsets: Optional[np.ndarray] = None
    csc_chunk_emax: int = 1
    source: Optional[Graph] = None

    @property
    def num_parts(self) -> int:
        return self.rows * self.cols

    @property
    def has_csc(self) -> bool:
        return self.csc_row_offsets is not None

    def owner_of(self, v):
        """Owner block (mesh row, mesh col) of vertex v: the block whose
        row chunk and column chunk both contain v."""
        v = np.asarray(v)
        return (np.minimum(v // self.vpr, self.rows - 1),
                np.minimum(v // self.vpc, self.cols - 1))

    def balance(self) -> dict:
        """2-D load: per-block edge counts, both imbalance factors and
        the vertex-cut replication (mean copies of a vertex, the largest
        block's copies)."""
        edges = self.block_edges
        mean_e = max(edges.sum() / max(self.num_parts, 1), 1e-9)
        verts = [int(min((i + 1) * self.vpr, self.n)
                     - min(i * self.vpr, self.n))
                 for i in range(self.rows)]
        mean_v = max(sum(verts) / max(self.rows, 1), 1e-9)
        return {
            "parts": self.num_parts,
            "mesh": [self.rows, self.cols],
            "vertices_per_chunk": verts,
            "edges_per_block": edges.astype(int).tolist(),
            "edge_imbalance": round(float(edges.max()) / mean_e, 3),
            "vertex_imbalance": round(max(verts) / mean_v, 3),
            "block_ell_width": self.block_ell_width.astype(int).tolist(),
            "mirror_factor": round(float(self.mirrors.sum())
                                   / max(self.n, 1), 3),
            "max_block_mirrors": int(self.mirrors.max()),
        }

    def shard(self, mesh: Mesh, axes=("row", "col")) -> "Sharded2DGraph":
        """The device view: block (i, j) on ``mesh.devices[i·C + j]``,
        made once per (mesh, axes)."""
        axes = tuple(axes)
        check_mesh_axes(mesh, axes, (self.rows, self.cols))
        cache = _shard_cache(self)
        key = (mesh, axes)
        if key in cache:
            return cache[key]
        d = mesh.devices
        R, C = self.rows, self.cols

        def blocks(arr):
            return None if arr is None else _put(arr.reshape(
                (R * C,) + arr.shape[2:]), d)

        def chunks(chunk_ro):
            # the row chunk's offsets beside each of its blocks, one copy
            # per distinct device
            if chunk_ro is None:
                return None
            per_dev: dict = {}
            out = []
            for b in range(R * C):
                key_b = (b // C, d[b])
                if key_b not in per_dev:
                    per_dev[key_b] = torch.from_numpy(
                        np.ascontiguousarray(chunk_ro[b // C])).to(d[b])
                out.append(per_dev[key_b])
            return tuple(out)

        src = self.source
        cache[key] = Sharded2DGraph(
            row_offsets=blocks(self.row_offsets),
            col_indices=blocks(self.col_indices),
            edge_values=blocks(self.edge_values),
            edge_pos=blocks(self.edge_pos),
            chunk_offsets=chunks(self.chunk_offsets),
            csc_offsets=blocks(self.csc_row_offsets),
            csc_indices=blocks(self.csc_col_indices),
            csc_edge_values=blocks(self.csc_edge_values),
            csc_edge_pos=blocks(self.csc_edge_pos),
            csc_chunk_offsets=chunks(self.csc_chunk_offsets),
            row_base=self.row_base, col_base=self.col_base,
            n=self.n, m=self.m, rows=R, cols=C, vpr=self.vpr, vpc=self.vpc,
            chunk_emax=self.chunk_emax, csc_chunk_emax=self.csc_chunk_emax,
            mesh=mesh, axes=axes,
            ell_width=None if src is None else src.ell_width,
            csc_ell_width=None if src is None else src.csc_ell_width,
            source_plan=None if src is None else src.plan)
        return cache[key]


@dataclass(frozen=True)
class Sharded2DGraph:
    """Per-block graph slices on their devices (block (i, j) at flat
    index i·C + j). Attribute names mirror ``Graph``; ``col_store`` /
    ``csc_store`` are ``Blocks2D`` operands carrying the chunk alignment
    the 2-D semiring providers consume in the contract's column slot."""

    row_offsets: tuple                # R·C × (vpr+1,)
    col_indices: tuple                # R·C × (be,)
    edge_values: Optional[tuple]
    edge_pos: tuple                   # R·C × (be,)
    chunk_offsets: tuple              # R·C × (vpr+1,) column-replicated
    csc_offsets: Optional[tuple]
    csc_indices: Optional[tuple]
    csc_edge_values: Optional[tuple]
    csc_edge_pos: Optional[tuple]
    csc_chunk_offsets: Optional[tuple]
    row_base: np.ndarray              # (R,) host
    col_base: np.ndarray              # (C,) host
    n: int
    m: int
    rows: int
    cols: int
    vpr: int
    vpc: int
    chunk_emax: int
    csc_chunk_emax: int
    mesh: Mesh
    axes: tuple
    ell_width: Optional[int] = None
    csc_ell_width: Optional[int] = None
    source_plan: Optional[S.StoragePlan] = None
    cache: dict = field(default_factory=dict, compare=False, repr=False)

    row_seg = None
    csc_row_seg = None
    over_pos = None
    over_row = None
    csc_over_pos = None
    csc_over_row = None

    __hash__ = object.__hash__
    __eq__ = object.__eq__

    @property
    def num_vertices(self) -> int:
        return self.n

    @property
    def num_edges(self) -> int:
        return self.m

    @property
    def num_parts(self) -> int:
        return self.rows * self.cols

    @property
    def device(self) -> torch.device:
        return self.mesh.root

    @property
    def has_csc(self) -> bool:
        return self.csc_offsets is not None

    @property
    def weighted(self) -> bool:
        return self.edge_values is not None

    @property
    def plan(self) -> S.StoragePlan:
        return SHARD_PLAN

    @property
    def col_store(self) -> Blocks2D:
        return Blocks2D(cols=self.col_indices, epos=self.edge_pos,
                        chunk_ro=self.chunk_offsets,
                        chunk_emax=self.chunk_emax)

    @property
    def csc_store(self) -> Blocks2D:
        return Blocks2D(cols=self.csc_indices, epos=self.csc_edge_pos,
                        chunk_ro=self.csc_chunk_offsets,
                        chunk_emax=self.csc_chunk_emax)

    @property
    def degrees(self) -> torch.Tensor:
        """Global out-degree vector (n,) on the root device, from the
        row-chunk offsets of each mesh row's first block."""
        root = self.device
        local = [(self.chunk_offsets[i * self.cols][1:]
                  - self.chunk_offsets[i * self.cols][:-1]).to(root)
                 for i in range(self.rows)]
        return torch.cat(local)[:self.n]


def partition_2d(graph: Graph, rows: int, cols: int) -> Partitioned2DGraph:
    """Vertex-cut 2-D partition of ``graph`` on an R×C mesh (dense
    int32 / float32 blocks whatever the source plan)."""
    n = graph.num_vertices
    vpr = -(-n // rows)
    vpc = -(-n // cols)
    ro, ci, ev = _host_csr(graph, "csr")
    (b_ro, b_ci, b_ev, b_ep, chunk_ro, chunk_emax,
     block_edges, block_ell, mirrors) = _slice_blocks(
        ro, ci, ev, n, rows, cols, vpr, vpc)
    kw: dict = {}
    if graph.has_csc:
        (c_ro, c_ci, c_ev, c_ep, c_cro, c_emax, _, _, _) = _slice_blocks(
            *_host_csr(graph, "csc"), n, rows, cols, vpr, vpc)
        kw = dict(csc_row_offsets=c_ro, csc_col_indices=c_ci,
                  csc_edge_values=c_ev, csc_edge_pos=c_ep,
                  csc_chunk_offsets=c_cro, csc_chunk_emax=c_emax)
    return Partitioned2DGraph(
        n=n, m=graph.num_edges, rows=rows, cols=cols, vpr=vpr, vpc=vpc,
        row_offsets=b_ro, col_indices=b_ci, edge_values=b_ev,
        edge_pos=b_ep, chunk_offsets=chunk_ro, chunk_emax=chunk_emax,
        row_base=(np.arange(rows) * vpr).astype(np.int32),
        col_base=(np.arange(cols) * vpc).astype(np.int32),
        block_edges=block_edges, block_ell_width=block_ell,
        mirrors=mirrors, source=graph, **kw)
