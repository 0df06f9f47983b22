"""Distributed graph primitives and the placement providers (counterpart
of ``repro.core.distributed``; paper §8.2.1, Pan et al. [56]).

Gunrock's multi-GPU design keeps the single-GPU engine and adds
partition and communication modules; so does this one, behind the
registry's *placement* dimension: this module registers the
``"sharded"`` (1-D rows, ``partition_1d``) and ``"2d"`` (R×C vertex
cut, ``partition_2d``) providers of advance, advance_filter, spmv, spmm
and mxm, and the whole-loop traversals over a partition.

**One process drives the mesh**, as in the reference, whose one
controller runs ``shard_map`` over a ``jax.sharding.Mesh``. Here a
provider walks the parts itself: each part's sweep runs on its own
device (``Mesh``: part i on ``mesh.devices[i]``), and the parts combine
through the explicit collectives below. There is no
``torch.distributed``: a process group needs a process per card, NCCL
refuses two ranks on one card, and a single-controller mesh runs
unchanged on the CPU, on one card (every part on it) and on several.

Collectives, each with a fixed fold order (part order, or row / column
order on a 2-D mesh): the combine happens on the first part's device and
the result is copied to each part's device (nothing to copy where parts
share one):

  ``all_reduce(parts, op)``          op ∈ sum | or | min | max
  ``all_gather(parts)``              concatenation in part order
  ``axis_all_reduce(parts, shape, axis, op)``
                                     the row-axis (axis 0: over i at a
                                     fixed j) and column-axis (axis 1:
                                     over j at a fixed i) forms the 2-D
                                     providers use; their column-axis
                                     gather is ``all_gather`` over one
                                     mesh row's chunks.

Replicated (n,) state — labels, distances, the frontier bitmask, the
rank vector — lives once per distinct device (``replicate``), not once
per part. The traversal loops keep it on the mesh's root device and
read the host once a BSP step, as the port's enactor does; the loop
bounds are the reference's (``it <= n``; SSSP ``it < 4n + 8``).

Exchange strategies (the reference's):

  * 1-D "advance": each part expands its owned frontier slice into a
    global (n,) discovered bitmask; the masks OR-combine.
  * 1-D "spmv" / "spmm": each part folds its own rows with the
    single-device dataflow (the same ELL tree and ascending-order
    overflow fold), the row blocks concatenate — no sum crosses parts,
    so the bits equal the single-device sweep's.
  * 1-D "mxm": the expansion side is row-partitioned, the probe side
    replicated; per-edge partials ⊕-combine (one owner per edge, so the
    combine meets identities only).
  * 2-D "advance" / "advance_filter": block (i, j) expands into a
    ceil(n/C) column-chunk mask; the R blocks of mesh column j
    OR-combine it (the row-axis reduce), the visited filter applies to
    the merged chunk, and the C chunks gather into (n,). The reference
    cuts the block's edges into tiles and double-buffers them so XLA
    overlaps the collective with the next tile; a single-controller loop
    has no such overlap and OR is order-free, so the port walks one tile
    (``DEFAULT_EXCHANGE_TILES`` only sets the byte model of
    ``exchange_bytes_per_step``).
  * 2-D "spmv" / "spmm": pre-fold product exchange — each block scatters
    its per-edge products to their row-chunk slots (``Blocks2D.epos``),
    the blocks of a mesh row ⊕-merge (disjoint slots: identities only),
    and the merged chunk replays the single-device fold
    (``linalg.ops.fold_products``).
  * 2-D "mxm": every block expands its slice of the mask edges its mesh
    row owns; partials ⊕-combine over the whole mesh (exact for the
    exact ⊕ and for integer-valued sums such as triangle counts).

Kernels under a placement: the reference's placement providers reach no
Pallas kernel (its ``pallas`` dispatch under a placement runs the
``xla`` provider), so here a ``cuda`` dispatch under ``"sharded"`` /
``"2d"`` runs these providers (``core.backend``) and launches no
kernel. A float plus fold on the card adds in ascending order through
``linalg.ops.ordered_scatter_accum``, so PageRank's ranks stay equal to
the single-device sweep's there too.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..analysis import sanitize
from . import backend as B
from .partition import (Mesh, Partitioned2DGraph, check_mesh_axes,
                        check_mesh_axis)

INT_BIG = 2 ** 30
INF = float("inf")

# edge tiles of the reference's 2-D bitmask exchange (its overlap depth);
# read only by the byte model, ``exchange_bytes_per_step``
DEFAULT_EXCHANGE_TILES = 2


class DistBFSResult(NamedTuple):
    labels: torch.Tensor   # (n,) global depths
    iterations: int


class DistSSSPResult(NamedTuple):
    dist: torch.Tensor     # (n,) float32 distances
    iterations: int


class DistCCResult(NamedTuple):
    labels: torch.Tensor
    num_components: int
    iterations: int


# ---------------------------------------------------------------------------
# collectives (fixed fold order; combine on the first part's device)
# ---------------------------------------------------------------------------

_FOLD = {"sum": torch.add, "or": torch.logical_or,
         "min": torch.minimum, "max": torch.maximum}


def _sr_op(sr) -> str:
    return {"plus": "sum", "min": "min"}.get(sr.add, "max")   # max | or


def replicate(x: torch.Tensor, devices: Sequence) -> dict:
    """``x`` once on each distinct device: {device: tensor} (``x``
    itself on its own device)."""
    out = {}
    for d in devices:
        if d not in out:
            out[d] = x if x.device == d else x.to(d)
    return out


def _fold(parts: Sequence[torch.Tensor], op: str) -> torch.Tensor:
    root = parts[0].device
    acc = parts[0]
    for p in parts[1:]:
        acc = _FOLD[op](acc, p.to(root))
    return acc


def _scatter_back(x: torch.Tensor, parts) -> list:
    reps = replicate(x, [p.device for p in parts])
    return [reps[p.device] for p in parts]


def all_reduce(parts: Sequence[torch.Tensor], op: str) -> list:
    """⊕-combine the parts' tensors in part order on the first part's
    device; each part gets the result on its own device."""
    return _scatter_back(_fold(parts, op), parts)


def all_gather(parts: Sequence[torch.Tensor]) -> list:
    """Concatenate the parts' tensors in part order on the first part's
    device; each part gets the whole on its own device."""
    root = parts[0].device
    return _scatter_back(torch.cat([p.to(root) for p in parts]), parts)


def _groups(shape, axis: int) -> list:
    """Flat part indices of each group a 2-D axis collective combines:
    axis 0 (the row axis) groups one mesh column's R blocks, axis 1 one
    mesh row's C blocks."""
    r, c = shape
    if axis == 0:
        return [[i * c + j for i in range(r)] for j in range(c)]
    return [[i * c + j for j in range(c)] for i in range(r)]


def axis_all_reduce(parts: Sequence[torch.Tensor], shape, axis: int,
                    op: str) -> list:
    """The row-axis (``axis=0``) or column-axis (``axis=1``) all-reduce
    of a 2-D mesh: each group combines in index order on its first
    block's device."""
    out = [None] * len(parts)
    for grp in _groups(shape, axis):
        for b, t in zip(grp, all_reduce([parts[b] for b in grp], op)):
            out[b] = t
    return out


# ---------------------------------------------------------------------------
# placement plumbing
# ---------------------------------------------------------------------------


def _axes_arg(axis) -> tuple:
    """The (row, col) axis pair of a 2-D entry point: an explicit pair
    passes through, the 1-D default maps to ("row", "col")."""
    if isinstance(axis, (tuple, list)):
        if len(axis) != 2:
            raise ValueError(f"2-D placement needs two mesh axes, got "
                             f"{tuple(axis)}")
        return tuple(axis)
    return ("row", "col")


def _check_mesh(pg, mesh: Mesh, axis) -> None:
    if isinstance(pg, Partitioned2DGraph):
        check_mesh_axes(mesh, _axes_arg(axis), (pg.rows, pg.cols))
    else:
        check_mesh_axis(mesh, axis, pg.num_parts)


def _shard_any(pg, mesh: Mesh, axis):
    """Shard either partition container on its mesh."""
    if isinstance(pg, Partitioned2DGraph):
        return pg.shard(mesh, _axes_arg(axis))
    return pg.shard(mesh, axis)


def _require_placement_mesh():
    ctx = B.placement_mesh()
    if ctx is None:
        raise RuntimeError(
            "distributed dispatch needs an active placement context "
            "that carries a mesh: with backend.use_placement('sharded', "
            "mesh=mesh, axis='graph'): ... (or '2d' with "
            "axis=('row', 'col'))")
    return ctx


def _require_2d_mesh():
    mesh, axes = _require_placement_mesh()
    if not (isinstance(axes, tuple) and len(axes) == 2):
        raise RuntimeError(
            "2d providers need a (row, col) mesh-axis pair: "
            "use_placement('2d', mesh=mesh, axis=('row', 'col')) — "
            f"got axis={axes!r}")
    return mesh, axes


# ---------------------------------------------------------------------------
# local sweeps (the per-part half of each exchange)
# ---------------------------------------------------------------------------


def _local_slots(local_ro: torch.Tensor, local_ci: torch.Tensor, vpp: int,
                 cache: Optional[dict] = None):
    """(local source row, validity) of every slot of a part's CSR slice;
    kept in ``cache`` per offsets tensor."""
    key = ("slots", local_ro.data_ptr(), local_ci.data_ptr(), vpp)
    if cache is not None and key in cache:
        return cache[key]
    me = int(local_ci.shape[0])
    slot = torch.arange(me, dtype=local_ro.dtype, device=local_ro.device)
    src = torch.searchsorted(local_ro, slot, right=True) - 1
    src = src.clamp(0, vpp - 1)
    valid = (slot < local_ro[-1]) & (local_ci >= 0)
    out = (src, valid)
    if cache is not None:
        cache[key] = out
        sanitize.note_setup()
    return out


def _owned_slice(vec: torch.Tensor, base: int, vpp: int, fill=0):
    """The (vpp,) owned slice of a replicated vector; the vector is
    padded by one part first, so a tail part whose range passes n reads
    pad lanes (the reference's clamped ``dynamic_slice`` the same way)."""
    pad = torch.full((vpp,), fill, dtype=vec.dtype, device=vec.device)
    return torch.cat([vec, pad])[int(base):int(base) + vpp]


def _scatter_mask(n: int, tgt: torch.Tensor, dtype=torch.bool):
    """(n,) mask set at ``tgt`` (targets equal to n are dropped)."""
    mask = torch.zeros((n + 1,), dtype=dtype, device=tgt.device)
    mask[tgt.long()] = 1
    return mask[:n]


def _scatter_min(n: int, tgt: torch.Tensor, vals: torch.Tensor, fill):
    """(n,) min-scatter of ``vals`` at ``tgt`` over a ``fill``
    background (targets equal to n are dropped)."""
    out = torch.full((n + 1,), fill, dtype=vals.dtype, device=vals.device)
    out.scatter_reduce_(0, tgt.long(), vals, "amin")
    return out[:n]


# ---------------------------------------------------------------------------
# 1-D providers (placement "sharded")
# ---------------------------------------------------------------------------


@B.register("advance", B.TORCH, B.SHARDED)
def _advance_bitmask_exchange(local_ro, local_ci, frontier, base, vpp: int,
                              axis=None, cache=None):
    """Bitmask-exchange advance step. One controller runs every part:
    ``local_ro`` / ``local_ci`` are the parts' tuples, ``base`` their
    first vertices, ``frontier`` the (n,) bool frontier on the root
    device. Returns the OR-combined (n,) discovered mask there."""
    del axis
    n = int(frontier.shape[0])
    reps = replicate(frontier, [ro.device for ro in local_ro])
    disc = []
    for p, (ro, ci) in enumerate(zip(local_ro, local_ci)):
        src, valid = _local_slots(ro, ci, vpp, cache)
        mine = _owned_slice(reps[ro.device], base[p], vpp, False)
        active = mine[src] & valid
        disc.append(_scatter_mask(n, torch.where(active, ci, n)))
    return all_reduce(disc, "or")[0]


def _fold_rows(sr, seg: torch.Tensor, prod: torch.Tensor, nrows: int):
    """(nrows, k) ⊕-fold of ``prod`` rows by segment id: the reference's
    segment reduce, as the single-device torch SpMM folds (a plus fold
    from 0 in slot order on the CPU, with atomics on the card — exact
    there for integer-valued sums such as label propagation's votes; min
    and max in any order)."""
    from ..linalg.ops import _segment_fold
    return _segment_fold(sr, seg, prod, nrows)


@B.register("spmm", B.TORCH, B.SHARDED)
def _spmm_sharded(offsets, indices, values, x, sr, ell_width, mask,
                  row_seg=None, cache=None):
    """1-D row-partitioned semiring SpMM ``Y⟨mask⟩ = A ⊗ X``: each part
    folds its own rows with the single-device gather + segment fold, the
    row blocks concatenate (x replicated; square operand)."""
    del ell_width, row_seg
    _require_placement_mesh()
    vpp = int(offsets[0].shape[0]) - 1
    n = int(x.shape[0])
    reps = replicate(x, [ro.device for ro in offsets])
    ys = []
    for p, (ro, ci) in enumerate(zip(offsets, indices)):
        src, valid = _local_slots(ro, ci, vpp, cache)
        xv = reps[ro.device][torch.where(valid, ci, 0).long()]
        ev = None if values is None else values[p]
        prod = xv if ev is None else sr.mul_op(ev[:, None], xv)
        prod = torch.where(valid[:, None], prod, sr.zero)
        y = _fold_rows(sr, src, prod.to(torch.float32), vpp)
        deg = ro[1:] - ro[:-1]
        ys.append(torch.where((deg > 0)[:, None], y, sr.zero))
    y = all_gather(ys)[0][:n]
    if mask is not None:
        y = torch.where(mask[:, None], y, sr.zero)
    return y.to(torch.float32)


@B.register("spmv", B.TORCH, B.SHARDED)
def _spmv_sharded(offsets, indices, values, x, sr, ell_width, mask,
                  row_seg=None, over_pos=None, over_row=None, cache=None):
    """1-D row-partitioned semiring SpMV: each part runs the
    single-device hybrid ELL tree + ascending overflow fold on its own
    rows (the source graph's ELL width), so the bits equal the
    single-device sweep's. Without a width: the k = 1 SpMM column."""
    del row_seg, over_pos, over_row
    if ell_width is None:
        return _spmm_sharded(offsets, indices, values, x[:, None], sr,
                             None, mask, cache=cache)[:, 0]
    from ..linalg.ops import hybrid_ell_reduce
    _require_placement_mesh()
    n = int(x.shape[0])
    reps = replicate(x, [ro.device for ro in offsets])
    ys = []
    for p, (ro, ci) in enumerate(zip(offsets, indices)):
        me = int(ci.shape[0])
        edge_valid = torch.arange(me, device=ro.device) < ro[-1]
        y = hybrid_ell_reduce(ro, ci, None if values is None else values[p],
                              reps[ro.device], sr, int(ell_width), None,
                              None, edge_valid=edge_valid, cache=cache)
        deg = ro[1:] - ro[:-1]
        ys.append(torch.where(deg > 0, y, sr.zero))
    y = all_gather(ys)[0][:n]
    if mask is not None:
        y = torch.where(mask, y, sr.zero)
    return y.to(torch.float32)


# advance_filter has no 1-D provider by design: the fused predicate
# needs the visited bitmap coherent per tile, and the 1-D exchange
# reconciles it only once a step; 1-D BFS composes advance and a filter.
B.declare_fallback(
    "advance_filter", B.SHARDED,
    reason="1-D exchange cannot keep the visited bitmap coherent inside "
           "a fused tile sweep; sharded BFS composes advance + filter "
           "around the frontier exchange instead")


def _mxm_partial(ao, ai, av, bt, base_g, rows_g, lo_v: int, hi_v: int,
                 sr, cap_out: int):
    """One part's share of a masked SpGEMM: expand the mask edges whose
    base row lies in [lo_v, hi_v), probe the replicated Bᵀ, ⊕-reduce per
    mask edge. Returns (partial (E,), sizes (E,))."""
    from . import operators as O
    bto, bti, btv = bt
    e = int(base_g.shape[0])
    me = int(ai.shape[0])
    owned = (base_g >= lo_v) & (base_g < hi_v)
    base_l = torch.where(owned, base_g - lo_v, 0)
    deg = ao[base_l.long() + 1] - ao[base_l.long()]
    sizes = torch.where(owned, deg, 0).to(torch.int32)
    # a part expands only its own mask edges: its capacity is their
    # degree sum (the reference's equal-shape parts take the global cap;
    # the slots past a part's total are dead either way), still cut at
    # ``cap_out``
    cap = min(max(int(sizes.sum(dtype=torch.int64)), 1), cap_out)
    _, needles, eid, pair, _, valid, _ = O._advance_torch(
        ao, ai, base_l, sizes, cap)
    rows = rows_g[pair.long()]
    pos = O._segment_locate_torch(bti, bto[rows.long()],
                                  bto[rows.long() + 1], needles)
    found = (pos >= 0) & valid
    one = torch.tensor(sr.one, dtype=torch.float32, device=ao.device)
    sv = av[eid.clamp(0, me - 1).long()] if av is not None else one
    lv = (btv[pos.clamp(0, int(bti.shape[0]) - 1).long()]
          if btv is not None else one)
    prod = torch.where(found, sr.mul_op(sv, lv), sr.zero).to(torch.float32)
    if sr.add == "plus":
        c = torch.zeros((e,), dtype=torch.float32, device=ao.device)
        c.index_add_(0, pair.long(), prod)
    else:
        neutral = INF if sr.add == "min" else -INF
        c = torch.full((e,), neutral, dtype=torch.float32, device=ao.device)
        c.scatter_reduce_(0, pair.long(), prod,
                          "amin" if sr.add == "min" else "amax")
    return c, sizes


def _mxm_combine(partials, sizes, sr):
    c = _fold(partials, _sr_op(sr))
    gsizes = _fold(sizes, "sum")
    return torch.where(gsizes > 0, c, sr.zero).to(torch.float32)


def _probe_side(bt_off, bt_idx, bt_vals, base, probe_rows, devices):
    """The replicated operands of an mxm, once per distinct device."""
    out = {}
    for d in devices:
        if d not in out:
            out[d] = tuple(None if t is None else t.to(d)
                           for t in (bt_off, bt_idx, bt_vals, base,
                                     probe_rows))
    return out


@B.register("mxm", B.TORCH, B.SHARDED)
def _mxm_sharded(a_off, a_idx, a_vals, bt_off, bt_idx, bt_vals,
                 base, probe_rows, sr, cap_out: int):
    """1-D masked SpGEMM: the expansion side (A) row-partitioned, the
    probe side (Bᵀ) replicated; each part expands the mask edges whose
    base row it owns, the per-edge partials ⊕-combine (one owner per
    edge: the combine meets identities only)."""
    _require_placement_mesh()
    vpp = int(a_off[0].shape[0]) - 1
    rep = _probe_side(bt_off, bt_idx, bt_vals, base, probe_rows,
                      [ao.device for ao in a_off])
    partials, sizes = [], []
    for p, (ao, ai) in enumerate(zip(a_off, a_idx)):
        bto, bti, btv, base_g, rows_g = rep[ao.device]
        c, s = _mxm_partial(ao, ai, None if a_vals is None else a_vals[p],
                            (bto, bti, btv), base_g, rows_g, p * vpp,
                            (p + 1) * vpp, sr, cap_out)
        partials.append(c)
        sizes.append(s)
    return _mxm_combine(partials, sizes, sr)


# ---------------------------------------------------------------------------
# 2-D vertex-cut providers (placement "2d")
# ---------------------------------------------------------------------------


def _block_discover_chunks(block_ro, block_ci, frontier, row_base,
                           col_base, vpr: int, vpc: int, shape,
                           cache=None) -> list:
    """The per-block half of the 2-D bitmask exchange: each block
    expands its edges from its row chunk's frontier slice into a (vpc,)
    column-chunk mask, and the R blocks of each mesh column OR-combine
    into each block's merged chunk."""
    c = shape[1]
    reps = replicate(frontier, [ro.device for ro in block_ro])
    masks = []
    for b, (ro, ci) in enumerate(zip(block_ro, block_ci)):
        i, j = divmod(b, c)
        src, valid = _local_slots(ro, ci, vpr, cache)
        mine = _owned_slice(reps[ro.device], row_base[i], vpr, False)
        active = mine[src] & valid
        masks.append(_scatter_mask(
            vpc, torch.where(active, ci - int(col_base[j]), vpc)))
    return axis_all_reduce(masks, shape, 0, "or")


def _gather_chunks(chunks, shape, n: int) -> torch.Tensor:
    """Column-axis mirror-merge: the global (n,) vector from the C
    column chunks of mesh row 0 (every row holds the same chunks),
    concatenated on the root device and trimmed of the ceil padding."""
    return all_gather(list(chunks[:shape[1]]))[0][:n]


@B.register("advance", B.TORCH, B.TWOD)
def _advance_2d(block_ro, block_ci, frontier, row_base, col_base,
                vpr: int, vpc: int, shape, cache=None):
    """2-D chunked bitmask-exchange advance: the (n,) discovered mask,
    row-combined and column-gathered, on the root device. ``shape`` is
    the mesh's (R, C)."""
    chunks = _block_discover_chunks(block_ro, block_ci, frontier, row_base,
                                    col_base, vpr, vpc, shape, cache)
    return _gather_chunks(chunks, shape, int(frontier.shape[0]))


@B.register("advance_filter", B.TORCH, B.TWOD)
def _advance_filter_2d(block_ro, block_ci, frontier, visited, row_base,
                       col_base, vpr: int, vpc: int, shape, cache=None):
    """Fused 2-D advance + filter: the visited filter applies to each
    merged column chunk before the column gather, so it costs no
    exchange of its own. Returns the new (n,) frontier."""
    c = shape[1]
    chunks = _block_discover_chunks(block_ro, block_ci, frontier, row_base,
                                    col_base, vpr, vpc, shape, cache)
    vis = replicate(visited, [ch.device for ch in chunks])
    out = [ch & ~_owned_slice(vis[ch.device], col_base[b % c], vpc, False)
           for b, ch in enumerate(chunks)]
    return _gather_chunks(out, shape, int(frontier.shape[0]))


def _merge_block_products(shape, epos, valids, prods, sr, emax: int):
    """Scatter each block's per-edge products to their row-chunk slots
    and ⊕-merge each mesh row (the column-axis reduce): the slots are
    disjoint across a row's blocks, so the merge only ever meets
    ⊕-identities — exact for every semiring."""
    merged = []
    for ep, valid, prod in zip(epos, valids, prods):
        buf = torch.full((emax + 1,) + tuple(prod.shape[1:]), sr.zero,
                         dtype=torch.float32, device=prod.device)
        buf[torch.where(valid, ep, emax).long()] = prod.to(torch.float32)
        merged.append(buf[:emax])
    return axis_all_reduce(merged, shape, 1, _sr_op(sr))


def _blocks_2d_products(offsets, store, values, x, sr, vpr: int, cache,
                        vector: bool):
    """Per-block (valid, product) of a 2-D semiring sweep."""
    reps = replicate(x, [ro.device for ro in offsets])
    valids, prods = [], []
    for b, (ro, ci) in enumerate(zip(offsets, store.cols)):
        _, valid = _local_slots(ro, ci, vpr, cache)
        xv = reps[ro.device][torch.where(valid, ci, 0).long()]
        ev = None if values is None else values[b]
        if vector:
            prod = sr.round_prod(xv) if ev is None else sr.mul_op(ev, xv)
        else:
            prod = xv if ev is None else sr.mul_op(ev[:, None], xv)
            prod = torch.where(valid[:, None], prod, sr.zero)
        valids.append(valid)
        prods.append(prod)
    return valids, prods


def _row_chunks(ys, n: int) -> torch.Tensor:
    """Concatenate one (vpr, …) result per mesh row on the root device."""
    root = ys[0].device
    return torch.cat([y.to(root) for y in ys])[:n]


@B.register("spmv", B.TORCH, B.TWOD)
def _spmv_2d(offsets, store, values, x, sr, ell_width, mask, row_seg=None,
             over_pos=None, over_row=None, cache=None):
    """2-D vertex-cut semiring SpMV: the pre-fold product exchange along
    each mesh row, then the single-device per-row fold on the merged
    chunk (``fold_products``: the same ELL tree, the same overflow
    order); row chunks concatenate. ``store`` is a ``Blocks2D``."""
    del row_seg, over_pos, over_row
    if ell_width is None:
        return _spmm_2d(offsets, store, values, x[:, None], sr, None, mask,
                        cache=cache)[:, 0]
    from ..linalg.ops import fold_products
    mesh, _ = _require_2d_mesh()
    shape = mesh.shape
    vpr = int(offsets[0].shape[0]) - 1
    n = int(x.shape[0])
    emax = int(store.chunk_emax)
    valids, prods = _blocks_2d_products(offsets, store, values, x, sr, vpr,
                                        cache, vector=True)
    merged = _merge_block_products(shape, store.epos, valids, prods, sr,
                                   emax)
    ys = []
    for i in range(shape[0]):
        b = i * shape[1]              # the mesh row's first block
        cro = store.chunk_ro[b]
        edge_valid = torch.arange(emax, device=cro.device) < cro[-1]
        y = fold_products(cro, merged[b], sr, int(ell_width),
                          edge_valid=edge_valid, cache=cache)
        deg = cro[1:] - cro[:-1]
        ys.append(torch.where(deg > 0, y, sr.zero))
    y = _row_chunks(ys, n)
    if mask is not None:
        y = torch.where(mask, y, sr.zero)
    return y.to(torch.float32)


@B.register("spmm", B.TORCH, B.TWOD)
def _spmm_2d(offsets, store, values, x, sr, ell_width, mask, row_seg=None,
             cache=None):
    """2-D vertex-cut semiring SpMM: the 2-D SpMV's pre-fold product
    exchange, then the single-device gather + segment fold on the merged
    (chunk_emax, k) products."""
    del ell_width, row_seg
    mesh, _ = _require_2d_mesh()
    shape = mesh.shape
    vpr = int(offsets[0].shape[0]) - 1
    n = int(x.shape[0])
    emax = int(store.chunk_emax)
    valids, prods = _blocks_2d_products(offsets, store, values, x, sr, vpr,
                                        cache, vector=False)
    merged = _merge_block_products(shape, store.epos, valids, prods, sr,
                                   emax)
    ys = []
    for i in range(shape[0]):
        b = i * shape[1]
        cro = store.chunk_ro[b]
        slot = torch.arange(emax, dtype=cro.dtype, device=cro.device)
        seg = (torch.searchsorted(cro, slot, right=True) - 1).clamp(
            0, vpr - 1)
        y = _fold_rows(sr, seg, merged[b], vpr)
        deg = cro[1:] - cro[:-1]
        ys.append(torch.where((deg > 0)[:, None], y, sr.zero))
    y = _row_chunks(ys, n)
    if mask is not None:
        y = torch.where(mask[:, None], y, sr.zero)
    return y.to(torch.float32)


@B.register("mxm", B.TORCH, B.TWOD)
def _mxm_2d(a_off, a_store, a_vals, bt_off, bt_idx, bt_vals,
            base, probe_rows, sr, cap_out: int):
    """2-D masked SpGEMM: every block expands its slice of the mask
    edges whose base row its mesh row owns, probes the replicated Bᵀ,
    and the partials ⊕-combine over the whole mesh (exact for the exact
    ⊕ and integer-valued sums; a float plus-times regroups each dot)."""
    mesh, _ = _require_2d_mesh()
    c = mesh.shape[1]
    vpr = int(a_off[0].shape[0]) - 1
    a_idx = a_store.cols if hasattr(a_store, "cols") else a_store
    rep = _probe_side(bt_off, bt_idx, bt_vals, base, probe_rows,
                      [ao.device for ao in a_off])
    partials, sizes = [], []
    for b, (ao, ai) in enumerate(zip(a_off, a_idx)):
        i = b // c
        bto, bti, btv, base_g, rows_g = rep[ao.device]
        part, s = _mxm_partial(ao, ai, None if a_vals is None else a_vals[b],
                               (bto, bti, btv), base_g, rows_g, i * vpr,
                               (i + 1) * vpr, sr, cap_out)
        partials.append(part)
        sizes.append(s)
    return _mxm_combine(partials, sizes, sr)


# ---------------------------------------------------------------------------
# traversal primitives (whole loops over the partition)
# ---------------------------------------------------------------------------


def _bfs_loop(n: int, src: int, dev, step) -> DistBFSResult:
    labels = torch.full((n,), -1, dtype=torch.int32, device=dev)
    labels[int(src)] = 0
    frontier = torch.zeros((n,), dtype=torch.bool, device=dev)
    frontier[int(src)] = True
    it = 0
    while it <= n and bool(frontier.any()):      # one host read a step
        new = step(frontier, labels)
        labels = torch.where(new, it + 1, labels)
        frontier = new
        it += 1
    return DistBFSResult(labels=labels, iterations=it)


@B.draw_scope()
def distributed_bfs(pg, src: int, mesh: Mesh, axis="graph",
                    backend: Optional[str] = None) -> DistBFSResult:
    """Multi-device BFS by bitmask exchange. A PartitionedGraph runs the
    1-D placement (``mesh`` has an axis ``axis`` of pg.num_parts); a
    Partitioned2DGraph runs the 2-D vertex cut (``axis`` may name the
    (row, col) pair).
    Labels equal the single-device ``bfs``'s bit for bit."""
    bk = B.resolve(backend, mesh.root)
    n = pg.n
    if isinstance(pg, Partitioned2DGraph):
        axes = _axes_arg(axis)
        _check_mesh(pg, mesh, axes)
        sg = pg.shard(mesh, axes)
        af = B.dispatch("advance_filter", bk, B.TWOD)

        def step(frontier, labels):
            return af(sg.row_offsets, sg.col_indices, frontier, labels >= 0,
                      sg.row_base, sg.col_base, sg.vpr, sg.vpc, mesh.shape,
                      cache=sg.cache)
    else:
        sg = pg.shard(mesh, axis)
        expand = B.dispatch("advance", bk, B.SHARDED)

        def step(frontier, labels):
            disc = expand(sg.row_offsets, sg.col_indices, frontier,
                          sg.vertex_base, sg.verts_per_part, axis,
                          cache=sg.cache)
            return disc & (labels < 0)
    return _bfs_loop(n, src, mesh.root, step)


def _sssp_loop(n: int, src: int, delta: float, use_delta: bool, dev,
               candidates) -> DistSSSPResult:
    """Delta-stepping over replicated state: ``candidates(dist, near)``
    gives the min-combined (n,) relaxation candidates of the near pile."""
    from .primitives.sssp import _bucket_of
    f32 = torch.float32
    delta_v = torch.tensor(delta, dtype=f32, device=dev)
    dist = torch.full((n,), INF, dtype=f32, device=dev)
    dist[int(src)] = 0.0
    near = torch.zeros((n,), dtype=torch.bool, device=dev)
    near[int(src)] = True
    far = torch.zeros_like(near)
    bucket = torch.zeros((), dtype=torch.int32, device=dev)
    it = 0
    while it < 4 * n + 8:
        any_near, any_far = torch.stack([near.any(), far.any()]).tolist()
        if not (any_near or any_far):            # one host read a step
            break
        if any_near:
            # dense relax of the near pile; min is exact, so the
            # regrouping across parts cannot move a bit
            new_dist = torch.minimum(dist, candidates(dist, near))
            improved = new_dist < dist
            thresh = (bucket.to(f32) + 1.0) * delta_v
            if use_delta:
                add_near = improved & (new_dist < thresh)
                add_far = improved & (new_dist >= thresh)
            else:
                add_near, add_far = improved, torch.zeros_like(improved)
            far = (far | add_far) & ~add_near
            dist, near = new_dist, add_near
        else:
            # the near pile is empty: the next bucket holds the smallest
            # far distance (replicated state, so every part agrees)
            far_min = torch.where(far, dist, INF).min()
            bucket = torch.where(torch.isfinite(far_min),
                                 _bucket_of(far_min, delta_v), bucket + 1)
            thresh = (bucket.to(f32) + 1.0) * delta_v
            near = far & (dist < thresh)
            far = far & ~near
        it += 1
    return DistSSSPResult(dist=dist, iterations=it)


def _default_delta(pg) -> float:
    if pg.source is not None:
        from .primitives.sssp import _auto_delta
        return _auto_delta(pg.source)
    real = np.asarray(pg.col_indices) >= 0
    mean_w = float(np.asarray(pg.edge_values)[real].mean())
    return mean_w * max(pg.m / max(pg.n, 1), 1.0) / 2.0


@B.draw_scope()
def distributed_sssp(pg, src: int, mesh: Mesh, axis="graph",
                     delta: Optional[float] = None) -> DistSSSPResult:
    """Multi-device delta-stepping SSSP: dense relaxation of the owned
    rows (1-D) or blocks (2-D) of the near pile, min-combined. Distances
    equal the single-device ``sssp``'s bit for bit (every candidate
    ``dist[u] + w`` is the same float add, and min is exact)."""
    if pg.edge_values is None:
        raise ValueError("SSSP needs edge weights")
    delta = _default_delta(pg) if delta is None else float(delta)
    use_delta = math.isfinite(delta) and delta > 0
    n = pg.n
    if isinstance(pg, Partitioned2DGraph):
        axes = _axes_arg(axis)
        _check_mesh(pg, mesh, axes)
        sg = pg.shard(mesh, axes)
        shape = mesh.shape

        def candidates(dist, near):
            # candidates scatter-min into each block's column chunk, the
            # mesh column min-combines, the chunks gather
            devices = [ro.device for ro in sg.row_offsets]
            reps_n = replicate(near, devices)
            reps_d = replicate(dist, devices)
            chunks = []
            for b, (ro, ci) in enumerate(zip(sg.row_offsets,
                                             sg.col_indices)):
                i, j = divmod(b, shape[1])
                d = ro.device
                srcl, valid = _local_slots(ro, ci, sg.vpr, sg.cache)
                my_near = _owned_slice(reps_n[d], sg.row_base[i], sg.vpr,
                                       False)
                my_dist = _owned_slice(reps_d[d], sg.row_base[i], sg.vpr)
                active = my_near[srcl] & valid
                cand_v = my_dist[srcl] + sg.edge_values[b]
                tgt = torch.where(active, ci - int(sg.col_base[j]), sg.vpc)
                chunks.append(_scatter_min(sg.vpc, tgt,
                                           torch.where(active, cand_v, INF),
                                           INF))
            merged = axis_all_reduce(chunks, shape, 0, "min")
            return _gather_chunks(merged, shape, n)
    else:
        sg = pg.shard(mesh, axis)
        vpp = sg.verts_per_part

        def candidates(dist, near):
            devices = [ro.device for ro in sg.row_offsets]
            reps_n = replicate(near, devices)
            reps_d = replicate(dist, devices)
            cands = []
            for p, (ro, ci) in enumerate(zip(sg.row_offsets,
                                             sg.col_indices)):
                d = ro.device
                srcl, valid = _local_slots(ro, ci, vpp, sg.cache)
                my_near = _owned_slice(reps_n[d], sg.vertex_base[p], vpp,
                                       False)
                my_dist = _owned_slice(reps_d[d], sg.vertex_base[p], vpp)
                active = my_near[srcl] & valid
                cand_v = my_dist[srcl] + sg.edge_values[p]
                cands.append(_scatter_min(n, torch.where(active, ci, n),
                                          torch.where(active, cand_v, INF),
                                          INF))
            return all_reduce(cands, "min")[0]
    return _sssp_loop(n, src, delta, use_delta, mesh.root, candidates)


def _pointer_jump(cid: torch.Tensor) -> torch.Tensor:
    while True:
        nxt = cid[cid.long()]
        if torch.equal(nxt, cid):
            return cid
        cid = nxt


@B.draw_scope()
def distributed_cc(pg, mesh: Mesh, axis="graph") -> DistCCResult:
    """Multi-device connected components: hooking over the owned edges
    (1-D rows or 2-D blocks) with min-combined label candidates, then
    pointer jumping on the replicated labels. Labels equal the
    single-device ``connected_components``'s bit for bit (every combine
    is an exact integer min). On a 2-D mesh the candidates target
    arbitrary component ids, so their exchange stays (n,) over the
    whole mesh."""
    n = pg.n
    if isinstance(pg, Partitioned2DGraph):
        axes = _axes_arg(axis)
        _check_mesh(pg, mesh, axes)
        sg = pg.shard(mesh, axes)
        width = sg.vpr
        bases = [int(sg.row_base[b // sg.cols])
                 for b in range(sg.num_parts)]
    else:
        sg = pg.shard(mesh, axis)
        width = sg.verts_per_part
        bases = [int(b) for b in sg.vertex_base]
    ends = []       # per part: (global source, destination, live)
    for p, (ro, ci) in enumerate(zip(sg.row_offsets, sg.col_indices)):
        srcl, valid = _local_slots(ro, ci, width, sg.cache)
        # a pad slot's source may pass n; it is never live, and the
        # reference's gather clamps it as this does
        ends.append([(bases[p] + srcl).clamp(max=n - 1),
                     torch.where(valid, ci, 0).long(), valid])
    dev = mesh.root
    devices = [ro.device for ro in sg.row_offsets]
    cid = torch.arange(n, dtype=torch.int32, device=dev)
    n_live, it = 1, 0
    while n_live > 0 and it < n + 1:
        reps = replicate(cid, devices)
        cands = []
        for e in ends:
            c = reps[e[0].device]
            cu, cv = c[e[0]], c[e[1]]
            e[2] = e[2] & (cu != cv)
            lo, hi = torch.minimum(cu, cv), torch.maximum(cu, cv)
            cands.append(_scatter_min(n, torch.where(e[2], hi, n),
                                      torch.where(e[2], lo, INT_BIG),
                                      INT_BIG))
        cand = all_reduce(cands, "min")[0]
        cid = _pointer_jump(torch.minimum(cid, cand))
        reps = replicate(cid, devices)
        counts = []
        for e in ends:
            c = reps[e[0].device]
            e[2] = e[2] & (c[e[0]] != c[e[1]])
            counts.append(e[2].sum(dtype=torch.int64))
        n_live = int(all_reduce(counts, "sum")[0])    # one host read
        it += 1
    ncomp = int((cid == torch.arange(n, dtype=torch.int32,
                                     device=dev)).sum(dtype=torch.int64))
    return DistCCResult(labels=cid, num_components=ncomp, iterations=it)


def distributed_pagerank(pg, mesh: Mesh, axis="graph",
                         damping: float = 0.85, iters: int = 20,
                         backend: Optional[str] = None) -> torch.Tensor:
    """SpMV PageRank through the placement's "spmv" provider: the rank
    vector stays replicated, each part folds its own CSC rows (1-D) or
    merges its CSC block's products (2-D). The same ``pagerank`` body
    as the single-device primitive runs, with only the dispatched op
    changed, so the ranks are bit-equal to ``pagerank``'s."""
    from .primitives.pagerank import pagerank
    _check_mesh(pg, mesh, axis)
    if not pg.has_csc:
        raise ValueError(
            "distributed_pagerank needs the partitioned CSC mirror; "
            "partition a Graph built with a CSC mirror")
    return pagerank(_shard_any(pg, mesh, axis), damping=damping,
                    max_iter=iters, backend=backend).rank


def distributed_label_propagation(pg, mesh: Mesh, axis="graph", **kwargs):
    """Label propagation on the partition (1-D or 2-D): the one-hot SpMM
    blocks run through the placement's "spmm" provider; labels equal
    the single-device primitive's (the vote sums are small integers,
    exact in any grouping)."""
    from .primitives.label_propagation import label_propagation
    _check_mesh(pg, mesh, axis)
    return label_propagation(_shard_any(pg, mesh, axis), **kwargs)


def distributed_reach(pg, srcs, k: int = 3, *, mesh: Mesh, axis="graph",
                      **kwargs):
    """Batched k-hop reachability on the partition (the or-and SpMM
    closure through the placement's provider)."""
    from .primitives.reach import reach_batch
    _check_mesh(pg, mesh, axis)
    return reach_batch(_shard_any(pg, mesh, axis), srcs, k, **kwargs)


# ---------------------------------------------------------------------------
# comm-volume model (bytes a device sends in one BSP step)
# ---------------------------------------------------------------------------


def exchange_bytes_per_step(pg, primitive: str = "bfs",
                            tiles: int = DEFAULT_EXCHANGE_TILES) -> int:
    """Analytic bytes exchanged PER DEVICE in one BSP step of
    ``primitive`` under ``pg``'s placement, by the ring cost model (an
    all-reduce of b bytes moves 2·(p−1)/p·b per device, an all-gather of
    b-byte shards (p−1)·b) — the reference's model, value for value.

    1-D exchanges are n-proportional: bfs / sssp / cc all-reduce an (n,)
    vector, pagerank all-gathers its (n/p,) spmv output. 2-D traversal
    exchanges are chunk-proportional: bfs reduces ``tiles`` uint8
    (vpc,)-chunk tiles along the R rows and gathers C chunks; sssp the
    float32 twin; pagerank a (chunk_emax,) product reduce along the
    columns plus the output-row gather. cc hooks into arbitrary
    component ids, so its exchange stays (n,) on any mesh."""
    tiles = max(int(tiles), 1)
    n = pg.n
    if isinstance(pg, Partitioned2DGraph):
        r, c = pg.rows, pg.cols
        if primitive == "bfs":
            return int(tiles * 2 * (r - 1) / r * pg.vpc
                       + (c - 1) * pg.vpc)
        if primitive == "sssp":
            return int((2 * (r - 1) / r * pg.vpc + (c - 1) * pg.vpc) * 4)
        if primitive == "cc":
            p = r * c
            return int(2 * (p - 1) / p * n * 4)
        if primitive == "pagerank":
            return int(2 * (c - 1) / c * pg.csc_chunk_emax * 4
                       + (r - 1) * pg.vpr * 4)
        raise ValueError(f"unknown primitive {primitive!r}")
    p = pg.num_parts
    if primitive in ("bfs", "sssp", "cc"):
        return int(2 * (p - 1) / p * n * 4)
    if primitive == "pagerank":
        return int((p - 1) / p * n * 4)
    raise ValueError(f"unknown primitive {primitive!r}")
