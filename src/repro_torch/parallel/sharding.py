"""Sharding vocabulary and helpers (counterpart of
``repro.parallel.sharding``, the part the models import).

The logical-axis vocabulary is the reference's:
  "pod"   — inter-pod data parallelism
  "data"  — intra-pod data parallelism + FSDP param sharding
  "model" — tensor parallelism (heads / FFN hidden / experts / vocab)

A spec is a plain tuple with one entry a dimension: ``None``, an axis
name, or a tuple of axis names — ``tuple(P(...))`` of the reference's
``PartitionSpec``. The port is single-controller: a tensor is whole on
its device, so ``constrain`` is the identity. ``mesh_axis_size`` reads
the mesh made active by ``use_mesh`` (a ``core.partition.Mesh``), 1 for
an axis it lacks or when none is active; ``models.moe`` reads the data
axes off it, as the reference reads its abstract mesh.

A "sharding" (``NamedSharding``) is a record of the mesh and a spec
fitted to it: ``fit_sharding`` drops an axis wherever the dimension is
not divisible, exactly as the reference fits its ``PartitionSpec``, so
the per-device sizes it implies are the reference's. The tensor itself
stays whole on the mesh's root device (single-controller).
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from dataclasses import dataclass
from typing import Optional

from ..pytree import tree_map

BATCH_AXES = ("pod", "data")      # batch dim shards over both when present
FSDP_AXIS = "data"
TENSOR_AXIS = "model"
POD_AXIS = "pod"

_ACTIVE = contextvars.ContextVar("repro_torch_mesh", default=None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` (a ``core.partition.Mesh``) the active one inside
    the block."""
    token = _ACTIVE.set(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.reset(token)


def active_mesh():
    """The mesh of the innermost ``use_mesh`` block, else None."""
    return _ACTIVE.get()


def _filter_entry(entry, axis_names):
    if entry is None:
        return None
    if isinstance(entry, str):
        return entry if entry in axis_names else None
    # tuple of axes: keep the present ones
    kept = tuple(a for a in entry if a in axis_names)
    if not kept:
        return None
    return kept if len(kept) > 1 else kept[0]


def spec_for_mesh(spec: tuple, mesh=None) -> tuple:
    """Drop axes not present in ``mesh`` (or the active mesh); ``()``
    when there is none."""
    if mesh is None:
        mesh = active_mesh()
        if mesh is None:
            return ()
    names = mesh.axis_names
    return tuple(_filter_entry(e, names) for e in spec)


def mesh_axis_size(name: str, mesh: Optional[object] = None) -> int:
    """Size of a mesh axis in ``mesh`` or the active mesh (1 if absent)."""
    mesh = active_mesh() if mesh is None else mesh
    if mesh is None:
        return 1
    return dict(zip(mesh.axis_names, mesh.shape)).get(name, 1)


def constrain(x, *spec_entries):
    """The reference's ``with_sharding_constraint``: the identity here,
    where every tensor is whole on its device."""
    return x


@dataclass(frozen=True)
class NamedSharding:
    """``mesh`` (a ``core.partition.Mesh``) and a spec fitted to it."""
    mesh: object
    spec: tuple

    @property
    def device(self):
        """Where the (whole) tensor lives: the mesh's root."""
        return self.mesh.root

    def shard_shape(self, shape) -> tuple:
        """The per-device block of a tensor of ``shape`` under the spec."""
        sizes = dict(zip(self.mesh.axis_names, self.mesh.shape))
        out = []
        for i, dim in enumerate(shape):
            entry = self.spec[i] if i < len(self.spec) else None
            axes = () if entry is None else (
                entry if isinstance(entry, tuple) else (entry,))
            out.append(dim // math.prod(sizes[a] for a in axes))
        return tuple(out)


def make_sharding(mesh, spec: tuple) -> NamedSharding:
    return NamedSharding(mesh, spec_for_mesh(spec, mesh))


def fit_sharding(mesh, shape, spec: tuple) -> NamedSharding:
    """A sharding with axes dropped wherever the dim isn't divisible by
    the mesh-axis product (e.g. batch=1 long-context cells, odd block
    counts of quantized optimizer moments)."""
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    spec = spec_for_mesh(spec, mesh)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, entry in zip(shape, entries):
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        kept, prod = [], 1
        for a in axes:
            if dim % (prod * sizes[a]) == 0:
                kept.append(a)
                prod *= sizes[a]
        out.append(tuple(kept) if len(kept) > 1
                   else (kept[0] if kept else None))
    return NamedSharding(mesh, tuple(out))


def is_spec(x) -> bool:
    """A spec: a plain tuple of entries (None, an axis name or a tuple
    of them). A NamedTuple such as ``QTensor``, or a tuple of trees, is
    a node of the tree, not a spec."""
    def entry(e):
        return e is None or isinstance(e, str) or (
            isinstance(e, tuple) and all(isinstance(a, str) for a in e))

    return (isinstance(x, tuple) and not hasattr(x, "_fields")
            and all(entry(e) for e in x))


def tree_shardings(mesh, spec_tree):
    """Map a tree of specs to shardings on ``mesh``."""
    return tree_map(lambda s: make_sharding(mesh, s), spec_tree,
                    is_leaf=is_spec)
