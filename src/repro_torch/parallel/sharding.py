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

``fit_sharding`` / ``tree_shardings`` (the checkpoint layer's) come with
the training slice.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

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
