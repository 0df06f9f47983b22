"""Production and test meshes (counterpart of ``repro.launch.mesh``).

Single pod:  (16, 16)    axes ("data", "model")   — 256 chips
Multi-pod:   (2, 16, 16) axes ("pod", "data", "model") — 512 chips.
The "pod" axis is pure data parallelism.

A mesh is a ``core.partition.Mesh``. The production meshes give the
axis sizes the specs are fitted to (``parallel.sharding.fit_sharding``,
``launch.dryrun``) and hold no device: every part is on ``meta``. A test
mesh puts every part on one device (the card by default), as the port's
placements do (single-controller).
"""
from __future__ import annotations

from ..core.partition import Mesh
from ..kernels.runtime import resolve_device


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh.on("meta", shape, axes)


def mesh_axis_sizes(mesh) -> dict:
    return dict(zip(mesh.axis_names, mesh.shape))


def make_test_mesh(data: int = 1, model: int = 1, device=None) -> Mesh:
    """A (data, model) mesh with every part on ``device`` (None: the
    card)."""
    return Mesh.on(resolve_device(device), (data, model), ("data", "model"))
