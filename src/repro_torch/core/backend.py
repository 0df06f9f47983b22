"""Backend registry for the operator layer (counterpart of
``repro.core.backend``).

Every operator hot path — advance expansion+gather, fused
advance+filter, frontier compaction, the SpMV sweep, the segmented
binary search and the masked SpGEMM built on it — is registered here
once per backend, under the reference's op names and call contracts:

  "torch" — plain PyTorch formulations, the twin of each ``xla``
            provider. Runs on the CPU or the card.
  "cuda"  — the hand-written Hopper kernels of ``repro_torch.kernels``,
            the twin of each ``pallas`` provider. CUDA tensors only.

Resolution: an explicit ``backend=`` wins; otherwise the backend follows
the device of the data — ``"cuda"`` for CUDA tensors, ``"torch"`` for CPU
tensors. ``"cuda"`` on CPU tensors raises; ``"torch"`` on CUDA tensors
runs only when asked for by name (the plain-vs-kernel comparison). There
is no probe that falls back from one backend to the other, and a
dispatch miss raises ``ProviderMissError``.

Placements, the second registry dimension (paper §8.2.1 scale-out):

  "single"  — one device holds the whole graph (the default).
  "sharded" — the graph is 1-D partitioned (``core.partition``); the
              providers of ``core.distributed`` run every part and
              combine with explicit collectives. Edge operands arrive as
              one tensor per part (``ShardedGraph``), dense vectors
              replicated.
  "2d"      — the R×C vertex cut (``partition_2d``); operands arrive as
              one tensor per block (``Sharded2DGraph``).

Under a distributed placement the ``cuda`` backend dispatches the
``torch`` provider of the same placement — the reference's declared
route (its ``pallas`` dispatch under ``sharded`` / ``2d`` runs the
``xla`` provider: kernels under a placement are later work), not a
probe. No placement ever falls back to ``"single"``: a miss raises.
Precedence, as for backends: a per-call ``placement=`` > the innermost
``use_placement`` context > ``"single"``; no environment variable.

Three pieces carried over from the reference:

  use_backend(name)   — a context manager: inside it, a call that passes
                        no ``backend=`` runs on ``name`` (an explicit
                        ``backend=`` still wins; ``"cuda"`` on CPU data
                        still raises).
  declare_fallback    — the record of a fallback someone chose (the
                        serving layer's degradation ladder declares each
                        rung it engages); ``declared_fallback(s)`` reads
                        it. Declaring changes no dispatch.
  the fault hook      — with a ``repro_torch.ft.inject`` plan installed,
                        ``dispatch`` misses deterministically when the
                        plan's ``provider_miss`` clause fires for the op
                        (the site is the op name). The plan is found
                        through ``sys.modules``, so the core never
                        imports ``ft``; with no plan the hook is one
                        ``None`` check. The reference draws when a
                        program is traced, not at every step it runs:
                        here a primitive call is the trace
                        (``draw_scope``), and inside one the hook draws
                        once per (op, backend), at its first dispatch.
"""
from __future__ import annotations

import contextlib
import importlib
import sys
import threading
from contextlib import contextmanager
from typing import Callable, Optional

import torch

TORCH = "torch"
CUDA = "cuda"
BACKENDS = (TORCH, CUDA)

SINGLE = "single"
SHARDED = "sharded"
TWOD = "2d"
PLACEMENTS = (SINGLE, SHARDED, TWOD)

# the modules whose import registers each backend's providers — imported
# on first dispatch, so importing the core never builds a kernel
_PROVIDER_MODULES = {
    TORCH: ("repro_torch.core.frontier", "repro_torch.core.operators",
            "repro_torch.linalg.ops"),
    CUDA: ("repro_torch.kernels.ops",),
    # the distributed placements' providers register on import
    SHARDED: ("repro_torch.core.distributed",),
    TWOD: ("repro_torch.core.distributed",),
}
_loaded: set[str] = set()

# (op, backend, placement) -> implementation
_REGISTRY: dict[tuple[str, str, str], Callable] = {}
# (op, backend, placement) -> the column encodings the provider decodes
# itself; a provider that declared only "dense" receives the dense view
# of a delta-encoded store (``storage_arg``)
_ENCODINGS: dict[tuple[str, str, str], tuple] = {}


_tls = threading.local()
# (op, backend or placement) -> reason: fallbacks declared on purpose
_DECLARED_FALLBACKS: dict[tuple[str, str], str] = {}


class ProviderMissError(KeyError):
    """No provider registered for an (op, backend, placement)
    dispatch."""

    def __init__(self, op: str, backend: str, detail: str = "", *,
                 injected: bool = False, placement: str = SINGLE):
        self.op = op
        self.backend = backend
        self.placement = placement
        self.injected = injected        # raised by a fault plan
        have = sorted({(b, p) for (o, b, p) in _REGISTRY if o == op})
        self.detail = (f"no provider registered for op={op!r} "
                       f"backend={backend!r} placement={placement!r}"
                       + (f" ({detail})" if detail else "")
                       + f"; registered (backend, placement) for this "
                         f"op: {have}")
        super().__init__(self.detail)

    def __str__(self) -> str:
        return self.detail


def _check(name: str) -> str:
    if name not in BACKENDS:
        raise ValueError(
            f"unknown backend {name!r}; expected one of {BACKENDS}")
    return name


def _check_placement(name: str) -> str:
    if name not in PLACEMENTS:
        raise ValueError(
            f"unknown placement {name!r}; expected one of {PLACEMENTS}")
    return name


def resolve(backend: Optional[str] = None,
            device: Optional[torch.device] = None) -> str:
    """The concrete backend for data on ``device``.

    ``None`` takes the innermost ``use_backend`` context, else follows
    the device: ``"cuda"`` for a CUDA device, ``"torch"`` otherwise.
    ``"cuda"`` on a non-CUDA device raises — the kernels take CUDA
    tensors only and nothing stands in for them."""
    if backend is None:
        stack = _stack()
        backend = stack[-1] if stack else None
    if backend is None:
        if device is None:
            raise ValueError("backend=None needs the data's device")
        return CUDA if torch.device(device).type == "cuda" else TORCH
    _check(backend)
    if backend == CUDA and (device is None
                            or torch.device(device).type != "cuda"):
        raise ValueError(
            f"backend='cuda' runs the hand-written kernels, which take "
            f"CUDA tensors; the data lies on {device}")
    return backend


def _stack() -> list:
    if not hasattr(_tls, "stack"):
        _tls.stack = []
    return _tls.stack


def _pstack() -> list:
    if not hasattr(_tls, "pstack"):
        _tls.pstack = []
    return _tls.pstack


def resolve_placement(placement: Optional[str] = None) -> str:
    """The concrete placement: the per-call name, else the innermost
    ``use_placement`` context, else ``"single"``."""
    if placement is None:
        stack = _pstack()
        placement = stack[-1][0] if stack else SINGLE
    return _check_placement(placement)


@contextmanager
def use_placement(name: str, mesh=None, axis="graph"):
    """Context manager: dispatch under placement ``name``. For
    ``"sharded"`` ``mesh`` / ``axis`` name the 1-D mesh axis; for
    ``"2d"`` ``axis`` is the (row, col) axis-name pair. Providers read
    them through ``placement_mesh()``."""
    _check_placement(name)
    _pstack().append((name, mesh, axis))
    try:
        yield
    finally:
        _pstack().pop()


def placement_mesh():
    """The (mesh, axis) of the innermost placement context that carries
    a mesh, or None."""
    for _, mesh, axis in reversed(_pstack()):
        if mesh is not None:
            return mesh, axis
    return None


def resolve_graph_placement(graph, placement: Optional[str] = None):
    """``(placement, context)`` for a Graph / ShardedGraph /
    Sharded2DGraph operand: a ``ShardedGraph`` implies ``"sharded"``, a
    ``Sharded2DGraph`` ``"2d"``, and the context activates its mesh; a
    plain Graph resolves normally. A mismatch raises: a plain Graph
    under a distributed placement has nothing to shard over, and a
    per-call placement that contradicts the operand's layout cannot be
    honoured. Use as ``pl, ctx = resolve_graph_placement(g); with ctx:``.
    """
    from .partition import Sharded2DGraph, ShardedGraph
    implied = (SHARDED if isinstance(graph, ShardedGraph)
               else TWOD if isinstance(graph, Sharded2DGraph) else None)
    if implied is not None:
        if placement is not None and placement != implied:
            raise ValueError(
                f"placement={placement!r} with a {type(graph).__name__} "
                f"operand: the per-part slices only run the {implied!r} "
                f"path; pass the unpartitioned graph (the partition's "
                f".source) to run elsewhere")
        axis = graph.axis if implied == SHARDED else graph.axes
        return implied, use_placement(implied, mesh=graph.mesh, axis=axis)
    pl = resolve_placement(placement)
    if pl == SHARDED:
        raise ValueError(
            "sharded placement needs a ShardedGraph operand "
            "(partition_1d(graph, p).shard(mesh)); got a single-device "
            "graph")
    if pl == TWOD:
        raise ValueError(
            "2d placement needs a Sharded2DGraph operand "
            "(partition_2d(graph, r, c).shard(mesh)); got a "
            "single-device graph")
    return pl, contextlib.nullcontext()


@contextmanager
def use_backend(name: str):
    """Context manager: calls that pass no ``backend=`` run on ``name``
    (per thread; contexts nest, the innermost wins)."""
    _check(name)
    _stack().append(name)
    try:
        yield
    finally:
        _stack().pop()


def declare_fallback(op: str, target: str, *, reason: str) -> None:
    """Record that ``op`` is served on ``target`` — a backend (a
    serve-time rung) or a placement (a rung, or a hole an op has on
    purpose, as ``advance_filter`` has under ``"sharded"``) — by a
    fallback someone chose, with its reason. Dispatch does not change:
    a miss still raises."""
    if target not in BACKENDS:
        _check_placement(target)
    if not reason:
        raise ValueError("declare_fallback requires a non-empty reason")
    _DECLARED_FALLBACKS[(op, target)] = reason


def declared_fallback(op: str, target: str) -> Optional[str]:
    """The declared-fallback reason for (op, backend or placement), or
    None."""
    return _DECLARED_FALLBACKS.get((op, target))


def declared_fallbacks() -> dict:
    """Every declared fallback: {(op, backend or placement): reason}."""
    return dict(_DECLARED_FALLBACKS)


def register(op: str, backend: str, placement: str = SINGLE,
             encodings: tuple = ("dense",)):
    """Decorator: register ``fn`` as the ``backend`` provider of ``op``
    under ``placement``; ``encodings`` names the column storage
    encodings it decodes itself (see ``storage_arg``)."""
    _check(backend)
    _check_placement(placement)
    for enc in encodings:
        if enc not in ("dense", "delta"):
            raise ValueError(f"unknown storage encoding {enc!r}")

    def deco(fn: Callable) -> Callable:
        _REGISTRY[(op, backend, placement)] = fn
        _ENCODINGS[(op, backend, placement)] = tuple(encodings)
        return fn

    return deco


def _fault_plan():
    """The installed ``repro_torch.ft.inject`` plan, or None (the module
    is looked up, never imported: the core does not depend on ``ft``)."""
    mod = sys.modules.get("repro_torch.ft.inject")
    return None if mod is None else mod.active()


@contextmanager
def draw_scope():
    """One primitive call, as far as the fault hook is concerned (a
    decorator on each primitive): inside it ``dispatch`` draws once per
    (op, backend), as the reference's program draws once when it is
    traced. Scopes nest; the outermost holds the record."""
    if getattr(_tls, "drawn", None) is not None:
        yield
        return
    _tls.drawn = set()
    try:
        yield
    finally:
        _tls.drawn = None


def dispatch(op: str, backend: str,
             placement: Optional[str] = None) -> Callable:
    """The ``backend`` provider of ``op`` under ``placement`` (resolved
    names; ``placement=None`` resolves through ``use_placement``). An
    installed fault plan's ``provider_miss`` clause makes it miss."""
    pl = resolve_placement(placement)
    plan = _fault_plan()
    if plan is not None:
        drawn = getattr(_tls, "drawn", None)
        if drawn is None or (op, backend) not in drawn:
            if drawn is not None:
                drawn.add((op, backend))
            if plan.should("provider_miss", op):
                raise ProviderMissError(op, backend,
                                        "injected by repro_torch.ft.inject",
                                        injected=True, placement=pl)
    return _lookup(op, backend, pl)[1]


def _load(name: str) -> None:
    if name not in _loaded:
        for mod in _PROVIDER_MODULES[name]:
            importlib.import_module(mod)
        _loaded.add(name)


def _lookup(op: str, backend: str, placement: str = SINGLE
            ) -> tuple[tuple, Callable]:
    """(registry key, provider) of a dispatch. Under a distributed
    placement the ``cuda`` backend runs the ``torch`` provider of the
    same placement (the declared route, see the module docstring); no
    placement ever drops to ``"single"``."""
    _check(backend)
    _check_placement(placement)
    _load(backend)
    if placement != SINGLE:
        _load(TORCH)
        _load(placement)
        backend = TORCH
    key = (op, backend, placement)
    impl = _REGISTRY.get(key)
    if impl is None:
        detail = ("" if placement == SINGLE else
                  f"{placement} dispatch never falls back to the "
                  f"single-device path")
        raise ProviderMissError(op, key[1], detail, placement=placement)
    return key, impl


def registered(op: str, backend: str, placement: str = SINGLE) -> bool:
    """True if ``op`` has a provider of its own for ``backend`` under
    ``placement`` (the cuda→torch route under a placement not counted)."""
    _check(backend)
    _check_placement(placement)
    _load(backend)
    if placement != SINGLE:
        _load(placement)
    return (op, backend, placement) in _REGISTRY


def declared_encodings(op: str, backend: str,
                       placement: Optional[str] = None) -> tuple:
    """The column encodings the provider that ``dispatch`` would select
    for ``op`` decodes itself."""
    key, _ = _lookup(op, backend, resolve_placement(placement))
    return _ENCODINGS.get(key, ("dense",))


def coerce_store(op: str, backend: str, placement: Optional[str] = None,
                 *, store, cache=None):
    """The column store to hand the ``backend`` provider of ``op``: the
    store itself when it is dense (at any index dtype; a partition's
    parts always are) or the provider declared its encoding, else the
    dense int32 view. With ``cache`` (a graph's) the view is decoded
    once and kept there."""
    from . import storage as S
    if not isinstance(store, S.EncodedCols) or "delta" in declared_encodings(
            op, backend, placement):
        return store
    return S.dense_view(store, cache)


def storage_arg(op: str, backend: str, placement: Optional[str] = None, *,
                graph, side: str = "csr"):
    """The column operand for the registry's column slot: the graph's
    native store (``side`` "csr" or "csc") when the provider declared
    its encoding, else its dense int32 view, decoded once per graph. A
    ShardedGraph's store is its per-part tuple, a Sharded2DGraph's its
    ``Blocks2D``."""
    store = graph.col_store if side == "csr" else graph.csc_store
    return coerce_store(op, backend, placement, store=store,
                        cache=graph.cache)


def tier_plan(op: str, cap: int, *, min_tier: Optional[int] = None,
              device=None) -> tuple[int, ...]:
    """Capacity ladder for ``op`` up to ``cap``. Tier choice never
    changes results — every rung computes the same masked expansion,
    larger rungs carry more dead lanes. The floor is the tuner's
    measured tile for ``op`` at the bottom tier on ``device``'s platform
    (``kernels.tuner.tier_floor``), ``MIN_TIER`` where none is cached."""
    from ..kernels import tuner
    from .frontier import MIN_TIER, tier_caps
    if min_tier is None:
        min_tier = tuner.tier_floor(op, MIN_TIER, device=device)
    return tier_caps(cap, min_tier=min_tier)
