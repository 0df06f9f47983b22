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
is no probe that falls back from one backend to the other, a dispatch
miss raises ``ProviderMissError``, and there is one placement (a single
device).

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

import importlib
import sys
import threading
from contextlib import contextmanager
from typing import Callable, Optional

import torch

TORCH = "torch"
CUDA = "cuda"
BACKENDS = (TORCH, CUDA)

# the modules whose import registers each backend's providers — imported
# on first dispatch, so importing the core never builds a kernel
_PROVIDER_MODULES = {
    TORCH: ("repro_torch.core.frontier", "repro_torch.core.operators",
            "repro_torch.linalg.ops"),
    CUDA: ("repro_torch.kernels.ops",),
}
_loaded: set[str] = set()

# (op, backend) -> implementation
_REGISTRY: dict[tuple[str, str], Callable] = {}
# (op, backend) -> the column encodings the provider decodes itself; a
# provider that declared only "dense" receives the dense view of a
# delta-encoded store (``storage_arg``)
_ENCODINGS: dict[tuple[str, str], tuple] = {}


_tls = threading.local()
# (op, backend) -> reason: fallbacks declared on purpose
_DECLARED_FALLBACKS: dict[tuple[str, str], str] = {}


class ProviderMissError(KeyError):
    """No provider registered for an (op, backend) dispatch."""

    def __init__(self, op: str, backend: str, detail: str = "", *,
                 injected: bool = False):
        self.op = op
        self.backend = backend
        self.injected = injected        # raised by a fault plan
        have = sorted(b for (o, b) in _REGISTRY if o == op)
        self.detail = (f"no provider registered for op={op!r} "
                       f"backend={backend!r}"
                       + (f" ({detail})" if detail else "")
                       + f"; registered backends for this op: {have}")
        super().__init__(self.detail)

    def __str__(self) -> str:
        return self.detail


def _check(name: str) -> str:
    if name not in BACKENDS:
        raise ValueError(
            f"unknown backend {name!r}; expected one of {BACKENDS}")
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


def declare_fallback(op: str, backend: str, *, reason: str) -> None:
    """Record that ``op`` on ``backend`` is served by a fallback on
    purpose (a serve-time degradation rung, with its reason). Dispatch
    does not change: a miss still raises."""
    _check(backend)
    if not reason:
        raise ValueError("declare_fallback requires a non-empty reason")
    _DECLARED_FALLBACKS[(op, backend)] = reason


def declared_fallback(op: str, backend: str) -> Optional[str]:
    """The declared-fallback reason for (op, backend), or None."""
    return _DECLARED_FALLBACKS.get((op, backend))


def declared_fallbacks() -> dict:
    """Every declared fallback: {(op, backend): reason}."""
    return dict(_DECLARED_FALLBACKS)


def register(op: str, backend: str, encodings: tuple = ("dense",)):
    """Decorator: register ``fn`` as the ``backend`` provider of ``op``;
    ``encodings`` names the column storage encodings it decodes itself
    (see ``storage_arg``)."""
    _check(backend)
    for enc in encodings:
        if enc not in ("dense", "delta"):
            raise ValueError(f"unknown storage encoding {enc!r}")

    def deco(fn: Callable) -> Callable:
        _REGISTRY[(op, backend)] = fn
        _ENCODINGS[(op, backend)] = tuple(encodings)
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


def dispatch(op: str, backend: str) -> Callable:
    """The ``backend`` provider of ``op`` (a resolved backend name). An
    installed fault plan's ``provider_miss`` clause makes it miss."""
    plan = _fault_plan()
    if plan is not None:
        drawn = getattr(_tls, "drawn", None)
        if drawn is None or (op, backend) not in drawn:
            if drawn is not None:
                drawn.add((op, backend))
            if plan.should("provider_miss", op):
                raise ProviderMissError(op, backend,
                                        "injected by repro_torch.ft.inject",
                                        injected=True)
    return _lookup(op, backend)


def _lookup(op: str, backend: str) -> Callable:
    _check(backend)
    if backend not in _loaded:
        for mod in _PROVIDER_MODULES[backend]:
            importlib.import_module(mod)
        _loaded.add(backend)
    impl = _REGISTRY.get((op, backend))
    if impl is None:
        raise ProviderMissError(op, backend)
    return impl


def registered(op: str, backend: str) -> bool:
    try:
        _lookup(op, backend)
    except ProviderMissError:
        return False
    return True


def declared_encodings(op: str, backend: str) -> tuple:
    """The column encodings the ``backend`` provider of ``op`` decodes
    itself."""
    _lookup(op, backend)
    return _ENCODINGS.get((op, backend), ("dense",))


def coerce_store(op: str, backend: str, *, store, cache=None):
    """The column store to hand the ``backend`` provider of ``op``: the
    store itself when it is dense (at any index dtype) or the provider
    declared its encoding, else the dense int32 view. With ``cache`` (a
    graph's) the view is decoded once and kept there."""
    from . import storage as S
    if not isinstance(store, S.EncodedCols) or "delta" in declared_encodings(
            op, backend):
        return store
    return S.dense_view(store, cache)


def storage_arg(op: str, backend: str, *, graph, side: str = "csr"):
    """The column operand for the registry's column slot: the graph's
    native store (``side`` "csr" or "csc") when the provider declared
    its encoding, else its dense int32 view, decoded once per graph."""
    store = graph.col_store if side == "csr" else graph.csc_store
    return coerce_store(op, backend, store=store, cache=graph.cache)


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
