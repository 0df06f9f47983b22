"""Graceful-degradation ladder for graph queries (counterpart of
``repro.ft.degrade``).

When a batch keeps failing, the serving loop retries it one rung lower
instead of failing its queries outright:

  backend    cuda → torch             (the plain providers on the SAME
                                       card tensors: same results, no
                                       hand-written kernel)
  placement  2d → sharded → single    (same results, less parallelism)
  algorithm  bc exact → sampled       (approximate)
             reach k hops → k//2      (approximate, smaller neighbourhood)

The reference's ``pallas→xla`` rung is ``cuda→torch`` here. A rung is
reached only by a retry after a failed attempt; every step down is
declared
(``core.backend.declare_fallback``: a backend rung under its backend, a
placement rung under its placement), logged, and the serving layer
stamps ``degraded`` with the rung's reason on every query it answers.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List, Optional

from ..core import backend as B
from ..obs import get_logger

_log = get_logger("degrade")

# placement ladder, strongest first; degradation walks left to right
_PLACEMENT_ORDER = (B.TWOD, B.SHARDED, B.SINGLE)


@dataclass(frozen=True)
class Rung:
    """One configuration on the degradation ladder."""

    backend: str
    placement: str = B.SINGLE
    hops: Optional[int] = None    # reach: reduced neighbourhood radius
    sampled: bool = False         # bc: Brandes–Pich estimator
    reason: str = ""              # how this rung differs from the one above

    @property
    def approximate(self) -> bool:
        return self.sampled or self.reason.startswith("reach")


def ladder(kind: str, backend: str, placement: str = B.SINGLE, *,
           hops: Optional[int] = None) -> List[Rung]:
    """Rungs for ``kind`` from the requested configuration down. Rung 0
    is the request itself (``reason=""``); each later rung changes one
    thing, exact-preserving first (backend, then placement),
    approximation last."""
    rungs = [Rung(backend=backend, placement=placement, hops=hops)]

    def _push(reason, **kw):
        rungs.append(replace(rungs[-1], reason=reason, **kw))

    if backend == B.CUDA:
        _push("backend cuda→torch", backend=B.TORCH)
    if placement in _PLACEMENT_ORDER:
        for lower in _PLACEMENT_ORDER[_PLACEMENT_ORDER.index(placement) + 1:]:
            _push(f"placement {rungs[-1].placement}→{lower}",
                  placement=lower)
    if kind == "bc":
        _push("bc exact→sampled", sampled=True)
    if kind == "reach" and hops is not None and hops > 1:
        _push(f"reach hops {hops}→{max(1, hops // 2)}",
              hops=max(1, hops // 2))
    return rungs


def rung_for_attempt(rungs: List[Rung], attempt: int) -> Rung:
    """The rung to run on retry ``attempt`` (clamped to the bottom)."""
    return rungs[min(attempt, len(rungs) - 1)]


def engage(kind: str, rung: Rung, exc: Optional[BaseException] = None
           ) -> None:
    """Record a step down: declare it in the registry and log it
    (idempotent: the reason is overwritten). A placement rung is
    declared under its placement, every other under its backend."""
    if not rung.reason:
        return
    target = (rung.placement if rung.reason.startswith("placement")
              else rung.backend)
    B.declare_fallback(kind, target,
                       reason=f"serve-time degradation: {rung.reason}")
    cause = f" after {type(exc).__name__}: {exc}" if exc is not None else ""
    _log.warning("degrade kind=%s %s%s", kind, rung.reason, cause)
