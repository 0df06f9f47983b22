"""Per-query execution budgets (counterpart of ``repro.ft.budget``).

A :class:`Budget` bounds the work of one query: a cap on BSP iterations
(the enactor lowers its loop guard to it, ``cap_iters``) and a
wall-clock deadline in milliseconds (checked on the host at flush
boundaries by the serving loop). Both are optional; the default budget
is unbounded and changes nothing.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class Budget:
    """Bounds for one query: ``max_iters`` BSP steps, ``wall_ms`` wall clock.

    ``max_iters=None`` leaves the primitive's own iteration guard in place;
    ``wall_ms=None`` disables the deadline.
    """

    max_iters: Optional[int] = None
    wall_ms: Optional[float] = None

    def __post_init__(self):
        if self.max_iters is not None and self.max_iters < 1:
            raise ValueError(f"Budget.max_iters must be >= 1, "
                             f"got {self.max_iters}")
        if self.wall_ms is not None and self.wall_ms <= 0:
            raise ValueError(f"Budget.wall_ms must be > 0, got {self.wall_ms}")

    def cap_iters(self, max_iter: int) -> int:
        """Clamp a primitive's natural iteration guard to this budget."""
        if self.max_iters is None:
            return max_iter
        return min(max_iter, self.max_iters)

    def deadline_from(self, t0_s: float) -> Optional[float]:
        """Absolute monotonic deadline (seconds) for a query enqueued at t0."""
        if self.wall_ms is None:
            return None
        return t0_s + self.wall_ms / 1000.0


UNLIMITED = Budget()
