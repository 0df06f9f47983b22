"""Admission control and load shedding for the serving loop
(counterpart of ``repro.ft.admission``).

Each query kind owns a bounded queue; when a queue is full (or the total
number of pending queries crosses the global cap) new arrivals are *shed* —
turned into structured per-query rejections the caller can see and retry —
rather than growing the queue without bound or raising out of the stream.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional


@dataclass(frozen=True)
class AdmissionPolicy:
    """Queue bounds: per-kind cap and a global pending cap.

    ``None`` means unbounded (the pre-admission behaviour).  ``max_per_kind``
    is the number of queries a single kind may have waiting for a flush;
    ``max_pending`` bounds the sum across kinds.
    """

    max_per_kind: Optional[int] = None
    max_pending: Optional[int] = None

    def __post_init__(self):
        for name in ("max_per_kind", "max_pending"):
            v = getattr(self, name)
            if v is not None and v < 1:
                raise ValueError(f"AdmissionPolicy.{name} must be >= 1, "
                                 f"got {v}")

    def admit(self, kind: str, pending: Dict[str, list]) -> Optional[str]:
        """None to admit, else a short shed-reason string."""
        if (self.max_per_kind is not None
                and len(pending.get(kind, ())) >= self.max_per_kind):
            return f"queue for kind={kind} full ({self.max_per_kind})"
        if self.max_pending is not None:
            total = sum(len(v) for v in pending.values())
            if total >= self.max_pending:
                return f"global pending queue full ({self.max_pending})"
        return None


UNBOUNDED = AdmissionPolicy()
