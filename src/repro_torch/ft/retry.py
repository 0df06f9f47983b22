"""Retry with exponential backoff and deterministic jitter (counterpart
of ``repro.ft.retry``; the same sha256 jitter stream, so a policy and
seed give the reference's schedule).

Wraps batch dispatch in the serving loop.  The backoff schedule is fully
deterministic given ``(policy, seed)`` so the fake-clock tests can assert
exact sleep sequences; jitter decorrelates real deployments where many
lanes retry at once.
"""
from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass
from typing import Callable, Optional, Tuple


@dataclass(frozen=True)
class RetryPolicy:
    """``retries`` attempts after the first, exponential base/factor, jitter.

    ``jitter`` is the fraction of the nominal delay drawn uniformly and
    added on top (0.0 = none, 0.5 = up to +50%).
    """

    retries: int = 2
    base_ms: float = 10.0
    factor: float = 2.0
    jitter: float = 0.25

    def __post_init__(self):
        if self.retries < 0:
            raise ValueError(f"retries must be >= 0, got {self.retries}")
        if self.base_ms < 0 or self.factor < 1.0:
            raise ValueError("base_ms must be >= 0 and factor >= 1.0")


def _unit(seed: int, attempt: int) -> float:
    h = hashlib.sha256(f"retry:{seed}:{attempt}".encode()).digest()
    return int.from_bytes(h[:8], "big") / float(1 << 64)


def backoff_ms(policy: RetryPolicy, attempt: int, seed: int = 0) -> float:
    """Delay before retry ``attempt`` (0-indexed), jitter included."""
    nominal = policy.base_ms * (policy.factor ** attempt)
    return nominal * (1.0 + policy.jitter * _unit(seed, attempt))


def with_retry(fn: Callable[[int], object],
               policy: RetryPolicy,
               *,
               seed: int = 0,
               retryable: Tuple[type, ...] = (Exception,),
               retry_if: Optional[Callable[[BaseException], bool]] = None,
               sleep: Optional[Callable[[float], None]] = None,
               on_retry: Optional[Callable[[int, BaseException],
                                           None]] = None):
    """Call ``fn(attempt)`` until it succeeds or the policy is exhausted.

    ``fn`` receives the attempt index so callers can escalate (e.g. walk a
    degradation ladder) rather than blindly repeat.  Non-``retryable``
    exceptions, and ``retryable`` ones that ``retry_if`` rejects,
    propagate immediately; the final attempt's exception
    propagates once retries are exhausted.  Returns ``(result, attempts)``
    where ``attempts`` counts calls made (1 = first try succeeded).
    """
    sleep = sleep if sleep is not None else time.sleep
    attempt = 0
    while True:
        try:
            return fn(attempt), attempt + 1
        except retryable as exc:
            if attempt >= policy.retries or (retry_if is not None
                                             and not retry_if(exc)):
                raise
            if on_retry is not None:
                on_retry(attempt, exc)
            delay = backoff_ms(policy, attempt, seed)
            if delay > 0:
                sleep(delay / 1000.0)
            attempt += 1
