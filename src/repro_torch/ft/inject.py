"""Deterministic, seeded fault injection (counterpart of
``repro.ft.inject``): the chaos rig the serving layer is tested against.

A :class:`FaultPlan` is parsed from a compact spec and installed with the
:func:`faults` context manager (``graph_serve --faults SPEC
--faults-seed N``; the port reads no environment variable). Spec:
semicolon-separated clauses ``kind[:site]@prob``::

    provider_miss@0.3;nan@0.2;straggler:bfs@0.1

Kinds:

``provider_miss``
    ``repro_torch.core.backend.dispatch`` misses as if the registry had
    no provider (site: the op name), and the serving loop's batch
    dispatch misses (site: the query kind) — exercises retry and the
    degradation ladder.
``nan``
    Poisons a served batch's host copy with a NaN — exercises the
    serving loop's NaN/Inf guardrail.
``straggler``
    Stalls a batch flush on the host — exercises the straggler watchdog.
``shard_loss``
    The serving loop's flush of a sharded or 2-D placement raises
    :class:`ShardLossError` as if a part's device dropped out (site: the
    query kind) — exercises the placement rungs 2d → sharded → single.

Determinism: each (kind, site) pair draws from its own counter-indexed
sha256 stream seeded by ``(seed, kind, site)`` — the reference's
``_draw``, byte for byte — so a spec and seed give the same schedule in
both packages, and a site sees the same schedule whatever other sites
do. With no plan installed every hook is one ``None`` check.
"""
from __future__ import annotations

import contextlib
import hashlib
from typing import Dict, Optional, Tuple

KINDS = ("provider_miss", "nan", "straggler", "shard_loss")

_PLAN: Optional["FaultPlan"] = None


class ShardLossError(RuntimeError):
    """A graph shard's device dropped out mid-batch (``injected`` when a
    fault plan raised it)."""

    def __init__(self, msg: str = "", *, injected: bool = False):
        super().__init__(msg)
        self.injected = injected


class FaultSpecError(ValueError):
    """A fault spec string could not be parsed."""


def _parse(spec: str) -> Dict[str, Tuple[str, float]]:
    plan: Dict[str, Tuple[str, float]] = {}
    for clause in spec.split(";"):
        clause = clause.strip()
        if not clause:
            continue
        head, sep, prob_s = clause.partition("@")
        if not sep:
            raise FaultSpecError(
                f"fault clause {clause!r} has no '@prob' part "
                f"(expected 'kind[:site]@prob')")
        kind, _, site = head.partition(":")
        kind = kind.strip()
        if kind not in KINDS:
            raise FaultSpecError(f"unknown fault kind {kind!r}; known "
                                 f"kinds: {', '.join(KINDS)}")
        try:
            prob = float(prob_s)
        except ValueError:
            raise FaultSpecError(f"fault clause {clause!r}: bad probability "
                                 f"{prob_s!r}") from None
        if not 0.0 <= prob <= 1.0:
            raise FaultSpecError(
                f"fault clause {clause!r}: probability must be in [0, 1]")
        plan[kind] = (site.strip(), prob)
    return plan


def _draw(seed: int, kind: str, site: str, n: int) -> float:
    """n-th uniform in [0, 1) of the (seed, kind, site) stream."""
    h = hashlib.sha256(f"{seed}:{kind}:{site}:{n}".encode()).digest()
    return int.from_bytes(h[:8], "big") / float(1 << 64)


class FaultPlan:
    """Parsed fault schedule with per-site deterministic draw counters."""

    def __init__(self, spec: str, seed: int = 0):
        self.spec = spec
        self.seed = int(seed)
        self.clauses = _parse(spec)
        self._counters: Dict[Tuple[str, str], int] = {}
        self.fired: Dict[str, int] = {k: 0 for k in self.clauses}

    def should(self, kind: str, site: str = "") -> bool:
        """Deterministically decide whether this call site faults now."""
        clause = self.clauses.get(kind)
        if clause is None:
            return False
        want_site, prob = clause
        if want_site and want_site != site:
            return False
        key = (kind, site)
        n = self._counters.get(key, 0)
        self._counters[key] = n + 1
        hit = _draw(self.seed, kind, site, n) < prob
        if hit:
            self.fired[kind] += 1
        return hit

    def __repr__(self):
        return f"FaultPlan({self.spec!r}, seed={self.seed})"


def active() -> Optional[FaultPlan]:
    """The installed plan, or None (the fast path) when chaos is off."""
    return _PLAN


@contextlib.contextmanager
def faults(spec: str, seed: int = 0):
    """Install a seeded fault plan for the duration of the block."""
    global _PLAN
    prev = _PLAN
    _PLAN = FaultPlan(spec, seed)
    try:
        yield _PLAN
    finally:
        _PLAN = prev
