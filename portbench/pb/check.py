"""Whether what the timed path served is correct.

During the window, every flush's served answer field (the host copy
``serve_mixed`` makes of a batch's answers) is offered to a seeded
reservoir that keeps a fixed number of flushes of each kind. Once the
window has closed and the program's state is freed, the plain reference
answers each kept query from the benchmark's own edge arrays, and every
entry of each served row is compared with it exactly: all answers are
integers. A number compared is the count of differing entries over a
kind's kept queries; its limit is 0. Each check is
``{"value": v, "max": limit}`` or ``{"value": v, "min": limit}``.
"""
from __future__ import annotations

import numpy as np


class Reservoir:
    """Uniform sample of ``per_kind[kind]`` flushes of each kind, drawn
    from the seed, whatever the number of flushes."""

    def __init__(self, per_kind: dict, seed: int):
        self.rng = np.random.default_rng([int(seed) % (1 << 64), 0x5A4D])
        self.per_kind = dict(per_kind)
        self.seen = {k: 0 for k in per_kind}
        self.kept = {k: [] for k in per_kind}

    def offer(self, kind: str, srcs: list, field: np.ndarray) -> None:
        k = self.per_kind.get(kind, 0)
        i = self.seen.get(kind, 0)
        self.seen[kind] = i + 1
        if k == 0:
            return
        if i < k:
            self.kept[kind].append((srcs, field))
            return
        j = int(self.rng.integers(0, i + 1))
        if j < k:
            self.kept[kind][j] = (srcs, field)


def mismatches(served: np.ndarray, want: np.ndarray) -> int:
    """Entries of a served row that differ from the reference's."""
    served = np.asarray(served)
    if served.shape != want.shape:
        return int(want.size)
    return int(np.count_nonzero(served != want))


def compare(kept: dict, answer, hops: int) -> tuple[dict, int]:
    """The checks of one run and the number of wrong queries: per kind,
    the entries that differ over the kept queries (limit 0) and the
    number of queries compared (at least one). ``answer(kind, source,
    hops)`` is the reference's answer as a host array."""
    checks = {}
    wrong_queries = 0
    for kind, flushes in kept.items():
        wrong = 0
        compared = 0
        for srcs, field in flushes:
            for lane, src in enumerate(srcs):
                bad = mismatches(field[lane], answer(kind, src, hops))
                wrong += bad
                wrong_queries += bad > 0
                compared += 1
        checks[f"{kind}_wrong_entries"] = {"value": wrong, "max": 0}
        checks[f"{kind}_queries_compared"] = {"value": compared, "min": 1}
    return checks, wrong_queries


def passed(checks: dict) -> bool:
    """Every number within its limit: ``max`` from above, ``min`` from
    below."""
    return all(c["value"] <= c.get("max", c["value"])
               and c["value"] >= c.get("min", c["value"])
               for c in checks.values())
