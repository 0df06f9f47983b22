"""Per-primitive compile budgets — the set-up counter's contract
(counterpart of ``repro.analysis.budgets``, same names and values).

The port compiles nothing per call: its counterpart of a trace is the
one-time set-up a primitive builds for a (graph, configuration) and
keeps in the graph's ``cache`` or a kernel cache (K1's first-slot table,
decoded or widened column views, PageRank's reciprocal degrees, K4's
long-row schedule, ...). A budget is the number of calls that build
such set-up ONE fixed workload configuration (same graph, same batch
width, same static options) may cost inside a
``sanitize.retrace_guard`` window, warmup included. A serving loop
builds each kind's set-up once and then reuses it; a primitive that
rebuilds it per call pays a graph-sized pass on every query — the
regression these budgets make un-ignorable.

Budgets are 1 wherever one configuration builds its set-up once. ``bc``
gets 2: a sweep in chunks may end on a ragged chunk, a second batch
width, as the reference's second trace does.
"""
from __future__ import annotations

COMPILE_BUDGETS: dict[str, int] = {
    "bfs": 1,
    "sssp": 1,
    "pagerank": 1,
    "cc": 1,
    "bc": 2,
    "tc": 1,
}


def budget_for(name: str) -> int:
    """The declared budget for ``name``; unknown names raise — an
    undeclared primitive must not silently get an infinite budget."""
    try:
        return COMPILE_BUDGETS[name]
    except KeyError:
        raise KeyError(
            f"no compile budget declared for primitive {name!r}; add it "
            f"to repro_torch.analysis.budgets.COMPILE_BUDGETS") from None
