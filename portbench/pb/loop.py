"""Traffic: one general generator of query streams from a mix file, and
the saturated closed loop that feeds them to the program's serving
entry, ``repro_torch.launch.graph_serve.serve_mixed``.

A mix file (``traffic/<mix>.json``) holds

  loop     "closed_saturated": a backlog always waits, so serving runs
           at capacity (the only loop this generator has)
  batch    serve_mixed's batch slots (one width for every kind)
  chunk    queries of each kind in one chunk, each a multiple of batch,
           so no flush is a padded ragged tail
  hops     k of reach queries
  sample   flushes of each kind the correctness check keeps

The window serves chunks, each in a seeded shuffled order of kinds with
sources drawn from the seed among the vertices of degree >= 1, until
``seconds`` have passed; it ends with the chunk that passes them. A
query's latency runs from its enqueue (serve_mixed reaching it) to its
batch's host copy, as serve_mixed records it.
"""
from __future__ import annotations

import collections
import contextlib
import time

import numpy as np

LOOPS = ("closed_saturated",)


def check_mix(mix: dict) -> None:
    """Reject a mix the loop cannot serve as stated."""
    if mix.get("loop") not in LOOPS:
        raise ValueError(f"unknown loop {mix.get('loop')!r}; have {LOOPS}")
    batch = int(mix["batch"])
    for kind, count in mix["chunk"].items():
        if count <= 0 or count % batch:
            raise ValueError(f"chunk of {count} {kind} queries is no "
                             f"positive multiple of the batch {batch}")


class Traffic:
    """Chunks of (kind, source) queries drawn from ``seed``; ``stream``
    keeps warm-up and window draws apart."""

    def __init__(self, mix: dict, eligible: np.ndarray, seed: int,
                 stream: int):
        check_mix(mix)
        self.kinds = [k for k, c in mix["chunk"].items() for _ in range(c)]
        self.eligible = eligible
        self.rng = np.random.default_rng([int(seed) % (1 << 64),
                                          int(stream)])

    def chunk(self) -> list:
        order = self.rng.permutation(len(self.kinds))
        srcs = self.eligible[self.rng.integers(0, len(self.eligible),
                                               len(self.kinds))]
        return [(self.kinds[i], int(s)) for i, s in zip(order, srcs)]


def plan_flushes(queries: list, batch: int) -> list:
    """The (kind, sources) of each flush serve_mixed makes of
    ``queries``: a kind's slots flush the moment they fill."""
    pending = collections.defaultdict(list)
    out = []
    for kind, src in queries:
        pending[kind].append(src)
        if len(pending[kind]) == batch:
            out.append((kind, pending.pop(kind)))
    return out


@contextlib.contextmanager
def capturing(gs, expected: collections.deque, offer):
    """Route every served answer field (the 2-D host copies serve_mixed
    makes) to ``offer(kind, sources, field)``, matched in order with the
    planned flushes in ``expected``."""
    host = gs._host

    def capture(x):
        out = host(x)
        if out.ndim == 2:
            kind, srcs = expected.popleft()
            offer(kind, srcs, out)
        return out

    gs._host = capture
    try:
        yield
    finally:
        gs._host = host


def serve(gs, g, queries: list, mix: dict, backend: str) -> dict:
    return gs.serve_mixed(g, queries, int(mix["batch"]), backend,
                          hops=int(mix.get("hops", 3)))


def window(gs, g, traffic: Traffic, mix: dict, backend: str,
           seconds: float, offer, span=contextlib.nullcontext) -> dict:
    """Serve chunks for ``seconds``; every query's record, every flush's
    record, the window's length and the answers left unmatched."""
    expected = collections.deque()
    records, flushes = [], []
    t0 = time.monotonic()
    with capturing(gs, expected, offer):
        while True:
            queries = traffic.chunk()
            expected.extend(plan_flushes(queries, int(mix["batch"])))
            with span():
                stats = serve(gs, g, queries, mix, backend)
            records.extend(stats["queries"])
            flushes.extend(stats["flushes"])
            t_end = time.monotonic()
            if t_end - t0 >= seconds:
                break
    return {"records": records, "flushes": flushes,
            "window_s": t_end - t0, "unmatched": len(expected)}
