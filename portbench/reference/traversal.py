"""The plain reference of the served query kinds, in plain PyTorch.

Imports nothing of the program under test: it takes the benchmark's edge
arrays, builds its own undirected edge set and answers each query by
Bellman-Ford rounds, one lane at a time, on whatever device the arrays
are on. Every answer is an integer (a hop count, a sum of integer
weights, a membership), so the program's answers are compared with these
exactly.

  bfs    int32 hop depth from the source, -1 where unreached
  sssp   float32 shortest distance, +inf where unreached
  reach  bool, within ``hops`` hops of the source (the source included)

``rounds_short=1`` stops each lane one round before it converges: the
benchmark's control, an answer taken one step too early.
"""
from __future__ import annotations

import torch


def undirected(src: torch.Tensor, dst: torch.Tensor, weight: torch.Tensor,
               n: int) -> dict:
    """Both directions of every edge, self loops dropped, one copy of
    each (u, v). The weight of a pair is the same in every copy."""
    s = torch.cat([src, dst]).long()
    d = torch.cat([dst, src]).long()
    w = torch.cat([weight, weight]).float()
    keep = s != d
    s, d, w = s[keep], d[keep], w[keep]
    key, first = _first_of_each(s * n + d)
    return {"src": key // n, "dst": key % n, "weight": w[first], "n": n}


def _first_of_each(key: torch.Tensor):
    """(sorted distinct keys, an index of one occurrence of each)."""
    order = torch.argsort(key)
    key = key[order]
    head = torch.ones_like(key, dtype=torch.bool)
    head[1:] = key[1:] != key[:-1]
    return key[head], order[head]


def _relax(edges: dict, source: int, weight, max_rounds,
           rounds_short) -> torch.Tensor:
    """Bellman-Ford distances from ``source`` (``weight`` None: unit
    weights), ``rounds_short`` rounds before convergence."""
    src, dst, n = edges["src"], edges["dst"], edges["n"]
    dist = torch.full((n,), float("inf"), device=src.device)
    dist[source] = 0.0
    step = 1.0 if weight is None else weight
    history = [dist]
    rounds = 0
    while max_rounds is None or rounds < max_rounds:
        new = dist.scatter_reduce(0, dst, dist[src] + step, reduce="amin",
                                  include_self=True)
        if torch.equal(new, dist):
            break
        dist = new
        rounds += 1
        history = (history + [dist])[-(rounds_short + 1):]
    return history[0]


def bfs(edges: dict, source: int, rounds_short: int = 0) -> torch.Tensor:
    dist = _relax(edges, source, None, None, rounds_short)
    return torch.where(torch.isinf(dist), -1.0, dist).to(torch.int32)


def sssp(edges: dict, source: int, rounds_short: int = 0) -> torch.Tensor:
    return _relax(edges, source, edges["weight"], None, rounds_short)


def reach(edges: dict, source: int, hops: int,
          rounds_short: int = 0) -> torch.Tensor:
    return torch.isfinite(_relax(edges, source, None, hops - rounds_short,
                                 0))


def answer(kind: str, edges: dict, source: int, hops: int,
           rounds_short: int = 0) -> torch.Tensor:
    """The reference's answer to one query of ``kind``."""
    if kind == "bfs":
        return bfs(edges, source, rounds_short)
    if kind == "sssp":
        return sssp(edges, source, rounds_short)
    if kind == "reach":
        return reach(edges, source, hops, rounds_short)
    raise ValueError(f"no reference for query kind {kind!r}")
