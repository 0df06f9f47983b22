"""Direction-optimized traversal heuristics (paper §5.1.4, eqs. 1–6),
counterpart of ``repro.core.direction``.

Gunrock estimates the push and pull workloads from frontier
cardinalities (eqs. 3/4) and switches with tunable do_a / do_b
(eqs. 5/6). The arithmetic is float32, operand for operand as in the
reference, so both packages switch on the same iterations.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

PUSH = 0
PULL = 1


class DirectionParams(NamedTuple):
    do_a: float = 0.001
    do_b: float = 0.200
    enabled: bool = True


def estimate_workloads(n_f: torch.Tensor, n_u: torch.Tensor, n: int,
                       m: int):
    """Paper eqs. (3) and (4): m_f = n_f·m/n ; m_u = n_u·n/(n−n_u)."""
    n_f = n_f.to(torch.float32)
    n_u = n_u.to(torch.float32)
    m_f = n_f * (m / n)
    m_u = n_u * n / torch.clamp(n - n_u, min=1.0)
    return m_f, m_u


def decide_direction(mode: torch.Tensor, n_f: torch.Tensor,
                     n_u: torch.Tensor, n: int, m: int,
                     params: DirectionParams) -> torch.Tensor:
    """The next traversal mode per lane (paper eqs. 5/6): push→pull when
    m_f > m_u·do_a ; pull→push when m_f < m_u·do_b."""
    if not params.enabled:
        return torch.full_like(mode, PUSH)
    m_f, m_u = estimate_workloads(n_f, n_u, n, m)
    to_pull = m_f > m_u * params.do_a
    to_push = m_f < m_u * params.do_b
    out = torch.where(mode == PUSH,
                      torch.where(to_pull, PULL, PUSH),
                      torch.where(to_push, PUSH, PULL))
    return out.to(torch.int32)
