"""Semirings for the sparse-linear-algebra layer (counterpart of
``repro.linalg.semiring``), float32 precision only.

A ``Semiring`` bundles an additive monoid ⊕ (how incoming edge
contributions merge) and a multiplicative combinator ⊗ (the per-edge
functor):

  plus_times — PageRank / SpMV proper
  min_plus   — shortest paths
  or_and     — reachability (on {0, 1}: or = max, and = min)
  max_min    — bottleneck paths
  plus_and   — intersection counting

``code`` is the semiring's index in ``SEMIRINGS``, the template
instance the CUDA SpMV kernel selects.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

_ADD = ("plus", "min", "max", "or")
_MUL = ("times", "plus", "min", "max", "and")


@dataclass(frozen=True)
class Semiring:
    """A (⊕, ⊗) pair with identities: ``zero`` is the ⊕-identity (the
    value of an empty or masked-out row), ``one`` the ⊗-identity."""

    name: str
    add: str
    mul: str
    zero: float
    one: float

    def __post_init__(self):
        if self.add not in _ADD:
            raise ValueError(f"unknown add monoid {self.add!r}")
        if self.mul not in _MUL:
            raise ValueError(f"unknown mul op {self.mul!r}")

    @property
    def code(self) -> int:
        return tuple(SEMIRINGS).index(self.name)

    def mul_op(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.mul == "times":
            return a * b
        if self.mul == "plus":
            return a + b
        if self.mul in ("min", "and"):
            return torch.minimum(a, b)
        return torch.maximum(a, b)

    def add_op(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.add == "plus":
            return a + b
        if self.add == "min":
            return torch.minimum(a, b)
        return torch.maximum(a, b)          # max | or

    def scatter_accum(self, target: torch.Tensor, index: torch.Tensor,
                      vals: torch.Tensor) -> torch.Tensor:
        """⊕-accumulate ``vals`` into ``target`` at ``index``. The plus
        fold on the CPU adds in index order (ascending here); min/max are
        order-independent."""
        if self.add == "plus":
            return target.index_add(0, index, vals)
        reduce = "amin" if self.add == "min" else "amax"
        return target.scatter_reduce(0, index.long(), vals, reduce)


plus_times = Semiring("plus_times", "plus", "times", 0.0, 1.0)
min_plus = Semiring("min_plus", "min", "plus", float("inf"), 0.0)
or_and = Semiring("or_and", "or", "and", 0.0, 1.0)
max_min = Semiring("max_min", "max", "min", float("-inf"), float("inf"))
plus_and = Semiring("plus_and", "plus", "and", 0.0, 1.0)

SEMIRINGS = {s.name: s for s in
             (plus_times, min_plus, or_and, max_min, plus_and)}


def get(semiring) -> Semiring:
    """Coerce a name or Semiring instance to a Semiring."""
    if isinstance(semiring, Semiring):
        return semiring
    try:
        return SEMIRINGS[semiring]
    except KeyError:
        raise ValueError(
            f"unknown semiring {semiring!r}; named semirings: "
            f"{sorted(SEMIRINGS)}") from None
