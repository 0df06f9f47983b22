"""Semirings for the sparse-linear-algebra layer (counterpart of
``repro.linalg.semiring``).

A ``Semiring`` bundles an additive monoid ⊕ (how incoming edge
contributions merge) and a multiplicative combinator ⊗ (the per-edge
functor):

  plus_times — PageRank / SpMV proper
  min_plus   — shortest paths
  or_and     — reachability (on {0, 1}: or = max, and = min)
  max_min    — bottleneck paths
  plus_and   — intersection counting

Mixed precision (the reference's): ``with_precision(sr, "bf16")`` is a
variant whose ⊗ rounds both operands to bfloat16 (to nearest even),
rounds the product to bfloat16 and widens it back to float32 for the ⊕
fold, which stays float32. A structural matrix (no values) has no
multiply: its product, the gathered operand, still rounds to bfloat16
(``round_prod``). Only the plus-accumulating semirings admit it.

``code`` is the template instance the CUDA SpMV kernels select: the
semiring's index in ``SEMIRINGS``, or 5 / 6 for bf16 plus_times /
plus_and.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

_ADD = ("plus", "min", "max", "or")
_MUL = ("times", "plus", "min", "max", "and")
_PRECISIONS = ("fp32", "bf16")
_BF16_CODES = {"plus_times": 5, "plus_and": 6}


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.bfloat16)


@dataclass(frozen=True)
class Semiring:
    """A (⊕, ⊗) pair with identities: ``zero`` is the ⊕-identity (the
    value of an empty or masked-out row), ``one`` the ⊗-identity."""

    name: str
    add: str
    mul: str
    zero: float
    one: float
    precision: str = "fp32"  # ⊗ rounding: "fp32" | "bf16"

    def __post_init__(self):
        if self.add not in _ADD:
            raise ValueError(f"unknown add monoid {self.add!r}")
        if self.mul not in _MUL:
            raise ValueError(f"unknown mul op {self.mul!r}")
        if self.precision not in _PRECISIONS:
            raise ValueError(f"unknown precision {self.precision!r}; "
                             f"expected one of {_PRECISIONS}")
        if self.precision == "bf16" and self.add != "plus":
            raise ValueError(
                f"bf16 precision is only defined for plus-accumulating "
                f"semirings (plus_times / plus_and); {self.name!r} is an "
                f"exact selection semiring")

    @property
    def code(self) -> int:
        if self.precision == "bf16":
            return _BF16_CODES[self.name]
        return tuple(SEMIRINGS).index(self.name)

    def mul_op(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """⊗ of two tensors. Under bf16 both operands and the product
        round to bfloat16, and the product widens to float32."""
        if self.precision == "bf16":
            a, b = _bf16(a), _bf16(b)
        if self.mul == "times":
            out = a * b
        elif self.mul == "plus":
            out = a + b
        elif self.mul in ("min", "and"):
            out = torch.minimum(a, b)
        else:
            out = torch.maximum(a, b)
        return out.to(torch.float32) if self.precision == "bf16" else out

    def round_prod(self, x: torch.Tensor) -> torch.Tensor:
        """The product of a structural matrix (the gathered operand
        itself), rounded to bfloat16 and widened under bf16; the identity
        under fp32."""
        if self.precision == "bf16":
            return _bf16(x).to(torch.float32)
        return x

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


def with_precision(semiring, precision: str = "fp32") -> Semiring:
    """The ``precision`` variant of a semiring: ``"fp32"`` is the
    semiring itself; ``"bf16"`` is refused for the selection semirings
    (min, max, or), whose results are exact."""
    sr = get(semiring)
    if precision == sr.precision:
        return sr
    return dataclasses.replace(sr, precision=precision)
