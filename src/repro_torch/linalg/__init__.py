"""Semiring sparse linear algebra (the SpMV sweep)."""
from . import semiring
from .ops import spmv

__all__ = ["semiring", "spmv"]
