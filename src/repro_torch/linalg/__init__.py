"""Semiring sparse linear algebra: the SpMV sweep and the masked SpGEMM."""
from . import semiring
from .ops import mxm, spmv
from .semiring import plus_and, plus_times

__all__ = ["mxm", "plus_and", "plus_times", "semiring", "spmv"]
