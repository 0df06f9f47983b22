"""Semiring sparse linear algebra: the SpMV and SpMM sweeps, the sparse-
vector product and the masked SpGEMM."""
from . import semiring
from .ops import mxm, spmm, spmsv, spmv
from .semiring import plus_and, plus_times

__all__ = ["mxm", "plus_and", "plus_times", "semiring", "spmm", "spmsv",
           "spmv"]
