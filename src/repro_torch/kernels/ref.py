"""The plain PyTorch version of every CUDA kernel (counterpart of
``repro.kernels.ref``).

Each plain version is the ``"torch"`` registry provider of the same op —
the bit-exact twin of the reference's ``xla`` provider — so the CUDA
kernels are held against exactly what the CPU tests hold against the
reference. The kernel wrappers in ``kernels.ops`` run these on CPU
tensors; ``chip_smoke.py`` runs them on the card to compare.
"""
from __future__ import annotations

from ..core.frontier import _compact_torch as compact
from ..core.operators import _advance_batch_torch as advance_batch
from ..core.operators import _advance_filter_batch_torch as advance_filter_batch
from ..core.operators import _segment_locate_torch as segment_locate
from ..core.operators import _segment_search_torch as segment_search
from ..linalg.ops import _spmv_torch as spmv

__all__ = ["advance_batch", "advance_filter_batch", "compact",
           "segment_locate", "segment_search", "spmv"]
