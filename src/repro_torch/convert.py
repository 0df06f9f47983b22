"""Carry a graph across from the reference package.

``graph_from_arrays`` builds a port :class:`~repro_torch.core.graph.Graph`
from the reference Graph's fields given as host numpy arrays
(``{f: np.asarray(getattr(g, f)) for f in TENSOR_FIELDS}``), so both
packages can run on the very same arrays. Index fields become int32,
value fields float32; a field that is missing or None stays None.
"""
from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from .core.graph import TENSOR_FIELDS, Graph
from .kernels.runtime import resolve_device

_VALUE_FIELDS = ("edge_values", "csc_edge_values")


def graph_from_arrays(fields: Mapping[str, Optional[np.ndarray]], *,
                      ell_width: Optional[int],
                      csc_ell_width: Optional[int],
                      device=None) -> Graph:
    unknown = set(fields) - set(TENSOR_FIELDS)
    if unknown:
        raise ValueError(f"unknown Graph fields {sorted(unknown)}")
    for need in ("row_offsets", "col_indices"):
        if fields.get(need) is None:
            raise ValueError(f"graph_from_arrays needs {need!r}")
    dev = resolve_device(device)
    kw = {}
    for name in TENSOR_FIELDS:
        a = fields.get(name)
        if a is None:
            kw[name] = None
            continue
        dtype = np.float32 if name in _VALUE_FIELDS else np.int32
        kw[name] = torch.from_numpy(np.array(a, dtype=dtype)).to(dev)
    return Graph(**kw,
                 ell_width=None if ell_width is None else int(ell_width),
                 csc_ell_width=(None if csc_ell_width is None
                                else int(csc_ell_width)))
