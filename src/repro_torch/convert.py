"""Carry a graph, or a model's params, across from the reference package.

``graph_from_arrays`` builds a port :class:`~repro_torch.core.graph.Graph`
from the reference Graph's fields given as host numpy arrays
(``{f: np.asarray(getattr(g, f)) for f in TENSOR_FIELDS}``), so both
packages can run on the very same arrays. Each array keeps its dtype:
the column arrays their index dtype (int16, int32 or int64), the values
float32 or bfloat16 — a bfloat16 array (numpy's ``ml_dtypes`` type, or
its bits as uint16) becomes a ``torch.bfloat16`` tensor bit for bit.
The other index fields become int32. A field that is missing or None
stays None.

A delta-encoded graph has no dense columns; its encoded parts come in
``col_enc`` / ``csc_enc`` as ``{part: array}`` over the
:class:`~repro_torch.core.storage.EncodedCols` fields. ``plan``, the
reference plan's three fields as a dict, is taken as given; without one
it is read off the arrays.

``params_from_arrays`` carries a model's params tree — the reference's
initialized params as nested dicts of host numpy arrays
(``jax.tree.map(np.asarray, params)``) — to the port's tree on a
device: the same key paths, shapes and dtypes, bfloat16 bit for bit,
int8 as int8.

``opt_state_from_arrays`` carries an optimizer state — the reference's
``AdamWState(step, m, v)`` as host numpy (``jax.tree.map(np.asarray,
state)``), its quantized moments ``QTensor(codes, scale)`` leaves — to
the port's ``train.optimizer.AdamWState`` on a device, and
``opt_state_to_arrays`` carries the port's back to numpy (the port's
NamedTuples holding numpy leaves). Both read the NamedTuples by their
field names, so either package's classes will do.
"""
from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from .core import storage as S
from .core.graph import TENSOR_FIELDS, Graph
from .kernels.runtime import resolve_device
from .train.optimizer import AdamWState, QTensor

_VALUE_FIELDS = ("edge_values", "csc_edge_values")
_COL_FIELDS = ("col_indices", "csc_indices")
_NARROW = {np.dtype(np.int16): "int16", np.dtype(np.int32): "int32",
           np.dtype(np.int64): "int64"}


def _bf16(a: np.ndarray, dev) -> torch.Tensor:
    bits = np.ascontiguousarray(a).view(np.int16).copy()
    return torch.from_numpy(bits).view(torch.bfloat16).to(dev)


def _values(a: np.ndarray, dev) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16" or a.dtype == np.uint16:
        return _bf16(a, dev)
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)


_PARAM_DTYPES = (np.dtype(np.float32), np.dtype(np.int8),
                 np.dtype(np.int32))


def params_from_arrays(tree: Mapping, device=None) -> dict:
    """The port's params tree from the reference's as nested dicts of
    numpy arrays: each leaf a tensor on ``device`` (None: the card) of
    the same shape and dtype (bfloat16 — numpy's ``ml_dtypes`` type —
    bit for bit; float32, int8, int32 as they are)."""
    dev = resolve_device(device)

    def leaf(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return _bf16(a, dev)
        if a.dtype not in _PARAM_DTYPES:
            raise ValueError(f"unsupported param dtype {a.dtype}")
        return torch.from_numpy(np.array(a)).to(dev)

    return {k: params_from_arrays(v, dev) if isinstance(v, Mapping)
            else leaf(v) for k, v in tree.items()}


def _moments(tree, fn):
    if isinstance(tree, Mapping):
        return {k: _moments(v, fn) for k, v in tree.items()}
    if hasattr(tree, "codes") and hasattr(tree, "scale"):
        return QTensor(codes=fn(tree.codes), scale=fn(tree.scale))
    return fn(tree)


def opt_state_from_arrays(state, device=None) -> AdamWState:
    """The port's ``AdamWState`` from an ``AdamWState``-like of numpy
    arrays (``step``, ``m``, ``v``; ``codes`` / ``scale`` leaves for the
    quantized moments): each a tensor on ``device`` (None: the card) of
    the same shape and dtype."""
    dev = resolve_device(device)

    def leaf(a):
        return torch.from_numpy(np.array(a)).to(dev)

    return AdamWState(step=leaf(state.step), m=_moments(state.m, leaf),
                      v=_moments(state.v, leaf))


def opt_state_to_arrays(state: AdamWState) -> AdamWState:
    """The port's ``AdamWState`` with every leaf a host numpy array."""
    def leaf(t):
        return t.detach().cpu().numpy()

    return AdamWState(step=leaf(state.step), m=_moments(state.m, leaf),
                      v=_moments(state.v, leaf))


def _encoded(parts: Mapping[str, np.ndarray], dev) -> S.EncodedCols:
    def t(name, dtype):
        return torch.from_numpy(np.array(parts[name], dtype=dtype)).to(dev)

    return S.EncodedCols(anchor=t("anchor", np.int32),
                         delta=t("delta", np.uint16),
                         esc_pos=t("esc_pos", np.int32),
                         esc_val=t("esc_val", np.int32),
                         row_seg=t("row_seg", np.int32))


def graph_from_arrays(fields: Mapping[str, Optional[np.ndarray]], *,
                      ell_width: Optional[int],
                      csc_ell_width: Optional[int],
                      plan: Optional[Mapping[str, str]] = None,
                      col_enc: Optional[Mapping[str, np.ndarray]] = None,
                      csc_enc: Optional[Mapping[str, np.ndarray]] = None,
                      device=None) -> Graph:
    unknown = set(fields) - set(TENSOR_FIELDS)
    if unknown:
        raise ValueError(f"unknown Graph fields {sorted(unknown)}")
    if fields.get("row_offsets") is None:
        raise ValueError("graph_from_arrays needs 'row_offsets'")
    if fields.get("col_indices") is None and col_enc is None:
        raise ValueError("graph_from_arrays needs 'col_indices' or col_enc")
    dev = resolve_device(device)
    kw = {}
    for name in TENSOR_FIELDS:
        a = fields.get(name)
        if a is None or np.asarray(a).shape == ():
            kw[name] = None
        elif name in _VALUE_FIELDS:
            kw[name] = _values(a, dev)
        elif name in _COL_FIELDS:
            a = np.asarray(a)
            dtype = a.dtype if a.dtype in _NARROW else np.dtype(np.int32)
            kw[name] = torch.from_numpy(np.array(a, dtype=dtype)).to(dev)
        else:
            kw[name] = torch.from_numpy(np.array(a, dtype=np.int32)).to(dev)
    enc = {"col_enc": None if col_enc is None else _encoded(col_enc, dev),
           "csc_enc": None if csc_enc is None else _encoded(csc_enc, dev)}
    if plan is not None:
        plan = S.StoragePlan(**plan)
    else:
        cols, values = kw["col_indices"], kw["edge_values"]
        n = int(kw["row_offsets"].shape[0]) - 1
        plan = S.StoragePlan(
            index_dtype=(S.plan_for(n).index_dtype if cols is None
                         else str(cols.dtype).replace("torch.", "")),
            encoding="dense" if col_enc is None else "delta",
            value_dtype=("bf16" if values is not None
                         and values.dtype == torch.bfloat16 else "fp32"))
    return Graph(**kw, **enc,
                 ell_width=None if ell_width is None else int(ell_width),
                 csc_ell_width=(None if csc_ell_width is None
                                else int(csc_ell_width)),
                 plan=plan)
