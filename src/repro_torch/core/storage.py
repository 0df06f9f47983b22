"""Graph storage plans (counterpart of ``repro.core.storage``).

Traversal streams the column arrays, so bytes per edge bound its speed.
Three knobs, chosen once at ``Graph.from_csr`` and carried as the
graph's :class:`StoragePlan`:

  index dtype   int16 | int32 | int64 — the narrowest type that holds
                every vertex id (``-1`` stays free as the invalid lane),
                picked from ``n`` by :func:`plan_for`; an explicit
                ``index_dtype=`` must still be wide enough.
  encoding      "dense" — the column array at the index dtype. "delta" —
                per-row anchored deltas: row r is ``anchor[r]`` (its
                first neighbour, int32) plus uint16 ``delta[e] = col[e] -
                anchor[r]``. A delta above 0xFFFE stores the sentinel
                0xFFFF, and the true value rides in a sorted (position,
                value) side list (an "escape").
  value dtype   "fp32" | "bf16" — the resident type of the edge values;
                compute promotes them to float32.

Anchored deltas keep O(1) access: ``col[e] = anchor[row(e)] + delta[e]``,
so the advance kernels decode in place with one extra gather.
:func:`gather_cols` is the decode every plain PyTorch consumer goes
through (per touched edge); :func:`decode_cols` is the dense int32 view
for providers that declared only ``"dense"`` (``core.backend.storage_arg``
inserts it).

PyTorch indexes with int32 and int64 tensors only and has few operations
on uint16, so every read returns int32: narrow dense columns are widened
after the gather, and the uint16 stream is gathered through its int16
view and masked back to 0 … 0xFFFF.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from ..analysis import sanitize

INDEX_DTYPES = ("int16", "int32", "int64")
ENCODINGS = ("dense", "delta")
VALUE_DTYPES = ("fp32", "bf16")

# uint16 delta stream: 0xFFFF marks an escaped slot (true value in the
# side list); 0xFFFE is therefore the largest inline delta
DELTA_ESCAPE = 0xFFFF
DELTA_MAX = 0xFFFE

_NP_INDEX = {"int16": np.int16, "int32": np.int32, "int64": np.int64}
_TORCH_INDEX = {"int16": torch.int16, "int32": torch.int32,
                "int64": torch.int64}
# the largest vertex id each dtype holds, keeping -1 free
_MAX_ID = {"int16": 2**15 - 1, "int32": 2**31 - 1, "int64": 2**63 - 1}


@dataclass(frozen=True)
class StoragePlan:
    """The build-time storage decision (frozen, hashable)."""

    index_dtype: str = "int32"
    encoding: str = "dense"
    value_dtype: str = "fp32"

    def __post_init__(self):
        if self.index_dtype not in INDEX_DTYPES:
            raise ValueError(f"index_dtype must be one of {INDEX_DTYPES}, "
                             f"got {self.index_dtype!r}")
        if self.encoding not in ENCODINGS:
            raise ValueError(f"encoding must be one of {ENCODINGS}, "
                             f"got {self.encoding!r}")
        if self.value_dtype not in VALUE_DTYPES:
            raise ValueError(f"value_dtype must be one of {VALUE_DTYPES}, "
                             f"got {self.value_dtype!r}")

    @property
    def np_index_dtype(self):
        return _NP_INDEX[self.index_dtype]

    @property
    def torch_index_dtype(self) -> torch.dtype:
        return _TORCH_INDEX[self.index_dtype]

    @property
    def torch_value_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.value_dtype == "bf16" else torch.float32

    @property
    def index_bytes(self) -> int:
        return np.dtype(self.np_index_dtype).itemsize


def plan_for(n: int, *, index_dtype: Optional[str] = None,
             encoding: str = "dense",
             value_dtype: str = "fp32") -> StoragePlan:
    """The storage plan of an ``n``-vertex graph: with no override the
    narrowest dtype whose id range covers ``n - 1`` (int16 up to 32,767
    vertices, int32 up to 2^31 - 1, int64 beyond); an explicit
    ``index_dtype`` that cannot hold the ids raises."""
    max_id = max(n - 1, 0)
    if index_dtype is None:
        for cand in INDEX_DTYPES:
            if max_id <= _MAX_ID[cand]:
                index_dtype = cand
                break
    elif index_dtype not in INDEX_DTYPES:
        raise ValueError(f"index_dtype must be one of {INDEX_DTYPES}, "
                         f"got {index_dtype!r}")
    elif max_id > _MAX_ID[index_dtype]:
        raise ValueError(
            f"index_dtype={index_dtype!r} cannot hold vertex ids up to "
            f"{max_id} (max {_MAX_ID[index_dtype]})")
    return StoragePlan(index_dtype=index_dtype, encoding=encoding,
                       value_dtype=value_dtype)


class EncodedCols(NamedTuple):
    """Delta-encoded column storage, passed in the registry's column slot
    where the dense array would go.

    anchor   (n,) int32   first neighbour id of each row (0 if empty)
    delta    (m,) uint16  col - anchor[row]; 0xFFFF = escaped slot
    esc_pos  (K,) int32   edge positions of escaped slots, ascending
    esc_val  (K,) int32   true column values at those positions
    row_seg  (m,) int32   edge → row map
    """

    anchor: torch.Tensor
    delta: torch.Tensor
    esc_pos: torch.Tensor
    esc_val: torch.Tensor
    row_seg: torch.Tensor

    @property
    def num_edges(self) -> int:
        return int(self.delta.shape[0])

    @property
    def num_escapes(self) -> int:
        return int(self.esc_pos.shape[0])

    @property
    def device(self) -> torch.device:
        return self.anchor.device


ColStore = Union[torch.Tensor, EncodedCols]


def encode_delta(offsets: np.ndarray, cols: np.ndarray, row_seg: np.ndarray,
                 device=None) -> EncodedCols:
    """Host-side delta encoder (the reference's, array for array).
    ``cols`` must be sorted within each row, so deltas are non-negative
    and decoded rows stay sorted."""
    offsets = np.asarray(offsets, np.int64)
    cols64 = np.asarray(cols, np.int64)
    seg = np.asarray(row_seg, np.int64)
    n = len(offsets) - 1
    anchor = np.zeros(n, np.int32)
    nonempty = offsets[:-1] < offsets[1:]
    anchor[nonempty] = cols64[offsets[:-1][nonempty]]
    d = cols64 - anchor.astype(np.int64)[seg]
    if len(d) and d.min() < 0:
        raise ValueError("delta encoding requires sorted neighbor lists "
                         "(build the Graph with sort_neighbors=True)")
    esc = np.nonzero(d > DELTA_MAX)[0].astype(np.int32)
    delta = np.where(d > DELTA_MAX, DELTA_ESCAPE, d).astype(np.uint16)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return EncodedCols(anchor=t(anchor), delta=t(delta), esc_pos=t(esc),
                       esc_val=t(cols64[esc].astype(np.int32)),
                       row_seg=t(np.asarray(row_seg, np.int32)))


def _delta_at(delta: torch.Tensor, eid: torch.Tensor) -> torch.Tensor:
    """delta[eid] as int32 in 0 … 0xFFFF (gathered through the int16
    view: PyTorch has no uint16 gather on every version)."""
    d = torch.index_select(delta.view(torch.int16), 0, eid.reshape(-1))
    return (d.to(torch.int32) & 0xFFFF).reshape(eid.shape)


def decode_cols(store: ColStore) -> torch.Tensor:
    """The dense int32 column view (one gather, one add and an escape
    scatter for a delta store; a widening copy for a narrow dense one)."""
    if not isinstance(store, EncodedCols):
        return store if store.dtype == torch.int32 else store.to(torch.int32)
    dense = (torch.index_select(store.anchor, 0, store.row_seg)
             + (store.delta.view(torch.int16).to(torch.int32) & 0xFFFF))
    if store.num_escapes:
        dense[store.esc_pos.long()] = store.esc_val
    return dense


def gather_cols(store: ColStore, eid: torch.Tensor,
                src: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Column values at edge positions ``eid`` (any shape, int32 or
    int64), as int32 whatever the storage. ``src``, the owning row of
    each ``eid`` when the caller has it, saves the row lookup of a delta
    store. Escaped slots are patched by a binary search of the sorted
    escape list. An edgeless store reads 0 everywhere."""
    if store_num_edges(store) == 0:
        return torch.zeros(eid.shape, dtype=torch.int32, device=eid.device)
    flat = eid.reshape(-1)
    if flat.dtype not in (torch.int32, torch.int64):
        flat = flat.long()
    if not isinstance(store, EncodedCols):
        out = torch.index_select(store, 0, flat)
        out = out if out.dtype == torch.int32 else out.to(torch.int32)
        return out.reshape(eid.shape)
    row = (torch.index_select(store.row_seg, 0, flat) if src is None
           else src.reshape(-1))
    out = (torch.index_select(store.anchor, 0, row)
           + _delta_at(store.delta, flat))
    if store.num_escapes:
        j = torch.searchsorted(store.esc_pos, flat.to(torch.int32),
                               out_int32=True)
        j = j.clamp_(0, store.num_escapes - 1)
        hit = torch.index_select(store.esc_pos, 0, j) == flat
        out = torch.where(hit, torch.index_select(store.esc_val, 0, j), out)
    return out.reshape(eid.shape)


def dense_view(store: ColStore, cache: Optional[dict]) -> torch.Tensor:
    """:func:`decode_cols` of ``store``, kept in ``cache`` (a graph's) so
    a store is decoded or widened once per graph; a dense int32 store is
    returned as it is."""
    if not isinstance(store, EncodedCols) and store.dtype == torch.int32:
        return store
    if cache is None:
        return decode_cols(store)
    # the entry keeps its source alive, so no other tensor takes its id
    src = store.delta if isinstance(store, EncodedCols) else store
    hit = cache.get(("dense_cols", id(src)))
    if hit is None or hit[0] is not src:
        hit = cache[("dense_cols", id(src))] = (src, decode_cols(store))
        sanitize.note_setup()
    return hit[1]


def store_num_edges(store: ColStore) -> int:
    """Edge count of a column store (dense array or delta stream)."""
    if isinstance(store, EncodedCols):
        return store.num_edges
    return int(store.shape[0])


def _nbytes(a: Optional[torch.Tensor]) -> int:
    return 0 if a is None else a.element_size() * a.numel()


def store_bytes(store: Optional[ColStore]) -> int:
    """Resident bytes of one column store (dense array or delta parts;
    the edge → row map is counted with the graph's, not here)."""
    if store is None:
        return 0
    if isinstance(store, EncodedCols):
        return sum(_nbytes(a) for a in (store.anchor, store.delta,
                                        store.esc_pos, store.esc_val))
    return _nbytes(store)


def resident_bytes(graph) -> dict:
    """Per-array resident bytes of a Graph, keyed as the reference keys
    them. ``bytes_per_edge`` is the column storage (CSR + CSC neighbour
    ids, what every advance and SpMV step streams) over m; the offsets
    and edge → row maps count in ``total_bytes`` only."""
    arrays = {
        "row_offsets": _nbytes(graph.row_offsets),
        "col_storage": store_bytes(graph.col_store),
        "edge_values": _nbytes(graph.edge_values),
        "csc_offsets": _nbytes(graph.csc_offsets),
        "csc_col_storage": store_bytes(graph.csc_store),
        "csc_edge_values": _nbytes(graph.csc_edge_values),
        "csc_edge_ids": _nbytes(graph.csc_edge_ids),
        "row_seg": _nbytes(graph.row_seg),
        "csc_row_seg": _nbytes(graph.csc_row_seg),
        "overflow_lists": (_nbytes(graph.over_pos) + _nbytes(graph.over_row)
                           + _nbytes(graph.csc_over_pos)
                           + _nbytes(graph.csc_over_row)),
    }
    m = max(graph.num_edges, 1)
    col_bytes = arrays["col_storage"] + arrays["csc_col_storage"]
    total = sum(arrays.values())
    plan = graph.plan
    return {
        "plan": None if plan is None else {
            "index_dtype": plan.index_dtype, "encoding": plan.encoding,
            "value_dtype": plan.value_dtype},
        "arrays": arrays,
        "column_bytes": col_bytes,
        "bytes_per_edge": round(col_bytes / m, 3),
        "total_bytes": total,
        "total_bytes_per_edge": round(total / m, 3),
    }
