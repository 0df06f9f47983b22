"""The ``"cuda"`` providers: wrappers around the hand-written Hopper
kernels (counterpart of ``repro.kernels.ops``).

Each wrapper takes the registry op's arguments, and

  * on CPU tensors runs the kernel's plain version (``kernels.ref``) —
    only because the tensors lie on the CPU;
  * on CUDA tensors checks device, dtype, shape and contiguity, allocates
    every output and scratch buffer, launches the kernel on PyTorch's
    current stream, raises if the launch returned a CUDA error, and adds
    one to the kernel's launch counter. It never falls back.

``KERNELS`` lists the ten kernels with their sources, the TPU kernels
they replace and their launch counters (``chip_smoke.py`` reads and
resets them), in total and by variant: the column storage a graph kernel
read (``int32``, ``int16``, ``int64``, ``delta``, or ``dense_fallback``
for a delta store with escapes, which runs on its decoded int32 view as
in the reference's ``_split_store``) and the precision of K4 / K4m
(``fp32``, ``bf16``).

Storage plans: K1, K3, K4 and K4m are registered with
``encodings=("dense", "delta")``. K1 and K3 decode an escape-free delta
stream in the kernel (``anchor[src] + delta[eid]``) and read dense
columns at their index dtype; K4, K4m and K5 take dense columns (K5 at
any index dtype, K4 / K4m int32): the wrapper decodes or widens a store
once per graph and keeps the view in the graph's ``cache``, which the
operator layer passes (``cache=``); without a cache it decodes per
call. bfloat16 edge values are widened to float32 once per graph the
same way. The ``"mxm"`` provider is no kernel of its own: it runs
K3 (the expansion) and K5 (the probe) through their wrappers.

Threads per block: the graph kernels K1–K6 (all but ``spmm``) take
theirs from ``tuner.tile_for(op, cap)`` at each launch (256 with no
cache, K4's 128), or from an explicit ``threads=`` (the tuner's probes and the
tile-invariance checks). The kernel API's ``lb_expand``,
``flash_attention`` and ``moe_gather`` are the reference's
``repro.kernels.ops`` functions of the same names; no registry op
dispatches to them, as in the reference. The tuner's five probes are
registered at the end of this module.
"""
from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass, field
from typing import Optional

import torch
from torch.utils.weak import WeakIdKeyDictionary

from ..core import backend as B
from ..core import storage as S
from ..linalg.ops import make_mxm_impl
from . import ref, runtime, tuner
from .ref import KExpansion

INT32_MAX = 2 ** 31 - 1
_BLOCK_SIZES = frozenset(tuner.candidates(tuner.MAX_THREADS))   # 64 ... 1024


@dataclass
class Kernel:
    """One hand-written kernel: where it lives, what it replaces, and how
    many times its wrapper launched it."""

    name: str
    source: str
    replaces: str
    launches: int = 0
    # launches by variant (column storage, or K4's precision)
    variants: dict = field(default_factory=dict)

    def count(self, variant: str) -> None:
        self.launches += 1
        self.variants[variant] = self.variants.get(variant, 0) + 1


KERNELS = {k.name: k for k in (
    Kernel("advance_filter_batch",
           "src/repro_torch/kernels/csrc/advance.cu",
           "src/repro/kernels/advance_filter_fused.py:196"),
    Kernel("compact", "src/repro_torch/kernels/csrc/compact.cu",
           "src/repro/kernels/filter_compact.py:42"),
    Kernel("advance_batch", "src/repro_torch/kernels/csrc/advance.cu",
           "src/repro/kernels/advance_fused.py:210"),
    Kernel("spmv", "src/repro_torch/kernels/csrc/spmv.cu",
           "src/repro/kernels/semiring_spmv.py:56"),
    Kernel("spmm", "src/repro_torch/kernels/csrc/spmv.cu",
           "src/repro/kernels/semiring_spmv.py:56"),
    Kernel("segment_search", "src/repro_torch/kernels/csrc/search.cu",
           "src/repro/kernels/segment_search.py:52"),
    Kernel("lb_expand", "src/repro_torch/kernels/csrc/lb_expand.cu",
           "src/repro/kernels/lb_expand.py:53"),
    Kernel("flash_attention", "src/repro_torch/kernels/csrc/attention.cu",
           "src/repro/kernels/flash_attention.py:74"),
    Kernel("attention_combine", "src/repro_torch/kernels/csrc/attention.cu",
           "src/repro/kernels/flash_attention.py:74"),
    Kernel("moe_gather", "src/repro_torch/kernels/csrc/moe_gather.cu",
           "src/repro/kernels/moe_dispatch.py:38"),
)}


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0
        k.variants = {}


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# every tuned launcher takes its threads per block just before the stream
_SIGNATURES = {
    ("advance", "advance_batch"): (
        [_P] * 5 + [_I] * 6 + [_P] * 6 + [_I, _P]),
    ("advance", "advance_filter_batch"): (
        [_P] * 5 + [_I] + [_P] + [_I] * 7 + [_P] * 9 + [_I, _P]),
    ("compact", "compact_batch"): (
        [_P, _L, _P, _I, _I] + [_P] * 4 + [_I, _P]),
    ("spmv", "spmv"): ([_I] + [_P] * 4 + [_I, _P, _I, _I, _P, _I, _I, _P,
                                          _I, _P]),
    ("spmv", "spmm"): ([_I] + [_P] * 4 + [_I, _I, _P, _I, _P, _I, _I, _I,
                                          _P, _P]),
    ("search", "segment_search_found"): (
        [_P, _I, _I] + [_P] * 3 + [_L, _P, _I, _P]),
    ("search", "segment_search_locate"): (
        [_P, _I, _I] + [_P] * 3 + [_L, _P, _I, _P]),
    ("lb_expand", "lb_expand"): [_P, _I, _I, _I, _P, _P, _P, _I, _P],
    ("attention", "flash_attention"): (
        [_I] + [_P] * 6 + [_I, _I, _I, ctypes.c_float, _I, _I, _P]),
    ("attention", "attention_combine"): [_I] + [_P] * 3 + [_I] * 3 + [_P],
    ("moe_gather", "moe_gather"): [_P, _I, _L, _I, _P, _L, _P, _P, _P],
}
_fns: dict = {}


def _fn(lib_name: str, fn_name: str):
    fn = _fns.get((lib_name, fn_name))
    if fn is None:
        lib = runtime.library(lib_name)
        fn = getattr(lib, fn_name)
        fn.argtypes = _SIGNATURES[(lib_name, fn_name)]
        fn.restype = ctypes.c_int
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        _fns[(lib_name, fn_name)] = fn
    return fn


def _launch(lib_name: str, fn_name: str, *args) -> None:
    code = _fn(lib_name, fn_name)(*args)
    if code != 0:
        msg = runtime.library(lib_name).kernel_error_string(code).decode()
        raise RuntimeError(f"{fn_name} launch failed: CUDA error {code} "
                           f"({msg})")


def _require(t: torch.Tensor, name: str, dtype: torch.dtype, dim: int,
             device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} lies on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != dim:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{dim} dimensions")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _threads(op: str, cap: int, dev: torch.device,
             threads: Optional[int], encoding: str = "dense") -> int:
    """Threads per block of one launch: ``threads`` when given (a power
    of two in [64, 1024]), else the tuner's pick for (op, cap,
    encoding)."""
    t = (tuner.tile_for(op, cap, encoding=encoding, device=dev)
         if threads is None else threads)
    if t not in _BLOCK_SIZES:
        raise ValueError(f"threads per block must be a power of two in "
                         f"[64, 1024], not {t}")
    return t


def _offsets(sizes: torch.Tensor) -> torch.Tensor:
    """(B, cap_in+1) exclusive degree scans with the total last. One
    int64 scan of the flattened rows, minus each row's starting sum:
    PyTorch's scan along the last axis of a few long rows is far slower
    on the card than one long scan."""
    b, cap_in = sizes.shape
    flat = torch.cumsum(sizes.reshape(-1), dim=0, dtype=torch.int64)
    flat = flat.view(b, cap_in)
    start = torch.cat([flat.new_zeros(1), flat[:-1, -1]]) if cap_in else (
        flat.new_zeros(b))
    zero = torch.zeros((b, 1), dtype=torch.int32, device=sizes.device)
    return torch.cat([zero, (flat - start[:, None]).to(torch.int32)],
                     dim=1).contiguous()


def _iters(cap_in: int) -> int:
    """Search steps of the reference's LB body."""
    return max(math.ceil(math.log2(max(cap_in, 2))) + 1, 1)


# the kernels' column kinds (csrc/advance.cu, csrc/search.cu)
_COL_KINDS = {torch.int32: (0, "int32"), torch.int16: (1, "int16"),
              torch.int64: (2, "int64")}
_DELTA_KIND = 3


@dataclass
class _Cols:
    """A column store as K1 / K3 read it: the column or delta tensor,
    the anchors (delta only), the kind code and its variant name."""

    cols: torch.Tensor
    anchor: Optional[torch.Tensor]
    kind: int
    variant: str
    m: int

    @property
    def encoding(self) -> str:
        """The tuner's encoding key of the launch."""
        return "delta" if self.kind == _DELTA_KIND else "dense"


def _dense_cols(t: torch.Tensor, name: str, dev) -> tuple[int, str]:
    """(kind, variant) of a dense column tensor, after the checks."""
    if t.device != dev:
        raise ValueError(f"{name} lies on {t.device}, expected {dev}")
    if t.dtype not in _COL_KINDS or t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 1-D int16, int32 or "
                         f"int64 tensor, not {t.dtype} {tuple(t.shape)}")
    if t.shape[0] > INT32_MAX:
        raise ValueError("more edges than int32 offsets address")
    return _COL_KINDS[t.dtype]


def _kernel_cols(row_offsets, store, cache: Optional[dict], dev) -> _Cols:
    """K1's and K3's column operand (the reference's ``_split_store``):
    a dense array at its index dtype; an escape-free delta stream as
    (uint16 deltas, int32 anchors); a delta stream with escapes as its
    decoded int32 view, kept in ``cache``."""
    _require(row_offsets, "row_offsets", torch.int32, 1, dev)
    if isinstance(store, S.EncodedCols):
        if store.num_escapes == 0:
            _require(store.anchor, "anchor", torch.int32, 1, dev)
            _require(store.delta, "delta", torch.uint16, 1, dev)
            if store.anchor.shape[0] != row_offsets.shape[0] - 1:
                raise ValueError("anchor must hold one entry per row")
            return _Cols(store.delta, store.anchor, _DELTA_KIND, "delta",
                         store.num_edges)
        dense = S.dense_view(store, cache)
        _dense_cols(dense, "col_indices", dev)
        return _Cols(dense, None, 0, "dense_fallback", int(dense.shape[0]))
    kind, variant = _dense_cols(store, "col_indices", dev)
    return _Cols(store, None, kind, variant, int(store.shape[0]))


@B.register("advance_batch", B.CUDA, encodings=("dense", "delta"))
def advance_batch(row_offsets, col_indices, base, sizes, cap_out: int,
                  cache: Optional[dict] = None, *,
                  threads: Optional[int] = None):
    """K3: batched LB advance → (src, dst, edge_id, in_pos, rank, valid,
    totals), (B, cap_out) each and totals (B,). ``col_indices`` is a
    column store of any plan (see ``_kernel_cols``)."""
    if row_offsets.device.type == "cpu":
        return ref.advance_batch(row_offsets, col_indices, base, sizes,
                                 cap_out)
    dev = row_offsets.device
    cols = _kernel_cols(row_offsets, col_indices, cache, dev)
    _require(base, "base", torch.int32, 2, dev)
    _require(sizes, "sizes", torch.int32, 2, dev)
    if base.shape != sizes.shape:
        raise ValueError("base and sizes must have one shape (B, cap_in)")
    b, cap_in = base.shape
    if cap_out > INT32_MAX:
        raise ValueError("cap_out beyond int32")
    nthr = _threads("advance", cap_out, dev, threads, cols.encoding)
    offsets = _offsets(sizes)
    out = [torch.empty((b, cap_out), dtype=torch.int32, device=dev)
           for _ in range(5)]
    valid = torch.empty((b, cap_out), dtype=torch.bool, device=dev)
    _launch("advance", "advance_batch", runtime.ptr(offsets),
            runtime.ptr(base), runtime.ptr(row_offsets),
            runtime.ptr(cols.cols), runtime.ptr(cols.anchor), cols.kind, b,
            cap_in, cap_out, cols.m, _iters(cap_in),
            *(runtime.ptr(t) for t in out), runtime.ptr(valid), nthr,
            runtime.stream_ptr(dev))
    KERNELS["advance_batch"].count(cols.variant)
    totals = offsets[:, cap_in].clone()
    return (*out, valid, totals)


@B.register("advance", B.CUDA, encodings=("dense", "delta"))
def advance(row_offsets, col_indices, base, sizes, cap_out: int,
            cache: Optional[dict] = None, *, threads: Optional[int] = None):
    """Single-lane "advance": a B=1 launch of K3."""
    out = advance_batch(row_offsets, col_indices, base[None], sizes[None],
                        cap_out, cache, threads=threads)
    return tuple(t[0] for t in out)


def _first_table(cache: Optional[dict], b: int, n: int,
                 dev: torch.device) -> torch.Tensor:
    """The (B, n) first-slot table of K1, INT32_MAX everywhere between
    calls (each call resets what it touched). Kept in the graph's cache
    so it is filled once per graph and batch size."""
    key = ("advance_filter_first", b, n, str(dev))
    table = None if cache is None else cache.get(key)
    if table is None:
        table = torch.full((b, n), INT32_MAX, dtype=torch.int32, device=dev)
        if cache is not None:
            cache[key] = table
    return table


@B.register("advance_filter_batch", B.CUDA, encodings=("dense", "delta"))
def advance_filter_batch(row_offsets, col_indices, base, sizes,
                         visited: torch.Tensor, cap_out: int,
                         cap_front: int, cache: Optional[dict] = None, *,
                         threads: Optional[int] = None):
    """K1: fused advance → visited test → exact first-occurrence culling
    → compaction. Returns (ids, srcs, lengths, totals). ``col_indices``
    is a column store of any plan (see ``_kernel_cols``)."""
    if row_offsets.device.type == "cpu":
        return ref.advance_filter_batch(row_offsets, col_indices, base,
                                        sizes, visited, cap_out, cap_front)
    dev = row_offsets.device
    cols = _kernel_cols(row_offsets, col_indices, cache, dev)
    _require(base, "base", torch.int32, 2, dev)
    _require(sizes, "sizes", torch.int32, 2, dev)
    _require(visited, "visited", torch.bool, 2, dev)
    if base.shape != sizes.shape or visited.shape[0] != base.shape[0]:
        raise ValueError("base, sizes and visited must share the batch")
    if cap_out > INT32_MAX or cap_front < 1:
        raise ValueError("bad cap_out / cap_front")
    b, cap_in = base.shape
    n = int(visited.shape[1])
    nthr = _threads("advance_filter", cap_out, dev, threads, cols.encoding)
    offsets = _offsets(sizes)
    first = _first_table(cache, b, n, dev)
    nblk = -(-cap_out // nthr)

    def empty(*shape):
        return torch.empty(shape, dtype=torch.int32, device=dev)

    kdst, ksrc = empty(b, cap_out), empty(b, cap_out)
    bcount, boff = empty(b, nblk), empty(b, nblk)
    ids, srcs = empty(b, cap_front), empty(b, cap_front)
    lengths, totals = empty(b), empty(b)
    _launch("advance", "advance_filter_batch", runtime.ptr(offsets),
            runtime.ptr(base), runtime.ptr(row_offsets),
            runtime.ptr(cols.cols), runtime.ptr(cols.anchor), cols.kind,
            runtime.ptr(visited), b, n, cap_in, cap_out, cols.m,
            _iters(cap_in), cap_front, runtime.ptr(first), runtime.ptr(kdst),
            runtime.ptr(ksrc), runtime.ptr(bcount), runtime.ptr(boff),
            runtime.ptr(ids), runtime.ptr(srcs), runtime.ptr(lengths),
            runtime.ptr(totals), nthr, runtime.stream_ptr(dev))
    KERNELS["advance_filter_batch"].count(cols.variant)
    return ids, srcs, lengths, totals


@B.register("advance_filter", B.CUDA, encodings=("dense", "delta"))
def advance_filter(row_offsets, col_indices, base, sizes, visited,
                   cap_out: int, cap_front: int, cache=None, *,
                   threads: Optional[int] = None):
    """Single-lane "advance_filter": a B=1 launch of K1."""
    out = advance_filter_batch(row_offsets, col_indices, base[None],
                               sizes[None], visited[None], cap_out,
                               cap_front, cache, threads=threads)
    return tuple(t[0] for t in out)


@B.register("compact", B.CUDA)
def compact(values: torch.Tensor, mask: torch.Tensor, *,
            threads: Optional[int] = None):
    """K2: stable per-row compaction → (packed (B, cap), totals (B,)).
    ``values`` is (B, cap) or one (1, cap) row shared by every lane."""
    if mask.device.type == "cpu":
        return ref.compact(values, mask)
    dev = mask.device
    _require(mask, "mask", torch.bool, 2, dev)
    b, cap = mask.shape
    if values.device != dev or values.dtype != torch.int32:
        raise ValueError("values must be int32 on the mask's device")
    if values.dim() != 2 or values.shape[1] != cap or values.stride(1) != 1:
        raise ValueError("values must be (B, cap) or (1, cap) with "
                         "contiguous rows")
    if values.shape[0] == 1:
        vstride = 0
    elif values.shape[0] == b:
        vstride = values.stride(0)
    else:
        raise ValueError("values must have B rows or one row")
    nthr = _threads("compact", cap, dev, threads)
    nblk = -(-cap // nthr)
    bcount = torch.empty((b, nblk), dtype=torch.int32, device=dev)
    boff = torch.empty_like(bcount)
    packed = torch.empty((b, cap), dtype=torch.int32, device=dev)
    totals = torch.empty((b,), dtype=torch.int32, device=dev)
    _launch("compact", "compact_batch", runtime.ptr(values), vstride,
            runtime.ptr(mask), b, cap, runtime.ptr(bcount),
            runtime.ptr(boff), runtime.ptr(packed), runtime.ptr(totals),
            nthr, runtime.stream_ptr(dev))
    KERNELS["compact"].count("int32")
    return packed, totals


# K4 gives each row whose overflow passes this many edges a block of its
# own (csrc/spmv.cu)
SPMV_BLOCK_OVER = 2048
# K4m folds the rows of more than SPMM_LONG edges first, from the list by
# degree, and splits those of more than SPMM_SPLIT edges over a block of
# SPMM_THREADS threads (csrc/spmv.cu)
SPMM_LONG = 64
SPMM_SPLIT = 256
SPMM_THREADS = 256
# offsets tensor -> {(above, split, the offsets' version): (rows of degree
# > above by degree, largest first; how many of them have degree >
# split)}, made once per graph and dropped with its offsets
_heavy_lists = WeakIdKeyDictionary()


def heavy_rows(offsets: torch.Tensor, above: int, split: int):
    """A CSR's long-row schedule: the rows of degree > ``above`` as
    int32, sorted by degree, largest first (ties in row order), and how
    many of them (the leading ones) have degree > ``split``. Made on the
    offsets' device at the first call for (offsets, above, split) and
    kept while the offsets tensor lives, keyed on its version counter
    too: an in-place edit of the offsets gets a fresh schedule."""
    per = _heavy_lists.get(offsets)
    if per is None:
        per = _heavy_lists[offsets] = {}
    key = (above, split, offsets._version)
    hit = per.get(key)
    if hit is None:
        deg = offsets[1:] - offsets[:-1]
        rows = torch.nonzero(deg > above).squeeze(1)
        rows = rows[torch.sort(deg[rows], descending=True,
                               stable=True).indices]
        nsplit = int((deg[rows] > split).sum())
        hit = per[key] = (rows.to(torch.int32).contiguous(), nsplit)
    return hit


def spmv_heavy_rows(offsets: torch.Tensor, width: int):
    """K4's schedule: the rows of degree > ``width`` by degree, largest
    first, and how many of them lead with an overflow of more than
    ``SPMV_BLOCK_OVER`` edges (``heavy_rows``)."""
    return heavy_rows(offsets, width, width + SPMV_BLOCK_OVER)


def spmm_shares(k: int) -> int:
    """The shares K4m cuts a split row into at k columns: its groups a
    block, SPMM_THREADS / L with L = pow2(ceil(min(k, 32) / 4)) lanes a
    group (csrc/spmv.cu)."""
    lanes = 1
    while lanes * 4 < min(k, 32):
        lanes *= 2
    return SPMM_THREADS // lanes


def _cached(cache: Optional[dict], name: str, src: torch.Tensor, make):
    """``make(src)``, kept in ``cache`` under (name, id(src)) while src
    lives unedited: the entry holds src, so no other tensor takes its id,
    and src's version."""
    if cache is None:
        return make(src)
    hit = cache.get((name, id(src)))
    if hit is None or hit[0] is not src or hit[1] != src._version:
        hit = cache[(name, id(src))] = (src, src._version, make(src))
    return hit[2]


def _spmv_operands(indices, values, cache: Optional[dict], dev,
                   bf16: bool = False):
    """K4's and K4m's int32 columns and float32 values: a delta or narrow
    store decoded, bfloat16 values widened — and with ``bf16`` (K4m's bf16
    codes) float32 values rounded to bfloat16 first — once per graph when
    a ``cache`` is given."""
    cols = S.dense_view(indices, cache)
    _require(cols, "indices", torch.int32, 1, dev)
    if values is not None and (bf16 or values.dtype == torch.bfloat16):
        # bfloat16 values widen to the same floats
        values = _cached(cache, "values_bf16", values,
                         lambda v: v.to(torch.bfloat16).to(torch.float32))
    if values is not None:
        _require(values, "values", torch.float32, 1, dev)
        if values.shape != cols.shape:
            raise ValueError("values and indices differ in length")
    return cols, values


@B.register("spmv", B.CUDA, encodings=("dense", "delta"))
def spmv(offsets, indices, values, x, sr, ell_width, mask, row_seg=None,
         over_pos=None, over_row=None, cache: Optional[dict] = None, *,
         threads: Optional[int] = None):
    """K4: masked-semiring SpMV over the CSR with the reference's fixed
    fold, at the semiring's precision; the heavy rows first, ordered by
    ``spmv_heavy_rows`` (the overflow lists are implied by the CSR)."""
    if offsets.device.type == "cpu":
        return ref.spmv(offsets, indices, values, x, sr, ell_width, mask,
                        row_seg, over_pos, over_row)
    dev = offsets.device
    _require(offsets, "offsets", torch.int32, 1, dev)
    cols, values = _spmv_operands(indices, values, cache, dev)
    _require(x, "x", torch.float32, 1, dev)
    n = int(offsets.shape[0]) - 1
    if mask is not None:
        _require(mask, "mask", torch.bool, 1, dev)
        if mask.shape[0] != n:
            raise ValueError("mask must be (n,)")
    if ell_width is None:
        raise ValueError("spmv needs the graph's build-time ELL width")
    width = max(int(ell_width), 1)
    if width > 1024:
        raise ValueError("ELL width above 1024")
    if int(cols.shape[0]) and int(x.shape[0]) == 0:
        raise ValueError("x is empty")
    nthr = _threads("spmv", n, dev, threads)
    heavy, nvery = spmv_heavy_rows(offsets, width)
    y = torch.empty((n,), dtype=torch.float32, device=dev)
    _launch("spmv", "spmv", sr.code, runtime.ptr(offsets),
            runtime.ptr(cols), runtime.ptr(values), runtime.ptr(x),
            int(x.shape[0]), runtime.ptr(mask), n, width, runtime.ptr(heavy),
            int(heavy.shape[0]), nvery, runtime.ptr(y), nthr,
            runtime.stream_ptr(dev))
    KERNELS["spmv"].count(sr.precision)
    return y


@B.register("spmm", B.CUDA, encodings=("dense", "delta"))
def spmm(offsets, indices, values, x, sr, ell_width, mask, row_seg=None,
         cache: Optional[dict] = None):
    """K4m: masked-semiring SpMM over the CSR and a dense (nx, k) block,
    a group of lanes per (row, 32-column chunk), each column folded in
    ascending edge order, the rows of more than ``SPMM_SPLIT`` edges
    split over a block (their shares merged in order), the long rows
    first (``heavy_rows``), at the semiring's precision (``ell_width``
    and ``row_seg`` are unused: the CSR gives both)."""
    if offsets.device.type == "cpu":
        return ref.spmm(offsets, indices, values, x, sr, ell_width, mask,
                        row_seg)
    dev = offsets.device
    _require(offsets, "offsets", torch.int32, 1, dev)
    bf16 = sr.precision == "bf16"
    cols, values = _spmv_operands(indices, values, cache, dev, bf16)
    _require(x, "x", torch.float32, 2, dev)
    n = int(offsets.shape[0]) - 1
    nx, k = (int(d) for d in x.shape)
    if mask is not None:
        _require(mask, "mask", torch.bool, 1, dev)
        if mask.shape[0] != n:
            raise ValueError("mask must be (n,)")
    if max(n, nx) * k > INT32_MAX:
        raise ValueError(f"spmm indexes rows * k = {max(n, nx) * k:,} "
                         f"entries, beyond int32")
    if int(cols.shape[0]) and nx == 0:
        raise ValueError("x is empty")
    long_rows, nsplit = heavy_rows(offsets, SPMM_LONG, SPMM_SPLIT)
    y = torch.empty((n, k), dtype=torch.float32, device=dev)
    _launch("spmv", "spmm", sr.code, runtime.ptr(offsets),
            runtime.ptr(cols), runtime.ptr(values), runtime.ptr(x), nx,
            k, runtime.ptr(mask), n, runtime.ptr(long_rows),
            int(long_rows.shape[0]), nsplit, SPMM_LONG, runtime.ptr(y),
            runtime.stream_ptr(dev))
    KERNELS["spmm"].count(sr.precision)
    return y


def _search(haystack, lo, hi, needles, locate: bool,
            threads: Optional[int]) -> torch.Tensor:
    """K5 on CUDA tensors: one launch in ``found`` (bool) or ``locate``
    (int32 position, -1 where absent) mode, over a dense haystack of
    int16, int32 or int64 (a graph's columns at its index dtype)."""
    dev = haystack.device
    kind, variant = _dense_cols(haystack, "haystack", dev)
    for t, name in ((lo, "lo"), (hi, "hi"), (needles, "needles")):
        _require(t, name, torch.int32, 1, dev)
    cap = int(needles.shape[0])
    if lo.shape[0] != cap or hi.shape[0] != cap:
        raise ValueError("lo, hi and needles must have one length")
    nthr = _threads("segment_search", cap, dev, threads)
    if locate:
        out = torch.empty((cap,), dtype=torch.int32, device=dev)
        fn = "segment_search_locate"
    else:
        out = torch.empty((cap,), dtype=torch.bool, device=dev)
        fn = "segment_search_found"
    _launch("search", fn, runtime.ptr(haystack), kind,
            int(haystack.shape[0]), runtime.ptr(lo), runtime.ptr(hi),
            runtime.ptr(needles), cap, runtime.ptr(out), nthr,
            runtime.stream_ptr(dev))
    KERNELS["segment_search"].count(variant)
    return out


@B.register("segment_search", B.CUDA)
def segment_search(haystack, lo, hi, needles, *,
                   threads: Optional[int] = None) -> torch.Tensor:
    """K5, found mode: needles[i] in sorted haystack[lo[i]:hi[i]) → bool."""
    if haystack.device.type == "cpu":
        return ref.segment_search(haystack, lo, hi, needles)
    return _search(haystack, lo, hi, needles, False, threads)


def segment_locate(haystack, lo, hi, needles, *,
                   threads: Optional[int] = None) -> torch.Tensor:
    """K5, locate mode: the position of needles[i] in haystack[lo[i]:hi[i])
    → int32, -1 where absent (the probe of the SpGEMM)."""
    if haystack.device.type == "cpu":
        return ref.segment_locate(haystack, lo, hi, needles)
    return _search(haystack, lo, hi, needles, True, threads)


# masked SpGEMM: K3 expands (a B = 1 launch), K5 locates
B.register("mxm", B.CUDA)(make_mxm_impl(advance, segment_locate))


# ---------------------------------------------------------------------------
# The kernel API: the reference's repro.kernels.ops.lb_expand,
# flash_attention and moe_gather
# ---------------------------------------------------------------------------


def lb_offsets(sizes: torch.Tensor) -> torch.Tensor:
    """(cap_in+1,) int32 exclusive scan of ``sizes`` with the total last
    (the reference wrapper's int32 cumsum)."""
    return torch.cat([sizes.new_zeros(1, dtype=torch.int32),
                      torch.cumsum(sizes, 0, dtype=torch.int32)])


def lb_expand(sizes: torch.Tensor, cap_out: int, *,
              threads: Optional[int] = None) -> KExpansion:
    """K6: load-balanced expansion geometry of segments of ``sizes``
    (cap_in,) int32 over ``cap_out`` output slots → KExpansion(in_pos,
    rank, valid, total): each slot's segment, its rank there, whether it
    lies below the total (bool), and the total (0-d int32). Every slot,
    the invalid ones too, equals the plain version's."""
    if sizes.dim() != 1:
        raise ValueError("sizes must be (cap_in,)")
    offsets = lb_offsets(sizes)
    if sizes.device.type == "cpu":
        return KExpansion(*ref.lb_expand(offsets, cap_out),
                          total=offsets[-1])
    dev = sizes.device
    _require(sizes, "sizes", torch.int32, 1, dev)
    if not 0 <= cap_out <= INT32_MAX:
        raise ValueError(f"cap_out {cap_out:,} is outside int32")
    cap_in = int(sizes.shape[0])
    nthr = _threads("lb_expand", cap_out, dev, threads)
    in_pos = torch.empty((cap_out,), dtype=torch.int32, device=dev)
    rank = torch.empty_like(in_pos)
    valid = torch.empty((cap_out,), dtype=torch.bool, device=dev)
    _launch("lb_expand", "lb_expand", runtime.ptr(offsets), cap_in, cap_out,
            _iters(cap_in), runtime.ptr(in_pos), runtime.ptr(rank),
            runtime.ptr(valid), nthr, runtime.stream_ptr(dev))
    KERNELS["lb_expand"].count("int32")
    return KExpansion(in_pos, rank, valid, offsets[-1])


_ATTN_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")
_sm_counts: dict = {}


def attention_splits(sq: int, sk: int, dtype: torch.dtype,
                     sms: int) -> int:
    """K7's kv splits per q tile on a card of ``sms`` SMs: 1 when the q
    tiles of ``ref.ATTN_BQ`` queries fill the card about twice over, else
    enough to, with at least two kv tiles a part where the longest q
    tile's keys allow."""
    nq = -(-sq // ref.ATTN_BQ)
    ntile = -(-sk // ref.attention_kv_tile(dtype))
    if nq == 0 or nq >= 2 * sms:
        return 1
    return max(1, min(-(-2 * sms // nq), ntile // 2))


def sm_count(dev: torch.device) -> int:
    """The card's number of SMs (K7's split count depends on it)."""
    n = _sm_counts.get(dev.index)
    if n is None:
        n = _sm_counts[dev.index] = (
            torch.cuda.get_device_properties(dev).multi_processor_count)
    return n


def _attention_inputs(q, k, v):
    """Check q (Sq, D), k and v (Sk, D) for K7; returns (dtype code, sq,
    sk, d, q, k, v), each tensor 16-byte aligned for the kernel's
    copies."""
    dev = q.device
    dtype = q.dtype
    if dtype not in _ATTN_DTYPES:
        raise ValueError(f"q has dtype {dtype}; expected float32, "
                         f"bfloat16 or float16")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _require(t, name, dtype, 2, dev)
    sq, d = (int(x) for x in q.shape)
    sk = int(k.shape[0])
    if k.shape[1] != d or tuple(v.shape) != (sk, d):
        raise ValueError("k and v must be (Sk, D) with q's D")
    if d < 8 or d > 256 or d % 8:
        raise ValueError(f"head width {d}: the kernel takes a multiple of "
                         f"8 up to 256")
    if max(sq, sk) * d > INT32_MAX:
        raise ValueError("sequence x head width beyond int32")
    q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone()
               for t in (q, k, v))
    return _ATTN_DTYPES[dtype], sq, sk, d, q, k, v


def attention_partials(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool, nsplit: int):
    """K7 in its split form: each q tile's kv tiles cut into ``nsplit``
    parts (``ref.attention_partials`` says how) → (acc (nsplit, Sq, D),
    ml (nsplit, Sq, 2)) in fp32, a part's unnormalised sum and its (m,
    l); a part that sees no key has m = -1e30 and l = acc = 0."""
    if q.device.type == "cpu":
        return ref.attention_partials(q, k, v, causal, nsplit)
    if nsplit < 2:
        raise ValueError("the split form takes nsplit >= 2")
    code, sq, sk, d, q, k, v = _attention_inputs(q, k, v)
    if nsplit * sq * d > INT32_MAX:
        raise ValueError("nsplit x Sq x D beyond int32")
    dev = q.device
    acc = torch.empty((nsplit, sq, d), dtype=torch.float32, device=dev)
    ml = torch.empty((nsplit, sq, 2), dtype=torch.float32, device=dev)
    _launch("attention", "flash_attention", code, runtime.ptr(q),
            runtime.ptr(k), runtime.ptr(v), runtime.ptr(None),
            runtime.ptr(acc), runtime.ptr(ml), sq, sk, d,
            ctypes.c_float(1.0 / math.sqrt(d)), int(bool(causal)), nsplit,
            runtime.stream_ptr(dev))
    KERNELS["flash_attention"].count(_dtype_name(q.dtype))
    return acc, ml


def attention_combine(acc: torch.Tensor, ml: torch.Tensor,
                      dtype: torch.dtype) -> torch.Tensor:
    """K7's combine: o (Sq, D) in ``dtype`` from the parts of
    ``attention_partials``: o = sum_s w_s acc_s / max(sum_s w_s l_s,
    1e-30), w_s = exp(m_s - max m)."""
    if acc.device.type == "cpu":
        return ref.attention_combine(acc, ml, dtype)
    dev = acc.device
    _require(acc, "acc", torch.float32, 3, dev)
    _require(ml, "ml", torch.float32, 3, dev)
    nsplit, sq, d = (int(x) for x in acc.shape)
    if tuple(ml.shape) != (nsplit, sq, 2):
        raise ValueError("ml must be (nsplit, Sq, 2) beside acc")
    if dtype not in _ATTN_DTYPES or d < 8 or d % 2:
        raise ValueError("bad dtype or head width")
    out = torch.empty((sq, d), dtype=dtype, device=dev)
    _launch("attention", "attention_combine", _ATTN_DTYPES[dtype],
            runtime.ptr(acc), runtime.ptr(ml), runtime.ptr(out), sq, d,
            nsplit, runtime.stream_ptr(dev))
    KERNELS["attention_combine"].count(_dtype_name(dtype))
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, bq: int = 128,
                    bk: int = 128) -> torch.Tensor:
    """K7: single-head attention, q (Sq, D), k and v (Sk, D) of one type
    (fp32, bf16 or fp16) → (Sq, D) in q's type; the causal mask is
    aligned to the ends (query i sees keys j <= i + Sk - Sq) and a row
    that sees no key is 0. Scores, softmax statistics and the sum are
    fp32. ``bq`` and ``bk`` are the Pallas kernel's tiles, kept for the
    reference's signature: the card's kernel picks its own (64 queries,
    64 keys in bf16 / fp16 and 32 in fp32), which changes only the order
    of the float sums. When the q tiles cannot fill the card, each one's
    keys are split over ``attention_splits`` blocks and the combine
    kernel merges them. On the card D is a multiple of 8 up to 256."""
    del bq, bk
    if q.device.type == "cpu":
        return ref.flash_attention(q, k, v, causal)
    code, sq, sk, d, q, k, v = _attention_inputs(q, k, v)
    dev = q.device
    nsplit = attention_splits(sq, sk, q.dtype, sm_count(dev))
    if nsplit > 1:
        acc, ml = attention_partials(q, k, v, causal, nsplit)
        return attention_combine(acc, ml, q.dtype)
    out = torch.empty((sq, d), dtype=q.dtype, device=dev)
    _launch("attention", "flash_attention", code, runtime.ptr(q),
            runtime.ptr(k), runtime.ptr(v), runtime.ptr(out),
            runtime.ptr(None), runtime.ptr(None), sq, sk, d,
            ctypes.c_float(1.0 / math.sqrt(d)), int(bool(causal)), 1,
            runtime.stream_ptr(dev))
    KERNELS["flash_attention"].count(_dtype_name(q.dtype))
    return out


def moe_gather(x: torch.Tensor, slot_token: torch.Tensor) -> torch.Tensor:
    """K8: out[s] = x[slot_token[s]] for x (T, D) and slot_token (S,)
    int32, a zero row where slot_token[s] < 0; an id past the last token
    reads the last row (JAX clamps gather indices, and the reference's
    gather relies on it; no host check). Output (S, D) in x's type. The
    kernel orders the slots by token first (a counting sort on the card),
    so it copies each token row to all of its slots while the row is on
    chip."""
    if x.device.type == "cpu":
        return ref.moe_gather(x, slot_token)
    dev = x.device
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError("x must be a contiguous (T, D) matrix")
    if x.dtype not in _ATTN_DTYPES:
        raise ValueError(f"x has dtype {x.dtype}; expected float32, "
                         f"bfloat16 or float16")
    _require(slot_token, "slot_token", torch.int32, 1, dev)
    t, d = (int(n) for n in x.shape)
    if t > INT32_MAX:
        raise ValueError("more tokens than int32 ids")
    s = int(slot_token.shape[0])
    if s > INT32_MAX:
        raise ValueError("more slots than int32 positions")
    # the counting sort's bins (counts and starts), its total and the
    # slots in token order
    scratch = torch.empty((2 * (t + 1) + 1 + s,), dtype=torch.int32,
                          device=dev)
    out = torch.empty((s, d), dtype=x.dtype, device=dev)
    _launch("moe_gather", "moe_gather", runtime.ptr(x), t,
            d * x.element_size(), x.element_size(), runtime.ptr(slot_token),
            s, runtime.ptr(scratch), runtime.ptr(out),
            runtime.stream_ptr(dev))
    KERNELS["moe_gather"].count(_dtype_name(x.dtype))
    return out


# ---------------------------------------------------------------------------
# Tuner probes: a representative launch at a forced block size on
# synthetic card tensors (the reference's probes, repro.kernels.ops),
# timed by CUDA events. Without a card a probe raises: timing the plain
# versions would measure nothing the tuner could use.
# ---------------------------------------------------------------------------

_PROBE_REPS = 10
_PROBE_SPIN_CYCLES = 10_000_000
_probe_inputs: dict = {}


def _probe_time(fn) -> float:
    """Device seconds per call of ``fn``, the mean of ``_PROBE_REPS``
    calls. The calls queue behind a spin of about 5 ms on the card, so
    the events time the device's work alone: a small launch takes less
    time on the card than its wrapper takes on the host, and timed back
    to back the probe would measure the host."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(_PROBE_SPIN_CYCLES)
    start.record()
    for _ in range(_PROBE_REPS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / _PROBE_REPS


def _probe_graph(cap: int, encoding: str = "dense") -> dict:
    """A uniform CSR of degree 8 sized to ``cap`` and the frontier of its
    first cap / 8 vertices, made once per capacity on the card; with
    ``encoding="delta"`` its columns as the anchored-delta stream (the
    reference's probe graph, so the in-kernel decode is measured)."""
    dev = runtime.resolve_device(None)
    key = (cap, encoding, str(dev))
    inp = _probe_inputs.get(key)
    if inp is None:
        gen = torch.Generator().manual_seed(0)
        n = max(cap // 8, 16)
        k = min(n, max(cap // 8, 1))
        cols = torch.sort(torch.randint(0, n, (n, 8), generator=gen,
                                        dtype=torch.int32), dim=1).values
        ro = torch.arange(n + 1, dtype=torch.int32) * 8
        ci = cols.reshape(-1)
        if encoding == "delta":
            ci = S.encode_delta(ro.numpy(), ci.numpy(),
                                torch.arange(n).repeat_interleave(8).numpy(),
                                dev)
        inp = {"n": n, "ro": ro.to(dev),
               "ci": ci if encoding == "delta" else ci.to(dev),
               "base": (torch.arange(k, dtype=torch.int32) % n).to(dev),
               "sizes": torch.full((k,), 8, dtype=torch.int32, device=dev),
               "visited": torch.zeros((n,), dtype=torch.bool, device=dev),
               "ids": torch.arange(cap, dtype=torch.int32,
                                   device=dev)[None, :],
               "cache": {}}
        inp["keep"] = inp["ids"] % 3 == 0
        _probe_inputs[key] = inp
    return inp


def _probe_advance(cap: int, tile: int, encoding: str = "dense") -> float:
    p = _probe_graph(cap, encoding)
    return _probe_time(lambda: advance(p["ro"], p["ci"], p["base"],
                                       p["sizes"], cap, threads=tile))


def _probe_advance_filter(cap: int, tile: int,
                          encoding: str = "dense") -> float:
    p = _probe_graph(cap, encoding)
    return _probe_time(lambda: advance_filter(
        p["ro"], p["ci"], p["base"], p["sizes"], p["visited"], cap,
        min(cap, p["n"]), p["cache"], threads=tile))


def _probe_compact(cap: int, tile: int) -> float:
    p = _probe_graph(cap)
    return _probe_time(lambda: compact(p["ids"], p["keep"], threads=tile))


def _probe_lb_expand(cap: int, tile: int) -> float:
    p = _probe_graph(cap)
    return _probe_time(lambda: lb_expand(p["sizes"], cap, threads=tile))


def _probe_spmv(cap: int, tile: int) -> float:
    """The reference's probe: n = max(cap, 16) rows of 8 random
    neighbours, unit values, plus_times."""
    from ..linalg import semiring as SR
    dev = runtime.resolve_device(None)
    key = ("spmv", cap, str(dev))
    inp = _probe_inputs.get(key)
    if inp is None:
        gen = torch.Generator().manual_seed(0)
        n = max(cap, 16)
        inp = ((torch.arange(n + 1, dtype=torch.int32) * 8).to(dev),
               torch.randint(0, n, (n * 8,), generator=gen,
                             dtype=torch.int32).to(dev),
               torch.ones((n * 8,), dtype=torch.float32, device=dev),
               torch.ones((n,), dtype=torch.float32, device=dev))
        _probe_inputs[key] = inp
    ro, ci, vals, x = inp
    return _probe_time(lambda: spmv(ro, ci, vals, x, SR.plus_times, 8, None,
                                    threads=tile))


tuner.register_probe("advance", _probe_advance)
tuner.register_probe("advance_filter", _probe_advance_filter)
tuner.register_probe("compact", _probe_compact)
tuner.register_probe("lb_expand", _probe_lb_expand)
tuner.register_probe("spmv", _probe_spmv)
