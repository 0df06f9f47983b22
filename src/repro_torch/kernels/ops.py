"""The ``"cuda"`` providers: wrappers around the hand-written Hopper
kernels (counterpart of ``repro.kernels.ops``).

Each wrapper takes the registry op's arguments, and

  * on CPU tensors runs the kernel's plain version (``kernels.ref``) —
    only because the tensors lie on the CPU;
  * on CUDA tensors checks device, dtype, shape and contiguity, allocates
    every output and scratch buffer, launches the kernel on PyTorch's
    current stream through ``_launch``, raises if the launch returned a
    CUDA error, and adds one to the kernel's launch counter. It never
    falls back. (K1, K2, K3 and K6 also use the look-back words kept per
    device, ``_lookback_state``.)

``_launch`` takes the tensors themselves in the C signature's order
(``_SIGNATURES``, named parameters); under ``analysis.sanitize``'s
``REPRO_SANITIZE=1`` / ``sanitizing()`` it first audits the launch
against its site's declaration (``_SITES``: the 11 launch sites' operands,
extents, read-modify-write outputs and index operands) and raises
``MemoryFault`` instead of launching a faulty one.

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
dispatches to them, as in the reference. The reference's other names
(``advance_fused``, ``advance_fused_batch``, ``advance_filter_fused``,
``advance_filter_fused_batch``, ``filter_compact``, ``semiring_spmv``,
``semiring_spmm``, ``oracle``) are thin entries over the registry-named
wrappers, with the reference's contracts. The tuner's five probes are
registered at the end of this module.
"""
from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass, field
from typing import Optional

import torch
from torch.utils.weak import WeakIdKeyDictionary

from ..analysis import sanitize
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


def _sig(spec: str) -> tuple:
    """A C signature as (parameter, C type) pairs from ``"a b:i32* c:int"``:
    each type applies to the names since the last one."""
    out, names = [], []
    for word in spec.split():
        name, _, ctype = word.partition(":")
        names.append(name)
        if ctype:
            out += [(nm, ctype) for nm in names]
            names = []
    return tuple(out)


_LB_SCRATCH = ("counters live_end status:u64* status_cap:i64 epoch:u32")
# every launcher's C signature (csrc/*.cu); every tuned launcher takes its
# threads per block just before the stream
_SIGNATURES = {
    ("advance", "advance_batch"): _sig(
        "sizes base row_offsets:i32* cols:void* anchor:i32* "
        "kind batch cap_in cap_out m:int offsets ebase tile_lane:i32* "
        f"tile_lane_cap:i64 {_LB_SCRATCH} "
        "src dst eid in_pos rank:i32* valid:u8* totals:i32* threads:int "
        "stream:stream"),
    ("advance", "advance_filter_batch"): _sig(
        "sizes base row_offsets:i32* cols:void* anchor:i32* kind:int "
        "visited:u8* batch n cap_in cap_out m cap_front:int "
        "first offsets ebase tile_lane:i32* tile_lane_cap:i64 cand:u32* "
        f"cand_cap:i64 {_LB_SCRATCH} ids srcs lengths totals:i32* "
        "threads:int stream:stream"),
    ("compact", "compact_batch"): _sig(
        "values:i32* vstride:i64 mask:u8* batch cap:int counters status:u64* "
        "status_cap:i64 epoch:u32 packed totals:i32* threads:int "
        "stream:stream"),
    ("spmv", "spmv"): _sig(
        "semiring:int offsets cols:i32* vals x:f32* nx:int mask:u8* "
        "n width:int heavy:i32* nheavy nvery:int y:f32* threads:int "
        "stream:stream"),
    ("spmv", "spmm"): _sig(
        "semiring:int offsets cols:i32* vals x:f32* nx k:int mask:u8* n:int "
        "long_rows:i32* nlong nsplit tlong:int y:f32* stream:stream"),
    ("search", "segment_search_found"): _sig(
        "hay:void* kind m:int lo hi needles:i32* cap:i64 found:u8* "
        "threads:int stream:stream"),
    ("search", "segment_search_locate"): _sig(
        "hay:void* kind m:int lo hi needles:i32* cap:i64 pos:i32* "
        "threads:int stream:stream"),
    ("lb_expand", "lb_expand"): _sig(
        "sizes:i32* cap_in cap_out:int offsets tile_lane:i32* "
        f"tile_lane_cap:i64 {_LB_SCRATCH} in_pos rank:i32* valid:u8* "
        "total:i32* threads:int stream:stream"),
    ("attention", "flash_attention"): _sig(
        "dtype:int q k v o:void* ws_acc ws_ml:f32* sq sk d:int scale:float "
        "causal nsplit:int stream:stream"),
    ("attention", "flash_attention_split"): _sig(
        "dtype:int q k v o:void* ws_acc ws_ml:f32* sq sk d:int scale:float "
        "causal nsplit:int stream:stream"),
    ("attention", "attention_combine"): _sig(
        "dtype:int ws_acc ws_ml:f32* o:void* sq d nsplit:int stream:stream"),
    ("moe_gather", "moe_gather"): _sig(
        "x:void* tokens:int row_bytes:i64 itemsize:int slot_token:i32* "
        "slots:i64 scratch:i32* out:void* stream:stream"),
}
# the kernels each C function launches (chip_smoke.py holds the audits of
# a sanitized run against the launch counters through it)
FUNCTION_KERNELS = {
    "advance_batch": ("advance_batch",),
    "advance_filter_batch": ("advance_filter_batch",),
    "compact_batch": ("compact",),
    "spmv": ("spmv",), "spmm": ("spmm",),
    "segment_search_found": ("segment_search",),
    "segment_search_locate": ("segment_search",),
    "lb_expand": ("lb_expand",),
    "flash_attention": ("flash_attention",),
    "flash_attention_split": ("flash_attention", "attention_combine"),
    "attention_combine": ("attention_combine",),
    "moe_gather": ("moe_gather",),
}
_CTYPES = {"int": ctypes.c_int, "i64": ctypes.c_longlong,
           "u32": ctypes.c_uint, "float": ctypes.c_float}
_fns: dict = {}


def _fn(lib_name: str, fn_name: str):
    fn = _fns.get((lib_name, fn_name))
    if fn is None:
        lib = runtime.library(lib_name)
        fn = getattr(lib, fn_name)
        fn.argtypes = [_CTYPES.get(ctype, ctypes.c_void_p)
                       for _, ctype in _SIGNATURES[(lib_name, fn_name)]]
        fn.restype = ctypes.c_int
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        _fns[(lib_name, fn_name)] = fn
    return fn


def audit(site: str, lib_name: str, fn_name: str, *args) -> None:
    """The launch audit of one call of ``site`` (``analysis.sanitize``):
    ``args`` as ``_launch`` takes them, checked against the C signature
    and the site's declaration (``_SITES``); raises ``MemoryFault``
    without launching. Runs on CPU tensors too (the tests)."""
    sig = _SIGNATURES[(lib_name, fn_name)]
    sanitize.check_signature(fn_name, sig, args)
    decl = _SITES[site](fn_name, {p: v for (p, _), v in zip(sig, args)})
    sanitize.check_launch(fn_name, sig, args, decl, site=site)


def _launch(site: str, lib_name: str, fn_name: str, *args) -> None:
    """Call the C launcher ``fn_name`` of ``csrc/<lib_name>.cu`` with
    ``args`` in its signature's order, tensors for pointers (None for a
    null one); under ``sanitize.enabled()`` the launch is audited first.
    Raises if the launcher returned a CUDA error."""
    if sanitize.enabled():
        audit(site, lib_name, fn_name, *args)
    code = _fn(lib_name, fn_name)(
        *[a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args])
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
            sanitize.note_setup()
    return table


# The offsets scan of K1, K3 and K6, K1's emit and K2 are single-pass
# scans over tiles (csrc/common.cuh): per lane a tile counter, per tile a
# status word, and the live lane ends, every word tagged with the launch's
# epoch. They persist between calls, one set per device (calls on one
# stream), and grow as needed; a fresh set is all zeros, which no epoch
# (>= 1) reads as written. Tile sizes as in csrc/lb_tiles.cuh and
# csrc/compact.cu.
SCAN_TILE = 4096              # sizes a tile of the offsets scan
LB_TILE_SLOTS = 2048          # slots a tile of K1, K3, K6, at most
COMPACT_ITEMS = 16            # mask bytes a thread of K2
_EPOCH_LIMIT = 2 ** 30


def lb_tile(threads: int) -> int:
    """Slots a tile of K1, K3 and K6 takes at ``threads`` threads per
    block (8 a thread)."""
    return min(8 * threads, LB_TILE_SLOTS)


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@dataclass
class _LookBack:
    counters: torch.Tensor      # (lanes,) int64, read as uint64
    live_end: torch.Tensor      # (lanes,)
    status: torch.Tensor        # (tiles,)
    epoch: int = 0              # the last epoch handed out


_lookback: dict = {}


def _lookback_state(dev: torch.device, lanes: int, tiles: int,
                    launches: int) -> tuple[_LookBack, int]:
    """The device's look-back words, with room for ``lanes`` lanes and
    ``tiles`` tiles, and the first of ``launches`` fresh epochs."""
    st = _lookback.get(dev)
    if (st is None or st.counters.numel() < lanes
            or st.status.numel() < tiles
            or st.epoch + launches >= _EPOCH_LIMIT):
        if st is not None:
            lanes = max(lanes, st.counters.numel())
            tiles = max(tiles, st.status.numel())
        st = _LookBack(*(torch.zeros((k,), dtype=torch.int64, device=dev)
                         for k in (lanes, lanes, tiles)))
        _lookback[dev] = st
    epoch = st.epoch + 1
    st.epoch += launches
    return st, epoch


def _lb_scratch(b: int, cap_in: int, cap_out: int, threads: int,
                ebase: bool, dev: torch.device):
    """The scratch of the LB scan (csrc/lb_tiles.cuh) in one int32
    allocation → (offsets (B·(cap_in + 1),), ebase (B·cap_in,); None
    unless ``ebase``, tile_lane (B·(slot_tiles + 1),)): views of it, with
    the look-back words and the call's epoch."""
    slot_tiles = max(_ceil_div(cap_out, lb_tile(threads)), 1)
    lb, epoch = _lookback_state(
        dev, b, b * max(_ceil_div(cap_in, SCAN_TILE), 1), 1)
    n_off, n_eb = b * (cap_in + 1), b * cap_in if ebase else 0
    n_tl = b * (slot_tiles + 1)
    flat = torch.empty((n_off + n_eb + n_tl,), dtype=torch.int32,
                       device=dev)
    views = (flat[:n_off], flat[n_off:n_off + n_eb] if ebase else None,
             flat[n_off + n_eb:])
    return views, lb, epoch


@B.register("advance_batch", B.CUDA, encodings=("dense", "delta"))
def advance_batch(row_offsets, col_indices, base, sizes, cap_out: int,
                  cache: Optional[dict] = None, *,
                  threads: Optional[int] = None):
    """K3: batched LB advance → (src, dst, edge_id, in_pos, rank, valid,
    totals), (B, cap_out) each and totals (B,). ``col_indices`` is a
    column store of any plan (see ``_kernel_cols``). Two kernel launches,
    the offsets scan and the expand pass, and no other device work. Each
    output has an allocation of its own: callers keep some and drop the
    rest (the operator layer drops rank, mxm src and rank)."""
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
    if not 0 <= cap_out <= INT32_MAX:
        raise ValueError(f"cap_out {cap_out:,} is outside int32")
    nthr = _threads("advance", cap_out, dev, threads, cols.encoding)
    # the scratch lives until the launches are enqueued on the stream
    (offsets, ebase, tile_lane), lb, epoch = _lb_scratch(
        b, cap_in, cap_out, nthr, True, dev)
    rows = [torch.empty((b, cap_out), dtype=torch.int32, device=dev)
            for _ in range(5)]
    valid = torch.empty((b, cap_out), dtype=torch.bool, device=dev)
    totals = torch.empty((b,), dtype=torch.int32, device=dev)
    _launch("advance_batch", "advance", "advance_batch", sizes, base,
            row_offsets, cols.cols, cols.anchor, cols.kind, b, cap_in,
            cap_out, cols.m, offsets, ebase, tile_lane, tile_lane.numel(),
            lb.counters, lb.live_end, lb.status, lb.status.numel(), epoch,
            *rows, valid, totals, nthr, runtime.stream_ptr(dev))
    del offsets, ebase, tile_lane
    KERNELS["advance_batch"].count(cols.variant)
    return (*rows, valid, totals)


@B.register("advance", B.CUDA, encodings=("dense", "delta"))
def advance(row_offsets, col_indices, base, sizes, cap_out: int,
            cache: Optional[dict] = None, *, threads: Optional[int] = None):
    """Single-lane "advance": a B=1 launch of K3."""
    out = advance_batch(row_offsets, col_indices, base[None], sizes[None],
                        cap_out, cache, threads=threads)
    return tuple(t[0] for t in out)


@B.register("advance_filter_batch", B.CUDA, encodings=("dense", "delta"))
def advance_filter_batch(row_offsets, col_indices, base, sizes,
                         visited: torch.Tensor, cap_out: int,
                         cap_front: int, cache: Optional[dict] = None, *,
                         threads: Optional[int] = None):
    """K1: fused advance → visited test → exact first-occurrence culling
    → compaction. Returns (ids, srcs, lengths, totals). ``col_indices``
    is a column store of any plan (see ``_kernel_cols``). Three kernel
    launches: the offsets scan, the expand pass and the emit pass."""
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
    first = _first_table(cache, b, n, dev)
    slot_tiles = max(_ceil_div(cap_out, lb_tile(nthr)), 1)
    tiles = max(_ceil_div(cap_in, SCAN_TILE), slot_tiles)
    lb, epoch = _lookback_state(dev, b, b * tiles, 2)

    def empty(*shape):
        return torch.empty(shape, dtype=torch.int32, device=dev)

    offsets, ebase = empty(b, cap_in + 1), empty(b, cap_in)
    tile_lane = empty(b, slot_tiles + 1)
    cand = empty(b, slot_tiles * lb_tile(nthr) // 32)
    ids, srcs = empty(b, cap_front), empty(b, cap_front)
    lengths, totals = empty(b), empty(b)
    _launch("advance_filter_batch", "advance", "advance_filter_batch",
            sizes, base, row_offsets, cols.cols, cols.anchor, cols.kind,
            visited, b, n, cap_in, cap_out, cols.m, cap_front, first,
            offsets, ebase, tile_lane, tile_lane.numel(), cand, cand.numel(),
            lb.counters, lb.live_end, lb.status, lb.status.numel(), epoch,
            ids, srcs, lengths, totals, nthr, runtime.stream_ptr(dev))
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
    ``values`` is (B, cap) or one (1, cap) row shared by every lane. One
    kernel launch."""
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
    tiles = max(_ceil_div(cap, COMPACT_ITEMS * nthr), 1)
    lb, epoch = _lookback_state(dev, b, b * tiles, 1)
    packed = torch.empty((b, cap), dtype=torch.int32, device=dev)
    totals = torch.empty((b,), dtype=torch.int32, device=dev)
    _launch("compact", "compact", "compact_batch", values, vstride, mask, b,
            cap, lb.counters, lb.status, lb.status.numel(), epoch, packed,
            totals, nthr, runtime.stream_ptr(dev))
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
        nsplit = int((deg[rows] > split).sum(dtype=torch.int64))
        hit = per[key] = (rows.to(torch.int32).contiguous(), nsplit)
        sanitize.note_setup()
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
        sanitize.note_setup()
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
    _launch("spmv", "spmv", "spmv", sr.code, offsets, cols, values, x,
            int(x.shape[0]), mask, n, width, heavy, int(heavy.shape[0]),
            nvery, y, nthr, runtime.stream_ptr(dev))
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
    _launch("spmm", "spmv", "spmm", sr.code, offsets, cols, values, x, nx,
            k, mask, n, long_rows, int(long_rows.shape[0]), nsplit,
            SPMM_LONG, y, runtime.stream_ptr(dev))
    KERNELS["spmm"].count(sr.precision)
    return y


SEARCH_LANES = 4              # lanes a thread of K5 (csrc/search.cu)


def _search(haystack, lo, hi, needles, locate: bool,
            threads: Optional[int]) -> torch.Tensor:
    """K5 on CUDA tensors: one launch in ``found`` (bool) or ``locate``
    (int32 position, -1 where absent) mode, over a dense haystack of
    int16, int32 or int64 (a graph's columns at its index dtype): each
    warp takes chunks of 32 · ``SEARCH_LANES`` lanes, a thread's
    ``SEARCH_LANES`` searches interleaved."""
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
    _launch("segment_search", "search", fn, haystack, kind,
            int(haystack.shape[0]), lo, hi, needles, cap, out, nthr,
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


def lb_expand(sizes: torch.Tensor, cap_out: int, *,
              threads: Optional[int] = None) -> KExpansion:
    """K6: load-balanced expansion geometry of segments of ``sizes``
    (cap_in,) int32 over ``cap_out`` output slots → KExpansion(in_pos,
    rank, valid, total): each slot's segment, its rank there, whether it
    lies below the total (bool), and the total (0-d int32). Every slot,
    the invalid ones too, equals the plain version's. Two kernel
    launches, the scan of ``sizes`` and the expand pass, and no other
    device work."""
    if sizes.dim() != 1:
        raise ValueError("sizes must be (cap_in,)")
    if sizes.device.type == "cpu":
        offsets = ref.lb_offsets(sizes)
        return KExpansion(*ref.lb_expand(offsets, cap_out),
                          total=offsets[-1])
    dev = sizes.device
    _require(sizes, "sizes", torch.int32, 1, dev)
    if not 0 <= cap_out <= INT32_MAX:
        raise ValueError(f"cap_out {cap_out:,} is outside int32")
    cap_in = int(sizes.shape[0])
    nthr = _threads("lb_expand", cap_out, dev, threads)
    # the scratch lives until the launches are enqueued on the stream
    (offsets, _, tile_lane), lb, epoch = _lb_scratch(
        1, cap_in, cap_out, nthr, False, dev)
    out = torch.empty((2 * cap_out + 1,), dtype=torch.int32, device=dev)
    in_pos, rank, total = out[:cap_out], out[cap_out:-1], out[-1]
    valid = torch.empty((cap_out,), dtype=torch.bool, device=dev)
    _launch("lb_expand", "lb_expand", "lb_expand", sizes, cap_in, cap_out,
            offsets, tile_lane, tile_lane.numel(), lb.counters, lb.live_end,
            lb.status, lb.status.numel(), epoch, in_pos, rank, valid, total,
            nthr, runtime.stream_ptr(dev))
    del offsets, tile_lane
    KERNELS["lb_expand"].count("int32")
    return KExpansion(in_pos, rank, valid, total)


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


def _attention_workspace(nsplit: int, sq: int, d: int,
                         dev: torch.device):
    """K7's split-form workspace: acc (nsplit, Sq, D) and ml (nsplit, Sq,
    2), fp32."""
    if nsplit * sq * d > INT32_MAX:
        raise ValueError("nsplit x Sq x D beyond int32")
    return (torch.empty((nsplit, sq, d), dtype=torch.float32, device=dev),
            torch.empty((nsplit, sq, 2), dtype=torch.float32, device=dev))


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
    dev = q.device
    acc, ml = _attention_workspace(nsplit, sq, d, dev)
    _launch("attention_partials", "attention", "flash_attention", code, q,
            k, v, None, acc, ml, sq, sk, d, 1.0 / math.sqrt(d),
            int(bool(causal)), nsplit, runtime.stream_ptr(dev))
    KERNELS["flash_attention"].count(_dtype_name(q.dtype))
    return acc, ml


def attention_combine(acc: torch.Tensor, ml: torch.Tensor,
                      dtype: torch.dtype) -> torch.Tensor:
    """K7c, K7's combine: o (Sq, D) in ``dtype`` from the parts of
    ``attention_partials``: o = sum_s w_s acc_s / max(sum_s w_s l_s,
    1e-30), w_s = exp(m_s - max m). On the card every sum has a fixed
    order (repeated calls are bit-equal); D is even and at least 8."""
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
    # the kernel reads acc in 16-byte vectors and (m, l) in 8-byte pairs
    if acc.data_ptr() % 16:
        acc = acc.clone()
    if ml.data_ptr() % 8:
        ml = ml.clone()
    out = torch.empty((sq, d), dtype=dtype, device=dev)
    _launch("attention_combine", "attention", "attention_combine",
            _ATTN_DTYPES[dtype], acc, ml, out, sq, d, nsplit,
            runtime.stream_ptr(dev))
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
    kernel (K7c) merges them: one C call launches both, the combine as a
    programmatic dependent launch behind K7. On the card D is a multiple
    of 8 up to 256."""
    del bq, bk
    if q.device.type == "cpu":
        return ref.flash_attention(q, k, v, causal)
    code, sq, sk, d, q, k, v = _attention_inputs(q, k, v)
    dev = q.device
    nsplit = attention_splits(sq, sk, q.dtype, sm_count(dev))
    out = torch.empty((sq, d), dtype=q.dtype, device=dev)
    acc = ml = None
    if nsplit > 1:
        acc, ml = _attention_workspace(nsplit, sq, d, dev)
    _launch("flash_attention", "attention",
            "flash_attention_split" if nsplit > 1 else "flash_attention",
            code, q, k, v, out, acc, ml, sq, sk, d, 1.0 / math.sqrt(d),
            int(bool(causal)), nsplit, runtime.stream_ptr(dev))
    KERNELS["flash_attention"].count(_dtype_name(q.dtype))
    if nsplit > 1:
        KERNELS["attention_combine"].count(_dtype_name(q.dtype))
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
    _launch("moe_gather", "moe_gather", "moe_gather", x, t,
            d * x.element_size(), x.element_size(), slot_token, s, scratch,
            out, runtime.stream_ptr(dev))
    KERNELS["moe_gather"].count(_dtype_name(x.dtype))
    return out


# ---------------------------------------------------------------------------
# The launch audit's declarations (analysis.sanitize): per launch site, every
# pointer of its C signature with its rank, the extent the launch's grid
# reads or writes, the read-modify-write outputs (``accumulate``) and the
# index operands to check, from the arguments as ``_launch`` takes them.
# ---------------------------------------------------------------------------

_KIND_DTYPES = {0: "int32", 1: "int16", 2: "int64", _DELTA_KIND: "uint16"}
_ATTN_NAMES = {0: "float32", 1: "bfloat16", 2: "float16"}
_ITEM_DTYPES = {4: ("float32",), 2: ("bfloat16", "float16")}
# the look-back words' invariant: no word of this launch's epoch yet
_LOOKBACK = {"counters": sanitize.epoch_tagged(32, 32),
             "live_end": sanitize.epoch_tagged(32, 32),
             "status": sanitize.epoch_tagged(34)}


def _rows(t) -> int:
    """The rows of a CSR's offsets argument (0 if it is no tensor)."""
    return t.numel() - 1 if isinstance(t, torch.Tensor) else 0


def _lb_operands(a: dict, b: int, rank: int) -> dict:
    """The operands K1, K3 and K6 share: the sizes (of ``rank``), the
    offsets / tile-lane scratch (views of one allocation) and the
    look-back words."""
    cap_in = a["cap_in"]
    return {"sizes": sanitize.In(rank, b * cap_in),
            "offsets": sanitize.Out(1, b * (cap_in + 1)),
            "tile_lane": sanitize.Out(1, a["tile_lane_cap"]),
            "counters": sanitize.Out(1, b), "live_end": sanitize.Out(1, b),
            "status": sanitize.Out(1, a["status_cap"])}


def _lb_geometry(a: dict, b: int, slot_tiles: int, tiles: int) -> list:
    return [("tile_lane_cap (B x (slot tiles + 1))", b * (slot_tiles + 1),
             a["tile_lane_cap"]),
            ("status_cap (B x tiles)", b * tiles, a["status_cap"])]


def _graph_operands(a: dict, b: int) -> dict:
    """K1's and K3's CSR, column store and frontier."""
    n = _rows(a["row_offsets"])
    kind = a["kind"]
    return {"base": sanitize.In(2, b * a["cap_in"]),
            "row_offsets": sanitize.In(1, n + 1),
            "cols": sanitize.In(1, a["m"], _KIND_DTYPES.get(kind, "a column "
                                                           "kind")),
            "anchor": sanitize.In(1, n if kind == _DELTA_KIND else 0,
                                  nullable=kind != _DELTA_KIND)}


def _graph_checks(a: dict, n_cols: int) -> list:
    """K1's and K3's index operands: the offsets, the frontier's lanes,
    the column ids (in [0, ``n_cols``)) or the delta stream."""
    ro, m = a["row_offsets"], a["m"]
    n = _rows(ro)
    out = (sanitize.offsets_check(ro, m)
           + sanitize.lanes_check(a["base"], a["sizes"], ro, n, m))
    if a["kind"] == _DELTA_KIND:
        return out + sanitize.delta_check(ro, a["cols"], a["anchor"],
                                          n_cols, m)
    return out + sanitize.ids_check(a["cols"][:m], 0, n_cols, "column ids")


def _decl_advance_batch(fn: str, a: dict) -> sanitize.Launch:
    """K3: the frontier (B, cap_in), seven outputs (B, cap_out) and (B,)."""
    b, cap_in, cap_out = a["batch"], a["cap_in"], a["cap_out"]
    slot_tiles = max(_ceil_div(cap_out, lb_tile(a["threads"])), 1)
    rows = {p: sanitize.Out(2, b * cap_out)
            for p in ("src", "dst", "eid", "in_pos", "rank", "valid")}
    return sanitize.Launch(
        operands={**_lb_operands(a, b, 2), **_graph_operands(a, b),
                  "ebase": sanitize.Out(1, b * cap_in), **rows,
                  "totals": sanitize.Out(1, b)},
        accumulate=_LOOKBACK,
        geometry=_lb_geometry(a, b, slot_tiles,
                              max(_ceil_div(cap_in, SCAN_TILE), 1)),
        checks=(lambda a: _graph_checks(a, _rows(a["row_offsets"])),))


def _decl_advance_filter_batch(fn: str, a: dict) -> sanitize.Launch:
    """K1: the frontier, the visited bits and the first-slot table (B,
    n), the frontier out (B, cap_front); column ids index the (B, n)
    tables."""
    b, n, cap_in = a["batch"], a["n"], a["cap_in"]
    tile = lb_tile(a["threads"])
    slot_tiles = max(_ceil_div(a["cap_out"], tile), 1)
    return sanitize.Launch(
        operands={**_lb_operands(a, b, 2), **_graph_operands(a, b),
                  "offsets": sanitize.Out(2, b * (cap_in + 1)),
                  "ebase": sanitize.Out(2, b * cap_in),
                  "tile_lane": sanitize.Out(2, a["tile_lane_cap"]),
                  "visited": sanitize.In(2, b * n),
                  "first": sanitize.Out(2, b * n),
                  "cand": sanitize.Out(2, a["cand_cap"]),
                  "ids": sanitize.Out(2, b * a["cap_front"]),
                  "srcs": sanitize.Out(2, b * a["cap_front"]),
                  "lengths": sanitize.Out(1, b),
                  "totals": sanitize.Out(1, b)},
        accumulate={"first": sanitize.filled(INT32_MAX), **_LOOKBACK},
        geometry=_lb_geometry(a, b, slot_tiles,
                              max(_ceil_div(cap_in, SCAN_TILE), slot_tiles))
        + [("cand_cap (B x slot tiles x slots / 32)",
            b * slot_tiles * tile // 32, a["cand_cap"])],
        checks=(lambda a: _graph_checks(a, a["n"]),))


def _decl_compact(fn: str, a: dict) -> sanitize.Launch:
    """K2: values rows vstride apart (one shared row at vstride 0), the
    mask and the packed rows (B, cap)."""
    b, cap = a["batch"], a["cap"]
    tiles = max(_ceil_div(cap, COMPACT_ITEMS * a["threads"]), 1)
    return sanitize.Launch(
        operands={"values": sanitize.In(2, (b - 1) * a["vstride"] + cap),
                  "mask": sanitize.In(2, b * cap),
                  "counters": sanitize.Out(1, b),
                  "status": sanitize.Out(1, a["status_cap"]),
                  "packed": sanitize.Out(2, b * cap),
                  "totals": sanitize.Out(1, b)},
        accumulate={w: _LOOKBACK[w] for w in ("counters", "status")},
        geometry=[("status_cap (B x tiles)", b * tiles, a["status_cap"]),
                  ("vstride >= 0", 0, a["vstride"])])


def _csr_checks(a: dict, rows: str) -> list:
    """K4's and K4m's index operands: the offsets against the column
    array (and the values), the column ids in [0, nx), the long rows in
    [0, n)."""
    m = a["cols"].numel()
    if a["vals"] is not None:
        m = min(m, a["vals"].numel())
    return (sanitize.offsets_check(a["offsets"], m, "offsets")
            + sanitize.ids_check(a["cols"], 0, a["nx"], "column ids")
            + sanitize.ids_check(a[rows], 0, a["n"], rows))


def _decl_spmv(fn: str, a: dict) -> sanitize.Launch:
    """K4: y (n,) from x (nx,) over the CSR; the heavy rows' schedule."""
    n = a["n"]
    return sanitize.Launch(
        operands={"offsets": sanitize.In(1, n + 1),
                  "cols": sanitize.In(1, 0), "vals": sanitize.In(
                      1, 0, nullable=True),
                  "x": sanitize.In(1, a["nx"]),
                  "mask": sanitize.In(1, n, nullable=True),
                  "heavy": sanitize.In(1, a["nheavy"]),
                  "y": sanitize.Out(1, n)},
        geometry=[("nheavy (nvery of them split)", a["nvery"],
                   a["nheavy"])],
        checks=(lambda a: _csr_checks(a, "heavy"),))


def _decl_spmm(fn: str, a: dict) -> sanitize.Launch:
    """K4m: y (n, k) from x (nx, k) over the CSR; the long rows."""
    n, k = a["n"], a["k"]
    return sanitize.Launch(
        operands={"offsets": sanitize.In(1, n + 1),
                  "cols": sanitize.In(1, 0), "vals": sanitize.In(
                      1, 0, nullable=True),
                  "x": sanitize.In(2, a["nx"] * k),
                  "mask": sanitize.In(1, n, nullable=True),
                  "long_rows": sanitize.In(1, a["nlong"]),
                  "y": sanitize.Out(2, n * k)},
        geometry=[("nlong (nsplit of them split)", a["nsplit"],
                   a["nlong"])],
        checks=(lambda a: _csr_checks(a, "long_rows"),))


def _decl_segment_search(fn: str, a: dict) -> sanitize.Launch:
    """K5: cap lanes of (lo, hi, needle) over the haystack (m,); found
    (bool) or pos (int32) out."""
    cap = a["cap"]
    out = "pos" if fn == "segment_search_locate" else "found"
    return sanitize.Launch(
        operands={"hay": sanitize.In(1, a["m"], _KIND_DTYPES.get(
                      a["kind"], "a column kind")),
                  "lo": sanitize.In(1, cap), "hi": sanitize.In(1, cap),
                  "needles": sanitize.In(1, cap), out: sanitize.Out(1, cap)},
        checks=(lambda a: sanitize.segments_check(a["hay"], a["lo"],
                                                  a["hi"], a["m"]),))


def _decl_lb_expand(fn: str, a: dict) -> sanitize.Launch:
    """K6: sizes (cap_in,) ≥ 0, the geometry (cap_out,) each and the
    total."""
    cap_in, cap_out = a["cap_in"], a["cap_out"]
    slot_tiles = max(_ceil_div(cap_out, lb_tile(a["threads"])), 1)
    return sanitize.Launch(
        operands={**_lb_operands(a, 1, 1),
                  "in_pos": sanitize.Out(1, cap_out),
                  "rank": sanitize.Out(1, cap_out),
                  "valid": sanitize.Out(1, cap_out),
                  "total": sanitize.Out(0, 1)},
        accumulate=_LOOKBACK,
        geometry=_lb_geometry(a, 1, slot_tiles,
                              max(_ceil_div(cap_in, SCAN_TILE), 1)),
        checks=(lambda a: sanitize.ids_check(a["sizes"], 0, INT32_MAX + 1,
                                             "segment sizes"),))


def _decl_attention(fn: str, a: dict) -> sanitize.Launch:
    """K7 (and K7c behind it in the split form): q (Sq, D), k and v (Sk,
    D) in the type of ``dtype``; o (Sq, D) written with one part or by
    the combine, the parts' workspace with more than one."""
    sq, sk, d, nsplit = a["sq"], a["sk"], a["d"], a["nsplit"]
    t = _ATTN_NAMES.get(a["dtype"], "an attention dtype")
    parts = nsplit > 1
    writes_o = not parts or fn == "flash_attention_split"
    return sanitize.Launch(
        operands={"q": sanitize.In(2, sq * d, t),
                  "k": sanitize.In(2, sk * d, t),
                  "v": sanitize.In(2, sk * d, t),
                  "o": sanitize.Out(2, sq * d if writes_o else 0, t,
                                    nullable=not writes_o),
                  "ws_acc": sanitize.Out(3, nsplit * sq * d if parts else 0,
                                         nullable=not parts),
                  "ws_ml": sanitize.Out(3, nsplit * sq * 2 if parts else 0,
                                        nullable=not parts)})


def _decl_attention_combine(fn: str, a: dict) -> sanitize.Launch:
    """K7c: the parts (nsplit, Sq, D) and (nsplit, Sq, 2) in, o (Sq, D)
    out in the type of ``dtype``."""
    sq, d, nsplit = a["sq"], a["d"], a["nsplit"]
    return sanitize.Launch(operands={
        "ws_acc": sanitize.In(3, nsplit * sq * d),
        "ws_ml": sanitize.In(3, nsplit * sq * 2),
        "o": sanitize.Out(2, sq * d, _ATTN_NAMES.get(a["dtype"],
                                                     "an attention dtype"))})


def _decl_moe_gather(fn: str, a: dict) -> sanitize.Launch:
    """K8: x (tokens, D) and out (slots, D) of ``itemsize``-byte
    elements, D = row_bytes / itemsize; the counting sort's scratch. Any
    slot id is in range: -1 and below give a zero row, one past the last
    token reads the last row (the reference's clamp)."""
    tokens, slots, item = a["tokens"], a["slots"], a["itemsize"]
    width = a["row_bytes"] // item if item > 0 else 0
    t = _ITEM_DTYPES.get(item, ("an element size",))
    return sanitize.Launch(
        operands={"x": sanitize.In(2, tokens * width, t),
                  "slot_token": sanitize.In(1, slots),
                  "scratch": sanitize.Out(1, 2 * (tokens + 1) + 1 + slots),
                  "out": sanitize.Out(2, slots * width, t)},
        geometry=[("row_bytes (a whole number of elements)",
                   a["row_bytes"], width * item)])


# launch site -> its declaration
_SITES = {
    "advance_batch": _decl_advance_batch,
    "advance_filter_batch": _decl_advance_filter_batch,
    "compact": _decl_compact,
    "spmv": _decl_spmv,
    "spmm": _decl_spmm,
    "segment_search": _decl_segment_search,
    "lb_expand": _decl_lb_expand,
    "attention_partials": _decl_attention,
    "attention_combine": _decl_attention_combine,
    "flash_attention": _decl_attention,
    "moe_gather": _decl_moe_gather,
}
SITES = tuple(_SITES)


# ---------------------------------------------------------------------------
# The reference's remaining kernel-API names (repro.kernels.ops), with its
# call contracts, over the registry-named wrappers above: on CUDA tensors
# each reaches its kernel, on CPU tensors its plain version, as they do.
# ---------------------------------------------------------------------------


def advance_fused(row_offsets, col_indices, base, sizes, cap_out: int):
    """The reference's single-lane fused LB advance: K3 (a B=1 launch) →
    (src, dst, edge_id, in_pos, rank, valid, total)."""
    return advance(row_offsets, col_indices, base, sizes, cap_out)


def advance_fused_batch(row_offsets, col_indices, base, sizes,
                        cap_out: int):
    """The reference's batched fused LB advance: K3 → (src, dst,
    edge_id, in_pos, rank, valid, totals)."""
    return advance_batch(row_offsets, col_indices, base, sizes, cap_out)


def advance_filter_fused(row_offsets, col_indices, base, sizes, visited,
                         cap_out: int, cap_front: int):
    """The reference's fused advance+filter of one lane: K1 (a B=1
    launch) → (ids, srcs, length, total). ``visited`` (n,) of any
    integer or bool type, nonzero = visited."""
    return advance_filter(row_offsets, col_indices, base, sizes,
                          visited != 0, cap_out, cap_front)


def advance_filter_fused_batch(row_offsets, col_indices, base, sizes,
                               visited, cap_out: int, cap_front: int):
    """The reference's batched fused advance+filter: K1 → (ids, srcs,
    lengths, totals); ``visited`` (B, n), nonzero = visited."""
    return advance_filter_batch(row_offsets, col_indices, base, sizes,
                                visited != 0, cap_out, cap_front)


def filter_compact(ids: torch.Tensor, keep: torch.Tensor):
    """The reference's stable compaction of ids[keep] → (packed (cap,),
    count ()): K2 on one row, -1 past the count."""
    packed, totals = compact(ids[None], (keep != 0)[None])
    return packed[0], totals[0]


def semiring_spmm(offsets, indices, values, x, sr, ell_width, mask,
                  row_seg=None):
    """The reference's masked-semiring SpMM, Y⟨mask⟩ = A ⊗ X with X
    (nx, k): K4m. ``mask`` (n,) of any type, nonzero = computed."""
    return spmm(offsets, indices, values, x, sr, ell_width,
                None if mask is None else mask != 0, row_seg)


def semiring_spmv(offsets, indices, values, x, sr, ell_width, mask,
                  row_seg=None, over_pos=None, over_row=None):
    """The reference's masked-semiring SpMV (the k = 1 column of its
    SpMM): K4. ``mask`` (n,) of any type, nonzero = computed."""
    return spmv(offsets, indices, values, x, sr, ell_width,
                None if mask is None else mask != 0, row_seg, over_pos,
                over_row)


# the oracles, as the reference re-exports them for tests and benchmarks
oracle = ref


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
