"""The ``"cuda"`` providers: wrappers around the hand-written Hopper
kernels (counterpart of ``repro.kernels.ops``).

Each wrapper takes the registry op's arguments, and

  * on CPU tensors runs the kernel's plain version (``kernels.ref``) —
    only because the tensors lie on the CPU;
  * on CUDA tensors checks device, dtype, shape and contiguity, allocates
    every output and scratch buffer, launches the kernel on PyTorch's
    current stream, raises if the launch returned a CUDA error, and adds
    one to the kernel's launch counter. It never falls back.

``KERNELS`` lists the five kernels with their sources, the TPU kernels
they replace and their launch counters (``chip_smoke.py`` reads and
resets them). The ``"mxm"`` provider is no kernel of its own: it runs
K3 (the expansion) and K5 (the probe) through their wrappers.
"""
from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Optional

import torch

from ..core import backend as B
from ..linalg.ops import make_mxm_impl
from . import ref, runtime

INT32_MAX = 2 ** 31 - 1
_THREADS = 256


@dataclass
class Kernel:
    """One hand-written kernel: where it lives, what it replaces, and how
    many times its wrapper launched it."""

    name: str
    source: str
    replaces: str
    launches: int = 0


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
    Kernel("segment_search", "src/repro_torch/kernels/csrc/search.cu",
           "src/repro/kernels/segment_search.py:52"),
)}


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0


_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    ("advance", "advance_batch"): [_P] * 4 + [_I] * 5 + [_P] * 7,
    ("advance", "advance_filter_batch"): (
        [_P] * 5 + [_I] * 7 + [_P] * 9 + [_P]),
    ("compact", "compact_batch"): (
        [_P, ctypes.c_longlong, _P, _I, _I] + [_P] * 4 + [_P]),
    ("spmv", "spmv"): [_I] + [_P] * 4 + [_I, _P, _I, _I, _P, _P],
    ("search", "segment_search_found"): (
        [_P, _I] + [_P] * 3 + [ctypes.c_longlong, _P, _P]),
    ("search", "segment_search_locate"): (
        [_P, _I] + [_P] * 3 + [ctypes.c_longlong, _P, _P]),
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


def _check_csr(row_offsets, col_indices, dev) -> None:
    _require(row_offsets, "row_offsets", torch.int32, 1, dev)
    _require(col_indices, "col_indices", torch.int32, 1, dev)
    if col_indices.shape[0] > INT32_MAX:
        raise ValueError("more edges than int32 offsets address")


@B.register("advance_batch", B.CUDA)
def advance_batch(row_offsets, col_indices, base, sizes, cap_out: int):
    """K3: batched LB advance → (src, dst, edge_id, in_pos, rank, valid,
    totals), (B, cap_out) each and totals (B,)."""
    if row_offsets.device.type == "cpu":
        return ref.advance_batch(row_offsets, col_indices, base, sizes,
                                 cap_out)
    dev = row_offsets.device
    _check_csr(row_offsets, col_indices, dev)
    _require(base, "base", torch.int32, 2, dev)
    _require(sizes, "sizes", torch.int32, 2, dev)
    if base.shape != sizes.shape:
        raise ValueError("base and sizes must have one shape (B, cap_in)")
    b, cap_in = base.shape
    if cap_out > INT32_MAX:
        raise ValueError("cap_out beyond int32")
    offsets = _offsets(sizes)
    out = [torch.empty((b, cap_out), dtype=torch.int32, device=dev)
           for _ in range(5)]
    valid = torch.empty((b, cap_out), dtype=torch.bool, device=dev)
    _launch("advance", "advance_batch", runtime.ptr(offsets),
            runtime.ptr(base), runtime.ptr(row_offsets),
            runtime.ptr(col_indices), b, cap_in, cap_out,
            int(col_indices.shape[0]), _iters(cap_in),
            *(runtime.ptr(t) for t in out), runtime.ptr(valid),
            runtime.stream_ptr(dev))
    KERNELS["advance_batch"].launches += 1
    totals = offsets[:, cap_in].clone()
    return (*out, valid, totals)


@B.register("advance", B.CUDA)
def advance(row_offsets, col_indices, base, sizes, cap_out: int):
    """Single-lane "advance": a B=1 launch of K3."""
    out = advance_batch(row_offsets, col_indices, base[None], sizes[None],
                        cap_out)
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


@B.register("advance_filter_batch", B.CUDA)
def advance_filter_batch(row_offsets, col_indices, base, sizes,
                         visited: torch.Tensor, cap_out: int,
                         cap_front: int, cache: Optional[dict] = None):
    """K1: fused advance → visited test → exact first-occurrence culling
    → compaction. Returns (ids, srcs, lengths, totals)."""
    if row_offsets.device.type == "cpu":
        return ref.advance_filter_batch(row_offsets, col_indices, base,
                                        sizes, visited, cap_out, cap_front)
    dev = row_offsets.device
    _check_csr(row_offsets, col_indices, dev)
    _require(base, "base", torch.int32, 2, dev)
    _require(sizes, "sizes", torch.int32, 2, dev)
    _require(visited, "visited", torch.bool, 2, dev)
    if base.shape != sizes.shape or visited.shape[0] != base.shape[0]:
        raise ValueError("base, sizes and visited must share the batch")
    if cap_out > INT32_MAX or cap_front < 1:
        raise ValueError("bad cap_out / cap_front")
    b, cap_in = base.shape
    n = int(visited.shape[1])
    offsets = _offsets(sizes)
    first = _first_table(cache, b, n, dev)
    nblk = -(-cap_out // _THREADS)

    def empty(*shape):
        return torch.empty(shape, dtype=torch.int32, device=dev)

    kdst, ksrc = empty(b, cap_out), empty(b, cap_out)
    bcount, boff = empty(b, nblk), empty(b, nblk)
    ids, srcs = empty(b, cap_front), empty(b, cap_front)
    lengths, totals = empty(b), empty(b)
    _launch("advance", "advance_filter_batch", runtime.ptr(offsets),
            runtime.ptr(base), runtime.ptr(row_offsets),
            runtime.ptr(col_indices), runtime.ptr(visited), b, n, cap_in,
            cap_out, int(col_indices.shape[0]), _iters(cap_in), cap_front,
            runtime.ptr(first), runtime.ptr(kdst), runtime.ptr(ksrc),
            runtime.ptr(bcount), runtime.ptr(boff), runtime.ptr(ids),
            runtime.ptr(srcs), runtime.ptr(lengths), runtime.ptr(totals),
            runtime.stream_ptr(dev))
    KERNELS["advance_filter_batch"].launches += 1
    return ids, srcs, lengths, totals


@B.register("advance_filter", B.CUDA)
def advance_filter(row_offsets, col_indices, base, sizes, visited,
                   cap_out: int, cap_front: int, cache=None):
    """Single-lane "advance_filter": a B=1 launch of K1."""
    out = advance_filter_batch(row_offsets, col_indices, base[None],
                               sizes[None], visited[None], cap_out,
                               cap_front, cache)
    return tuple(t[0] for t in out)


@B.register("compact", B.CUDA)
def compact(values: torch.Tensor, mask: torch.Tensor):
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
    nblk = -(-cap // _THREADS)
    bcount = torch.empty((b, nblk), dtype=torch.int32, device=dev)
    boff = torch.empty_like(bcount)
    packed = torch.empty((b, cap), dtype=torch.int32, device=dev)
    totals = torch.empty((b,), dtype=torch.int32, device=dev)
    _launch("compact", "compact_batch", runtime.ptr(values), vstride,
            runtime.ptr(mask), b, cap, runtime.ptr(bcount),
            runtime.ptr(boff), runtime.ptr(packed), runtime.ptr(totals),
            runtime.stream_ptr(dev))
    KERNELS["compact"].launches += 1
    return packed, totals


@B.register("spmv", B.CUDA)
def spmv(offsets, indices, values, x, sr, ell_width, mask, row_seg=None,
         over_pos=None, over_row=None):
    """K4: masked-semiring SpMV over the CSR, one warp per row, with the
    reference's fixed fold (the overflow lists are implied by the CSR)."""
    if offsets.device.type == "cpu":
        return ref.spmv(offsets, indices, values, x, sr, ell_width, mask,
                        row_seg, over_pos, over_row)
    dev = offsets.device
    _require(offsets, "offsets", torch.int32, 1, dev)
    _require(indices, "indices", torch.int32, 1, dev)
    _require(x, "x", torch.float32, 1, dev)
    if values is not None:
        _require(values, "values", torch.float32, 1, dev)
        if values.shape != indices.shape:
            raise ValueError("values and indices differ in length")
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
    if int(indices.shape[0]) and int(x.shape[0]) == 0:
        raise ValueError("x is empty")
    y = torch.empty((n,), dtype=torch.float32, device=dev)
    _launch("spmv", "spmv", sr.code, runtime.ptr(offsets),
            runtime.ptr(indices), runtime.ptr(values), runtime.ptr(x),
            int(x.shape[0]), runtime.ptr(mask), n, width, runtime.ptr(y),
            runtime.stream_ptr(dev))
    KERNELS["spmv"].launches += 1
    return y


def _search(haystack, lo, hi, needles, locate: bool) -> torch.Tensor:
    """K5 on CUDA tensors: one launch in ``found`` (bool) or ``locate``
    (int32 position, -1 where absent) mode."""
    dev = haystack.device
    _require(haystack, "haystack", torch.int32, 1, dev)
    for t, name in ((lo, "lo"), (hi, "hi"), (needles, "needles")):
        _require(t, name, torch.int32, 1, dev)
    cap = int(needles.shape[0])
    if lo.shape[0] != cap or hi.shape[0] != cap:
        raise ValueError("lo, hi and needles must have one length")
    if haystack.shape[0] > INT32_MAX:
        raise ValueError("haystack beyond int32 positions")
    if locate:
        out = torch.empty((cap,), dtype=torch.int32, device=dev)
        fn = "segment_search_locate"
    else:
        out = torch.empty((cap,), dtype=torch.bool, device=dev)
        fn = "segment_search_found"
    _launch("search", fn, runtime.ptr(haystack), int(haystack.shape[0]),
            runtime.ptr(lo), runtime.ptr(hi), runtime.ptr(needles), cap,
            runtime.ptr(out), runtime.stream_ptr(dev))
    KERNELS["segment_search"].launches += 1
    return out


@B.register("segment_search", B.CUDA)
def segment_search(haystack, lo, hi, needles) -> torch.Tensor:
    """K5, found mode: needles[i] in sorted haystack[lo[i]:hi[i]) → bool."""
    if haystack.device.type == "cpu":
        return ref.segment_search(haystack, lo, hi, needles)
    return _search(haystack, lo, hi, needles, locate=False)


def segment_locate(haystack, lo, hi, needles) -> torch.Tensor:
    """K5, locate mode: the position of needles[i] in haystack[lo[i]:hi[i])
    → int32, -1 where absent (the probe of the SpGEMM)."""
    if haystack.device.type == "cpu":
        return ref.segment_locate(haystack, lo, hi, needles)
    return _search(haystack, lo, hi, needles, locate=True)


# masked SpGEMM: K3 expands (a B = 1 launch), K5 locates
B.register("mxm", B.CUDA)(make_mxm_impl(advance, segment_locate))
