"""Runtime sanitizers: the set-up (retrace) counter and the launch audit
of the hand-written kernels (counterpart of ``repro.analysis.sanitize``).

Set-up counter
    The reference counts jit traces: a jitted body runs only on a cache
    miss. The port traces nothing; its counterpart of a compile is the
    one-time set-up a primitive builds for a (graph, configuration) and
    keeps in the graph's ``cache`` or a kernel cache. Each of the six
    primitives opens a ``setup_probe(name, graph.cache, key)`` scope
    around the work it can reuse; the scope counts one trace of
    ``name`` when the call built set-up: a configuration ``key`` the
    graph has not been set up for (a fresh graph, a new batch width or
    static option), or any cached set-up the call had to build
    (``note_setup()``, called where K1's first-slot table, a decoded or
    widened column view, PageRank's reciprocal degrees, the CSC segment
    ids, K4's long-row schedule or a cached operand is made). A warm call
    of a fixed configuration builds nothing and counts nothing.
    ``retrace_guard(name)`` wraps a hot loop and raises ``RetraceError``
    when the window's count exceeds the primitive's declared budget
    (``budgets.COMPILE_BUDGETS``).

Launch audit
    ``kernels.ops._launch`` runs ``check_launch`` before every C call
    when sanitizing is on (``REPRO_SANITIZE=1`` or the ``sanitizing()``
    context). Each launch site declares its operands (``Launch``): every
    pointer the C signature takes, as the tensor itself, with its rank,
    the extent the launch's grid reads or writes, and which outputs are
    read-modify-write by design (``accumulate``: K1's first-slot table,
    the look-back scans' words), plus the index operands to check. The
    audit raises ``MemoryFault`` before the kernel runs, so the card
    stays usable, on three classes of fault:

      (a) out-of-bounds — an extent the grid covers that passes its
          operand's end; an index operand out of range (offsets not
          non-decreasing or past the column array, column ids outside
          [0, n), frontier ids outside [-1, n), K5 segments past the
          haystack or not sorted);
      (b) write-write race — an output whose storage overlaps an input
          or another output unless the site declared the pair
          (``aliases``); a read-modify-write output that still holds
          another launch's words (a look-back word already tagged with
          this launch's epoch, a first-slot table not reset);
      (c) rank or dtype mismatch — an argument that does not fit the C
          signature (a pointer that is no tensor, a tensor of another
          element type or rank than declared, a scalar outside its C
          type).

    The audit is plain PyTorch: it runs on the card's tensors before a
    launch and on CPU tensors in the tests. It reads the device once a
    launch (every value check of the launch in one read). With
    sanitizing off ``_launch`` does nothing more than the C call.

This module imports nothing of the port and only the standard library at
module level (torch inside the audit), so ``repro_torch.core`` and
``repro_torch.kernels`` import it without cycles.
"""
from __future__ import annotations

import os
import threading
from collections import Counter
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

ENV_VAR = "REPRO_SANITIZE"

_tls = threading.local()

# ---------------------------------------------------------------------------
# activation
# ---------------------------------------------------------------------------


def _ctx_stack() -> list:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def enabled() -> bool:
    """Sanitizing active? Innermost ``sanitizing()`` context wins, else
    the ``REPRO_SANITIZE`` env var (any value but ''/'0'/'false')."""
    stack = _ctx_stack()
    if stack:
        return stack[-1]
    return os.environ.get(ENV_VAR, "") not in ("", "0", "false", "False")


@contextmanager
def sanitizing(on: bool = True):
    """Context manager: force sanitizing on (or off) for the block. The
    launch audit reads it at every launch, so a block of calls is
    audited whole, warm calls included."""
    _ctx_stack().append(bool(on))
    try:
        yield
    finally:
        _ctx_stack().pop()


# ---------------------------------------------------------------------------
# set-up (retrace) counter
# ---------------------------------------------------------------------------

_TRACE_COUNTS: Counter = Counter()


class RetraceError(RuntimeError):
    """A primitive exceeded its declared compile budget inside a
    ``retrace_guard`` window."""


def trace_probe(name: str) -> None:
    """Count one trace (one call that built set-up) of ``name``."""
    _TRACE_COUNTS[name] += 1


def trace_count(name: str) -> int:
    """Total traces recorded for ``name`` in this process."""
    return _TRACE_COUNTS[name]


def _scopes() -> list:
    scopes = getattr(_tls, "scopes", None)
    if scopes is None:
        scopes = _tls.scopes = []
    return scopes


def note_setup() -> None:
    """Record that cached set-up was just built: every open
    ``setup_probe`` scope counts its call as a trace. Outside a scope it
    does nothing."""
    for frame in _scopes():
        frame[0] = True


@contextmanager
def setup_probe(name: str, cache: Optional[dict], key=()):
    """One primitive call's set-up scope (see the module docstring):
    counts one trace of ``name`` at exit when ``key`` is new to
    ``cache`` (then recorded there) or the block called
    ``note_setup()``."""
    mark = ("setup", name, key)
    frame = [cache is not None and mark not in cache]
    _scopes().append(frame)
    try:
        yield
    finally:
        _scopes().pop()
        if frame[0]:
            if cache is not None:
                cache[mark] = True
            trace_probe(name)


@contextmanager
def retrace_guard(name: str, budget: Optional[int] = None,
                  enforce: bool = True):
    """Fail a hot loop that rebuilds its set-up: raises ``RetraceError``
    when the block traces ``name`` more than ``budget`` times (default:
    the primitive's declared ``budgets.COMPILE_BUDGETS`` entry).

    Yields a report dict; ``report["traces"]`` is filled at exit so
    callers can log the window even when it passes. ``enforce=False``
    records without raising (the observability mode).
    """
    if budget is None:
        from .budgets import budget_for
        budget = budget_for(name)
    start = _TRACE_COUNTS[name]
    report = {"name": name, "budget": budget, "traces": None}
    try:
        yield report
    finally:
        report["traces"] = _TRACE_COUNTS[name] - start
    if enforce and report["traces"] > budget:
        raise RetraceError(
            f"primitive {name!r} traced {report['traces']}× in a guarded "
            f"window (budget {budget}): a fixed workload configuration is "
            f"rebuilding its set-up per call — check the keys of the "
            f"graph's cache, per-call tensors used as keys, or graph / "
            f"batch-width churn in the caller")


# ---------------------------------------------------------------------------
# launch audit
# ---------------------------------------------------------------------------


class MemoryFault(RuntimeError):
    """An out-of-bounds extent or index, a write-write race, or an
    argument that does not fit the C signature, found before a launch."""


@dataclass(frozen=True)
class Operand:
    """A pointer argument of a launch: ``out`` if the launch writes it,
    its ``rank``, the ``extent`` in elements (from its first element) the
    launch's grid reads or writes, the element type a ``void*`` takes
    (``dtype``; a typed pointer's comes from the C type), and whether a
    null pointer is allowed."""

    rank: int
    extent: int
    out: bool = False
    dtype: Optional[tuple] = None
    nullable: bool = False


def In(rank: int, extent: int, dtype=None, nullable: bool = False):
    """An operand the launch only reads."""
    return Operand(rank, int(extent), False, _dtypes(dtype), nullable)


def Out(rank: int, extent: int, dtype=None, nullable: bool = False):
    """An operand the launch writes (``accumulate`` marks one it also
    reads)."""
    return Operand(rank, int(extent), True, _dtypes(dtype), nullable)


def _dtypes(dtype) -> Optional[tuple]:
    if dtype is None:
        return None
    return (dtype,) if isinstance(dtype, str) else tuple(dtype)


@dataclass
class Launch:
    """One launch site's declaration (see the module docstring).

    ``operands`` maps every pointer parameter of the C signature to its
    ``Operand``; ``accumulate`` maps each read-modify-write output to
    the invariant its reads rest on (``invariant(name, tensor, args)``
    → (message, 0-d bool tensor) pairs: ``epoch_tagged``, ``filled``);
    ``aliases`` pairs of operands allowed to share storage; ``geometry``
    (label, needed, have) capacities the grid needs beside what the
    caller passed; ``checks`` callables returning (message, 0-d bool
    tensor) pairs, each True when its index operand is in range — the
    invariants and the checks read in one device read."""

    operands: dict
    accumulate: dict = field(default_factory=dict)
    aliases: Sequence[tuple] = ()
    geometry: Sequence[tuple] = ()
    checks: Sequence[Callable] = field(default_factory=tuple)


# C parameter types: pointers take these element types, scalars these
# ranges
_PTR_DTYPES = {"i32*": ("int32",), "u32*": ("int32",),
               "u8*": ("bool", "uint8"), "u64*": ("int64",),
               "f32*": ("float32",), "void*": None}
_INT_RANGES = {"int": (-2 ** 31, 2 ** 31 - 1), "i64": (-2 ** 63, 2 ** 63 - 1),
               "u32": (0, 2 ** 32 - 1)}

_AUDITS: Counter = Counter()


def audit_count(site: str) -> int:
    """Launches of ``site`` audited since the last ``reset_audits``."""
    return sum(c for (s, _), c in _AUDITS.items() if s == site)


def audits() -> dict:
    """Audited launches since the last ``reset_audits``, by (site, C
    function)."""
    return dict(_AUDITS)


def reset_audits() -> None:
    _AUDITS.clear()


def _dtype_name(t) -> str:
    return str(t.dtype).replace("torch.", "")


def _span(t) -> int:
    """Elements from a tensor's first element to its last, inclusive."""
    if t.numel() == 0:
        return 0
    return 1 + sum((s - 1) * st for s, st in zip(t.shape, t.stride()))


def _bytes(t) -> tuple:
    start = t.data_ptr()
    return start, start + _span(t) * t.element_size()


def check_signature(name: str, signature: Sequence[tuple],
                    args: Sequence) -> None:
    """(c) before any declaration is read: the argument count, every
    scalar inside its C type, every pointer a tensor or None."""
    import torch
    if len(args) != len(signature):
        raise MemoryFault(
            f"{name}: rank or dtype mismatch: {len(args)} arguments for "
            f"the C signature's {len(signature)}")
    for (p, ctype), v in zip(signature, args):
        if ctype.endswith("*"):
            if v is not None and not isinstance(v, torch.Tensor):
                raise MemoryFault(
                    f"{name}: rank or dtype mismatch: {p} is a "
                    f"{type(v).__name__}, not a tensor")
        elif ctype in _INT_RANGES:
            lo, hi = _INT_RANGES[ctype]
            if not isinstance(v, int) or isinstance(v, bool) or not (
                    lo <= v <= hi):
                raise MemoryFault(
                    f"{name}: dtype mismatch: {p} = {v!r} is no {ctype}")


def check_launch(name: str, signature: Sequence[tuple], args: Sequence,
                 launch: Launch, site: Optional[str] = None) -> None:
    """Audit one launch of the C function ``name`` before it runs:
    ``signature`` its (parameter, C type) pairs, ``args`` the arguments
    as the site passes them (tensors for pointers), ``launch`` the site's
    declaration. Raises ``MemoryFault`` on the first fault found;
    counts the audit under ``site`` (default ``name``)."""
    import torch

    _AUDITS[(site or name, name)] += 1
    check_signature(name, signature, args)
    a = {p: v for (p, _), v in zip(signature, args)}
    ops = launch.operands
    # (c) every pointer against its C type and the declared rank
    for p, ctype in signature:
        v = a[p]
        if ctype.endswith("*"):
            spec = ops.get(p)
            if spec is None:
                raise MemoryFault(f"{name}: pointer {p} has no declaration")
            if v is None:
                if not spec.nullable:
                    raise MemoryFault(
                        f"{name}: rank or dtype mismatch: {p} is null")
                continue
            want = spec.dtype or _PTR_DTYPES[ctype]
            if _dtype_name(v) not in want:
                raise MemoryFault(
                    f"{name}: dtype mismatch: {p} is {_dtype_name(v)}, the "
                    f"C signature takes {ctype} ({' or '.join(want)})")
            if v.dim() != spec.rank:
                raise MemoryFault(
                    f"{name}: rank mismatch: {p} has rank {v.dim()} "
                    f"{tuple(v.shape)}, declared {spec.rank}")
    # (a) the extents the grid covers
    for p, spec in ops.items():
        t = a.get(p)
        if t is None:
            continue
        if spec.extent > _span(t):
            raise MemoryFault(
                f"{name}: out-of-bounds: the grid "
                f"{'writes' if spec.out else 'reads'} {spec.extent:,} "
                f"elements of {p}, which holds {_span(t):,}")
    for label, need, have in launch.geometry:
        if need > have:
            raise MemoryFault(f"{name}: out-of-bounds: {label} needs "
                              f"{need:,}, has {have:,}")
    # (b) no output shares storage with another operand unless declared
    allowed = {frozenset(pair) for pair in launch.aliases}
    live = [(p, _bytes(a[p])) for p in ops
            if a.get(p) is not None and a[p].numel() > 0]
    for p, (s0, e0) in live:
        if not ops[p].out:
            continue
        for q, (s1, e1) in live:
            if q == p or (ops[q].out and q < p):
                continue
            if s0 < e1 and s1 < e0 and frozenset((p, q)) not in allowed:
                raise MemoryFault(
                    f"{name}: write-write race: output {p} overlaps "
                    f"{'output' if ops[q].out else 'input'} {q}")
    # the read-modify-write invariants and the value checks, read from
    # the device at once
    pending = [c for p, inv in launch.accumulate.items()
               if a.get(p) is not None for c in inv(p, a[p], a)]
    pending += [c for check in launch.checks for c in check(a)]
    if pending:
        oks = torch.stack([ok.reshape(()).to(torch.bool)
                           for _, ok in pending]).tolist()
        for (msg, _), ok in zip(pending, oks):
            if not ok:
                raise MemoryFault(f"{name}: {msg}")


# ---- value checks: each returns [(message, 0-d bool tensor), ...] --------

_CHUNK = 1 << 26            # lanes a step of a per-lane check


def _true(like):
    import torch
    return torch.ones((), dtype=torch.bool, device=like.device)


def offsets_check(offsets, m: int, what: str = "row_offsets") -> list:
    """CSR offsets: first >= 0, non-decreasing, last <= m (the column
    array's length)."""
    if offsets.numel() == 0:
        return []
    o = offsets.reshape(-1)
    return [(f"out-of-bounds: {what} start below 0", o[0] >= 0),
            (f"out-of-bounds: {what} end past the column array "
             f"({m:,} entries)", o[-1] <= m),
            (f"out-of-bounds: {what} not non-decreasing",
             (o[1:] >= o[:-1]).all() if o.numel() > 1 else _true(o))]


def ids_check(ids, lo: int, hi: int, what: str) -> list:
    """Every id in [lo, hi)."""
    if ids is None or ids.numel() == 0:
        return []
    return [(f"out-of-bounds: {what} outside [{lo}, {hi})",
             (ids.amin().long() >= lo) & (ids.amax().long() < hi))]


def lanes_check(base, sizes, row_offsets, n: int, m: int) -> list:
    """An LB frontier (K1, K3): sizes >= 0; frontier ids in [-1, n), a
    live lane's (size > 0) in [0, n); a live lane's edges inside the
    column array (row_offsets[base] + size <= m)."""
    import torch
    if sizes.numel() == 0:
        return []
    out = [("out-of-bounds: a negative segment size", sizes.amin() >= 0),
           ("out-of-bounds: frontier ids outside [-1, n)",
            (base.amin() >= -1) & (base.amax().long() < n))]
    live = sizes > 0
    out.append(("out-of-bounds: a live lane's frontier id is -1",
                (base.masked_fill(~live, 0)).amin() >= 0))
    if n > 0:
        start = torch.index_select(row_offsets, 0,
                                   base.reshape(-1).clamp(0, n).long())
        end = torch.where(live.reshape(-1),
                          start.long() + sizes.reshape(-1).long(), 0)
        out.append((f"out-of-bounds: a live lane's edges pass the column "
                    f"array ({m:,} entries)", end.amax() <= m))
    return out


def delta_check(row_offsets, delta, anchor, n: int, m: int) -> list:
    """An escape-free anchored-delta stream (``core.storage``): column e
    of row r is anchor[r] + delta[e], every one in [0, n), and no delta
    is the escape sentinel 0xFFFF (a stream with escapes is decoded to
    its dense view before a kernel sees it)."""
    import torch
    if m == 0:
        return []
    escape = ("out-of-bounds: the delta stream holds an escape (0xFFFF), "
              "which the kernel would read as a delta",
              delta[:m].to(torch.int32).amax() < 0xFFFF)
    deg = (row_offsets[1:] - row_offsets[:-1]).long().clamp(min=0)
    rows = torch.repeat_interleave(
        torch.arange(deg.numel(), device=deg.device), deg)[:m]
    cols = (torch.index_select(anchor, 0, rows).long()
            + delta[:rows.numel()].long())
    if cols.numel() == 0:
        return [escape]
    return [escape,
            ("out-of-bounds: the delta stream decodes to column ids "
             "outside [0, n)", (cols.amin() >= 0) & (cols.amax() < n))]


def segments_check(hay, lo, hi, m: int) -> list:
    """K5: 0 <= lo <= hi <= m for every lane, and every segment
    hay[lo:hi) sorted ascending."""
    import torch
    if lo.numel() == 0:
        return []
    oks = []
    descent = None
    if m > 1:
        # descents before position j: a segment [lo, hi) is sorted iff no
        # descent lies in [lo, hi - 1)
        descent = torch.zeros((m,), dtype=torch.int32, device=hay.device)
        descent[1:] = torch.cumsum(hay[1:] < hay[:-1], 0, dtype=torch.int32)
    for s in range(0, lo.numel(), _CHUNK):
        l, h = lo[s:s + _CHUNK], hi[s:s + _CHUNK]
        bounds = (l.amin() >= 0) & (h.amax() <= m) & (l <= h).all()
        oks.append(("out-of-bounds: a K5 segment outside [0, m) or with "
                    "lo > hi", bounds))
        if descent is not None:
            span = h - l >= 2
            a = torch.index_select(descent, 0, l.clamp(0, m - 1).long())
            b = torch.index_select(descent, 0,
                                   (h - 1).clamp(0, m - 1).long())
            oks.append(("out-of-bounds: a K5 haystack segment is not "
                        "sorted", (~span | (b == a)).all()))
    return oks


def epoch_tagged(shift: int, bits: int = 30):
    """The invariant of a look-back word (``counters``, ``live_end``:
    the epoch at bit 32; ``status``: epoch << 2 | flag there, so the
    epoch at bit 34): every word carries an earlier epoch than the
    launch's ``epoch`` argument; one of this launch's epoch or a later
    one would read as written by this launch."""
    def invariant(name, t, a) -> list:
        if t.numel() == 0:
            return []
        tag = (t >> shift) & (2 ** bits - 1)
        return [(f"write-write race: a look-back {name} word already "
                 f"carries epoch >= {a['epoch']}", tag.amax() < a["epoch"])]
    return invariant


def filled(value: int):
    """The invariant of a table every launch leaves at ``value`` (K1's
    first-slot table: INT32_MAX between calls)."""
    def invariant(name, t, a) -> list:
        if t.numel() == 0:
            return []
        return [(f"write-write race: {name} holds another launch's "
                 f"writes", (t == value).all())]
    return invariant
