"""Kernel autotuner: measured threads per block for each (op, tier,
platform, encoding) (counterpart of ``repro.kernels.tuner``).

A tile on the card is the number of threads in one CUDA block. Each
block of the one-thread-per-slot kernels (K1, K2, K3, K5, K6) covers
that many output slots; each block of K4's warp-per-row SpMV covers
tile / 32 rows. The choice never changes a result — every block size
computes the same outputs — so a stale or missing cache costs time,
never correctness.

  * ``tile_for(op, cap)`` — the lookup every tuned kernel wrapper makes
    at each launch. A measured entry for (op, tier(cap), platform,
    encoding) wins, a dense entry at the same tier stands in for an
    unmeasured delta launch, and otherwise ``default_tile``.
  * ``autotune(op, cap)`` — measure every candidate tile with the op's
    registered probe (``kernels.ops`` registers them) and persist the
    winner. It runs only when called: the CLI
    (``python -m repro_torch.kernels.tuner``) and ``chip_smoke.py``
    drive it, never a kernel wrapper.

Cache format (JSON, the reference's version 2)::

    {"version": 2,
     "entries": {"<op>|<tier>|<platform>|<encoding>": {"tile": 256,
                                                       "ms": 0.01, ...}}}

``tier`` is the power-of-two bucket of the capacity, ``platform`` is
``runtime.platform()`` (the card's compute capability and name), and
``encoding`` is the column storage format the launch read: ``dense``, or
``delta`` for K1's and K3's in-kernel decode of an anchored-delta stream
(the advance probes take ``encoding=`` and are measured under both).
Other versions are ignored, never deleted.

The cache is explicit: ``set_cache(path)`` points the tuner at a file,
``set_cache(None)`` — the default — ignores every cache (heuristic
only). The entries are read once into memory and read
again only on ``set_cache``; ``autotune`` updates them in memory and on
disk, so a launch's lookup is a dictionary access.

``default_tile`` is the launch geometry the kernels had before the
tuner, 256 threads (``kThreads`` in ``csrc/common.cuh``); an op listed
in ``OP_DEFAULT_TILES`` (K4's ``spmv``: 128) launches its own. The
reference's heuristic doubles its tile until a grid of at most
``MAX_GRID`` steps covers the capacity, which models a TPU running its
grid in order on one core; the card runs its blocks in parallel over
132 SMs, where more, smaller blocks cost nothing of the kind, so that
heuristic is not carried over.
"""
from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Callable, Dict, Optional

_VERSION = 2

DEFAULT_MIN_TILE = 512          # the tier ladder's floor (frontier.MIN_TIER)
DEFAULT_TILE = 256              # kThreads: 8 warps per block
MIN_THREADS = 64
MAX_THREADS = 1024              # the card's limit of threads per block
DEFAULT_CAPS = (512, 2048, 8192, 32768, 131072)
# untuned launch geometry of the ops whose kernel measured best at
# another size: K4 gives each very heavy row a block whose one folding
# thread holds the block's SM slots, so smaller blocks leave more of the
# SM to the rest of the grid (128 threads beat 256 by 7 % on one
# PageRank sweep at rmat scale 22, H100; PERF.md, PR 15)
OP_DEFAULT_TILES = {"spmv": 128}

# op -> probe(cap, tile) -> seconds, registered by kernels.ops
PROBES: Dict[str, Callable[[int, int], float]] = {}

_path: Optional[Path] = None
_entries: Optional[dict] = None


def set_cache(path) -> None:
    """Point the tuner at the cache file ``path``, or ignore every cache
    with ``None``; the entries are read again at the next lookup."""
    global _path, _entries
    _path = None if path is None else Path(path)
    _entries = None


def cache_path() -> Optional[Path]:
    return _path


def _load() -> dict:
    global _entries
    if _entries is None:
        raw = {}
        if _path is not None:
            try:
                raw = json.loads(_path.read_text())
            except (OSError, ValueError):
                raw = {}
        entries = raw.get("entries") if isinstance(raw, dict) else None
        ok = (isinstance(raw, dict) and raw.get("version") == _VERSION
              and isinstance(entries, dict))
        _entries = dict(entries) if ok else {}
    return _entries


def _persist() -> None:
    tmp = _path.with_name(f"{_path.name}.tmp.{os.getpid()}")
    tmp.write_text(json.dumps({"version": _VERSION, "entries": _entries},
                              indent=1, sort_keys=True))
    os.replace(tmp, _path)


def pow2_ceil(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


def tier_of(cap: int, min_tile: int = DEFAULT_MIN_TILE) -> int:
    """Power-of-two bucket a capacity falls in: the cache key's tier
    axis and the capacity ladder's rung (core.backend.tier_plan)."""
    return max(min(pow2_ceil(max(cap, 1)), 1 << 30), min_tile)


def _key(op: str, cap: int, platform: str, min_tile: int,
         encoding: str = "dense") -> str:
    return f"{op}|{tier_of(cap, min_tile)}|{platform}|{encoding}"


def default_tile(cap: int = 0) -> int:
    """The untuned launch geometry: 256 threads per block at every
    capacity, the kernels' geometry before the tuner."""
    del cap
    return DEFAULT_TILE


def candidates(cap: int) -> list[int]:
    """Block sizes worth measuring at ``cap``: the powers of two from 64
    to min(1024, pow2_ceil(cap))."""
    hi = min(MAX_THREADS, max(pow2_ceil(max(cap, 1)), MIN_THREADS))
    out, t = [], MIN_THREADS
    while t <= hi:
        out.append(t)
        t *= 2
    return out


def _valid(tile) -> bool:
    return (isinstance(tile, int) and MIN_THREADS <= tile <= MAX_THREADS
            and tile & (tile - 1) == 0)


def tile_for(op: str, cap: int, *, encoding: str = "dense",
             device=None) -> int:
    """Threads per block for one launch of ``op`` at capacity ``cap`` on
    ``device``. A measured entry wins (clamped to the candidates of
    ``cap``); a dense entry at the same tier is the second choice for a
    delta launch; else the op's ``OP_DEFAULT_TILES`` entry, or
    ``default_tile``."""
    entries = _load()
    if entries:
        from . import runtime
        plat = runtime.platform(device)
        entry = entries.get(_key(op, cap, plat, DEFAULT_MIN_TILE, encoding))
        if entry is None and encoding != "dense":
            entry = entries.get(_key(op, cap, plat, DEFAULT_MIN_TILE))
        tile = entry.get("tile") if isinstance(entry, dict) else None
        if _valid(tile):
            return max(min(tile, pow2_ceil(max(cap, 1))), MIN_THREADS)
    return OP_DEFAULT_TILES.get(op, default_tile(cap))


def tier_floor(op: str, default: int = DEFAULT_MIN_TILE,
               device=None) -> int:
    """Floor of ``op``'s capacity ladder (core.backend.tier_plan): the
    measured tile at the bottom tier when one exists — unclamped, unlike
    ``tile_for`` — so no tier is smaller than one block; else
    ``default``."""
    entries = _load()
    if entries:
        from . import runtime
        entry = entries.get(_key(op, default, runtime.platform(device),
                                 default))
        tile = entry.get("tile") if isinstance(entry, dict) else None
        if _valid(tile):
            return max(tile, default)
    return default


def register_probe(op: str, fn: Callable[[int, int], float]) -> None:
    """Register ``fn(cap, tile) -> seconds`` as ``op``'s probe."""
    PROBES[op] = fn


def _takes_encoding(probe: Callable) -> bool:
    import inspect
    return "encoding" in inspect.signature(probe).parameters


def autotune(op: str, cap: int, probe: Optional[Callable] = None, *,
             repeats: int = 3, force: bool = False, device=None,
             encoding: str = "dense") -> int:
    """Measure every candidate tile of ``op`` at ``cap`` (one warm-up
    call, then the best of ``repeats``) and persist the winner under
    (op, tier, platform, encoding); a probe that models the storage
    encoding is given it. An existing entry is kept unless ``force``.
    Returns the selected tile."""
    from . import runtime
    probe = probe or PROBES.get(op)
    if probe is None:
        raise KeyError(f"no tuning probe registered for op {op!r}")
    if _path is None:
        raise ValueError("autotune needs a cache file: call "
                         "set_cache(path) first")
    entries = _load()
    key = _key(op, cap, runtime.platform(device), DEFAULT_MIN_TILE,
               encoding)
    if not force and _valid((entries.get(key) or {}).get("tile")):
        return int(entries[key]["tile"])
    kw = {"encoding": encoding} if _takes_encoding(probe) else {}
    best_tile, best_s = None, float("inf")
    for tile in candidates(cap):
        probe(cap, tile, **kw)                    # warm-up
        s = min(probe(cap, tile, **kw) for _ in range(repeats))
        if s < best_s:
            best_tile, best_s = tile, s
    entries[key] = {"tile": int(best_tile), "ms": best_s * 1e3,
                    "cap": int(cap), "stamp": time.strftime("%Y-%m-%d")}
    _persist()
    return best_tile


def autotune_all(caps=DEFAULT_CAPS, ops=None, force: bool = True,
                 device=None) -> dict:
    """Tune every registered probe (or ``ops``) over ``caps``, a probe
    that models the storage encoding once per encoding (dense, delta).
    Returns {(op, cap, encoding): tile}; each pick's time is in the
    cache."""
    picked = {}
    for op in (ops or sorted(PROBES)):
        encodings = (("dense", "delta") if _takes_encoding(PROBES[op])
                     else ("dense",))
        for cap in caps:
            for enc in encodings:
                picked[(op, cap, enc)] = autotune(op, cap, force=force,
                                                  device=device,
                                                  encoding=enc)
    return picked


def entry(op: str, cap: int, device=None,
          encoding: str = "dense") -> Optional[dict]:
    """The cache entry ``tile_for`` reads for a launch of ``encoding``,
    or None."""
    from . import runtime
    return _load().get(_key(op, cap, runtime.platform(device),
                            DEFAULT_MIN_TILE, encoding))


def main(argv=None) -> None:
    import argparse
    ap = argparse.ArgumentParser(
        description="measure the kernels' threads per block on the card")
    ap.add_argument("--ops", default=None,
                    help="comma-separated op subset (default: every probe)")
    ap.add_argument("--caps", default=",".join(map(str, DEFAULT_CAPS)),
                    help="comma-separated capacities to tune at")
    ap.add_argument("--cache", required=True,
                    help="cache file to write")
    args = ap.parse_args(argv)
    from . import ops  # noqa: F401  (registers the probes)
    set_cache(args.cache)
    caps = [int(c) for c in args.caps.split(",")]
    picked = autotune_all(caps, args.ops.split(",") if args.ops else None)
    for (op, cap, enc), tile in sorted(picked.items()):
        # reprolint: disable=RL005 -- CLI output channel
        print(f"{op:16s} cap={cap:<8d} {enc:5s} -> tile {tile:4d} "
              f"({entry(op, cap, encoding=enc)['ms']:.4f} ms)")
    # reprolint: disable=RL005 -- CLI output channel
    print(f"cache: {cache_path()}")


if __name__ == "__main__":
    # run in the package's module, where kernels.ops registers the probes
    # (``python -m`` runs this file as a second module, ``__main__``)
    from repro_torch.kernels import tuner as _tuner
    _tuner.main()
