"""BSP telemetry: preallocated per-step device columns (counterpart of
``repro.obs.telemetry``).

  * ``TelemetryBuffer`` is a dict of device columns of shape
    ``(capacity, *tail)`` plus a host cursor. The enactor loops
    (``run_until`` / ``run_until_any``, ``probe=``) record one row a
    step: row ``it`` (a host int) takes the probe's values — device
    tensors or host ints — by device-side writes, so recording adds no
    host read to a step and the enactor's one read a step holds. Writes
    past capacity are dropped while the cursor keeps the true step
    count; capacity is the loop's iteration bound, so the drop is a
    guard.
  * Probes only read: a probe maps (state before, state after, the
    step's host parameters) to values and feeds nothing back, so a run
    with telemetry gives the bits of a run without.
  * ``trim`` brings a buffer to the host as a ``TelemetryTrace`` — numpy
    columns cut to the recorded steps, with per-lane valid lengths for a
    batched loop — in one device-to-host copy a column dtype.

Columns: ``()`` tail for one value a step, ``(B,)`` for one a lane.
``distributed_trace`` builds a placement run's trace from the analytic
comm model and its result, as the reference's does.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch


class TelemetryBuffer:
    """Fixed-capacity per-step columns on one device and a host cursor."""

    def __init__(self, cursor: int, data: Dict[str, torch.Tensor]):
        self.cursor = int(cursor)
        self.data = data

    @classmethod
    def make(cls, capacity: int,
             spec: Mapping[str, Tuple[Tuple[int, ...], torch.dtype]],
             device) -> "TelemetryBuffer":
        """Zero-filled buffer for ``capacity`` steps on ``device``;
        ``spec`` maps a column name to ``(tail_shape, dtype)``."""
        capacity = max(int(capacity), 1)
        data = {name: torch.zeros((capacity,) + tuple(tail), dtype=dtype,
                                  device=device)
                for name, (tail, dtype) in spec.items()}
        return cls(0, data)

    @property
    def capacity(self) -> int:
        for col in self.data.values():
            return int(col.shape[0])
        return 0

    def record(self, **values) -> "TelemetryBuffer":
        """Write one row at the cursor (in place; returns the buffer).
        Unknown names raise; missing columns keep their zeros; a write
        past capacity is dropped, the cursor still counts it."""
        unknown = set(values) - set(self.data)
        if unknown:
            raise KeyError(f"telemetry columns not in spec: "
                           f"{sorted(unknown)}")
        i = self.cursor
        if i < self.capacity:
            for name, val in values.items():
                row = self.data[name][i]
                # a host number is a fill's argument and a tensor a
                # device copy: neither waits for the device
                if isinstance(val, torch.Tensor):
                    row.copy_(val)
                else:
                    row.fill_(val)
        self.cursor = i + 1
        return self


class TelemetryTrace:
    """A trimmed trajectory on the host: numpy columns over ``steps``
    BSP iterations, optionally with per-lane valid lengths.

    ``columns[name]`` is ``(steps,)`` or ``(steps, B)``; entries of a
    per-lane column past ``lane_steps[b]`` repeat the frozen lane."""

    def __init__(self, columns: Dict[str, np.ndarray], steps: int,
                 lane_steps: Optional[np.ndarray] = None):
        self.steps = int(steps)
        self.columns = {k: np.asarray(v) for k, v in columns.items()}
        self.lane_steps = (None if lane_steps is None
                           else np.asarray(lane_steps))

    def __getitem__(self, name: str) -> np.ndarray:
        return self.columns[name]

    def __contains__(self, name: str) -> bool:
        return name in self.columns

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(sorted(self.columns))

    def lane(self, b: int) -> "TelemetryTrace":
        """Lane ``b``'s trajectory, cut to its own iteration count."""
        steps = (self.steps if self.lane_steps is None
                 else int(self.lane_steps[b]))
        cols = {k: (v[:steps, b] if v.ndim > 1 else v[:steps])
                for k, v in self.columns.items()}
        return TelemetryTrace(cols, steps)

    def format_table(self, columns: Optional[Tuple[str, ...]] = None,
                     prefix: str = "") -> str:
        """Fixed-width per-iteration table; ``direction`` renders
        push/pull; a per-lane column shows lane 0."""
        names = list(columns) if columns else list(self.names)
        names = [n for n in names if n in self.columns]
        widths = {n: max(len(n), 9) for n in names}
        lines = [prefix + "iter  " + "  ".join(
            f"{n:>{widths[n]}s}" for n in names)]
        for it in range(self.steps):
            cells = []
            for n in names:
                col = self.columns[n]
                v = col[it, 0] if col.ndim > 1 else col[it]
                if n == "direction":
                    v = "pull" if int(v) else "push"
                cells.append(f"{v:>{widths[n]}}")
            lines.append(prefix + f"{it + 1:4d}  " + "  ".join(cells))
        return "\n".join(lines)


def trim(buf: TelemetryBuffer, lane_steps=None) -> TelemetryTrace:
    """Device buffer → host trace cut to ``min(cursor, capacity)`` rows,
    in one copy a column dtype (every column the primitives record is
    int32): the used rows are packed into one tensor on the device
    first. ``lane_steps`` are a batched loop's per-lane iteration
    counts."""
    steps = min(buf.cursor, buf.capacity)
    groups: Dict[torch.dtype, list] = {}
    for k, col in buf.data.items():
        groups.setdefault(col.dtype, []).append(k)
    cols: Dict[str, np.ndarray] = {}
    for names in groups.values():
        parts = [buf.data[k][:steps] for k in names]
        flat = torch.cat([p.reshape(-1) for p in parts]).cpu().numpy()
        at = 0
        for k, p in zip(names, parts):
            cols[k] = flat[at:at + p.numel()].reshape(tuple(p.shape))
            at += p.numel()
    if lane_steps is not None and isinstance(lane_steps, torch.Tensor):
        lane_steps = lane_steps.cpu().numpy()
    return TelemetryTrace(cols, steps,
                          None if lane_steps is None
                          else np.asarray(lane_steps))


def distributed_trace(pg, primitive: str, iterations, labels=None,
                      tiles: Optional[int] = None) -> TelemetryTrace:
    """The trace of a distributed (sharded / 2d) run, from the analytic
    comm model rather than in-loop records: ``exchange_bytes`` is the
    per-device bytes each BSP step moved
    (``core.distributed.exchange_bytes_per_step``, constant a step: the
    bitmask and vector exchanges are dense), and for BFS the per-step
    ``frontier`` column comes exactly from the result labels (step t
    discovers depth t)."""
    from ..core import distributed as D
    steps = max(int(iterations), 0)
    kwargs = {} if tiles is None else {"tiles": tiles}
    per_step = D.exchange_bytes_per_step(pg, primitive, **kwargs)
    cols: Dict[str, np.ndarray] = {
        "exchange_bytes": np.full((steps,), per_step, np.int64)}
    if labels is not None and primitive == "bfs":
        lab = (labels.cpu().numpy() if isinstance(labels, torch.Tensor)
               else np.asarray(labels)).reshape(-1)
        depth_counts = np.bincount(lab[lab >= 0], minlength=steps + 1)
        # step t (1-based) discovers depth t; the last step discovers
        # nothing (that is how the loop ends)
        frontier = np.zeros((steps,), np.int64)
        upto = min(steps, len(depth_counts) - 1)
        frontier[:upto] = depth_counts[1:upto + 1]
        cols["frontier"] = frontier
    return TelemetryTrace(cols, steps)
