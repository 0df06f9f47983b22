"""The enactor: Gunrock's bulk-synchronous loop driver (counterpart of
``repro.core.enactor``).

The reference runs the whole loop on the device (``lax.while_loop``).
Here the loop is eager Python over device tensors, and each step makes
exactly ONE host read: a small packed int32 tensor holding every lane's
``cond`` flag plus whatever the step must decide on the host (a tier's
workload bound, per-lane directions). Everything else stays on the
device.

  run_until      — while cond(state) and it < max_iter: state = body(state)
  run_until_any  — the batched loop: iterate while any lane is active;
                   a lane whose cond was False entering a step keeps its
                   state bit for bit (frozen), and per-lane iteration
                   counts come back with the step count.
  select_lanes   — per-lane select over a state's tensors.
  tiered_step    — run one step at the smallest capacity tier holding
                   the step's workload. Results never depend on the tier.

Both loops take the reference's three options:
  probe, telemetry — ``probe(prev, new, params)`` maps a step's states
                   (and, in ``run_until_any``, the step's host parameters
                   from ``plan``) to a row of values, recorded into the
                   ``obs.telemetry.TelemetryBuffer`` at the step's index
                   by device-side writes: telemetry adds no host read.
                   The loop then returns the buffer as one more element.
  budget         — anything with ``cap_iters`` (an ``ft.Budget``)
                   lowers ``max_iter``; the state at the cap comes back
                   partial and the caller's ``cond`` tells which lanes
                   are. ``budget=None`` is the loop unchanged.
``host_reads()`` counts the loops' reads since ``reset_host_reads()``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence, TypeVar

import torch

from .frontier import tier_index

S = TypeVar("S")

_reads = 0


def host_reads() -> int:
    """Host reads the loops made since the last ``reset_host_reads``."""
    return _reads


def reset_host_reads() -> None:
    global _reads
    _reads = 0


def _read(t: torch.Tensor):
    global _reads
    _reads += 1
    return t.tolist()


def _guard(max_iter: int, probe, telemetry, budget) -> int:
    if probe is not None and telemetry is None:
        raise ValueError("probe= requires a telemetry buffer")
    return max_iter if budget is None else budget.cap_iters(max_iter)


def run_until(cond: Callable[[S], torch.Tensor], body: Callable[[S], S],
              state: S, max_iter: int, probe=None, telemetry=None,
              budget=None):
    """while (cond(state) and it < max_iter): state = body(state).
    Returns (final_state, iterations_run), plus the filled buffer with
    ``probe``; one host read per step."""
    max_iter = _guard(max_iter, probe, telemetry, budget)
    it = 0
    while it < max_iter and _read(cond(state)):
        new = body(state)
        if probe is not None:
            telemetry.record(**probe(state, new, []))
        state = new
        it += 1
    if probe is not None:
        return state, it, telemetry
    return state, it


def select_lanes(mask: torch.Tensor, on_true: S, on_false: S) -> S:
    """Per-lane select: ``mask`` (B,) broadcast against every tensor's
    leading batch axis, through NamedTuples and dataclasses."""
    if isinstance(on_true, torch.Tensor):
        m = mask.reshape(mask.shape + (1,) * (on_true.dim() - 1))
        return torch.where(m, on_true, on_false)
    if isinstance(on_true, tuple) and hasattr(on_true, "_fields"):
        return type(on_true)(*(select_lanes(mask, a, c)
                               for a, c in zip(on_true, on_false)))
    if dataclasses.is_dataclass(on_true):
        return dataclasses.replace(on_true, **{
            f.name: select_lanes(mask, getattr(on_true, f.name),
                                 getattr(on_false, f.name))
            for f in dataclasses.fields(on_true)})
    raise TypeError(f"cannot select lanes of {type(on_true).__name__}")


def run_until_any(cond: Callable[[S], torch.Tensor],
                  plan: Callable[[S], torch.Tensor],
                  body: Callable[[S, list, list], S],
                  state: S, max_iter: int, probe=None, telemetry=None,
                  budget=None):
    """Batched BSP loop: iterate while any lane of ``cond(state)`` holds.

    ``cond(state)`` is the (B,) bool of still-active lanes; ``plan(state)``
    a 1-D int32 tensor of step parameters for the host (may be empty).
    Both are read together, once per step, and ``body(state, active,
    params)`` gets them as Python lists. Lanes inactive entering a step
    are frozen. Returns (final_state, per_lane_iters (B,) list,
    iterations_run), plus the filled buffer with ``probe``: its rows
    record the lane-masked state, so a frozen lane repeats its values,
    and a lane's valid rows are its ``per_lane_iters``."""
    max_iter = _guard(max_iter, probe, telemetry, budget)
    it = 0
    lane_iters = None
    while True:
        flags = cond(state)
        b = int(flags.shape[0])
        host = _read(torch.cat([flags.to(torch.int32),
                                plan(state).to(torch.int32)]))
        active, params = host[:b], host[b:]
        if lane_iters is None:
            lane_iters = [0] * b
        if it >= max_iter or not any(active):
            if probe is not None:
                return state, lane_iters, it, telemetry
            return state, lane_iters, it
        new = body(state, active, params)
        if not all(active):
            new = select_lanes(flags, new, state)
        if probe is not None:
            telemetry.record(**probe(state, new, params))
        state = new
        lane_iters = [k + a for k, a in zip(lane_iters, active)]
        it += 1


def tiered_step(need: int, caps: Sequence[int],
                step_of: Callable[[int], Callable[[S], S]], state: S) -> S:
    """Run one step at the smallest tier of ``caps`` holding ``need``
    (a host int); ``step_of(cap)`` builds the step for one tier."""
    return step_of(caps[tier_index(need, tuple(caps))])(state)
