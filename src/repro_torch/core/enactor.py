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
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence, TypeVar

import torch

from .frontier import tier_index

S = TypeVar("S")


def run_until(cond: Callable[[S], torch.Tensor], body: Callable[[S], S],
              state: S, max_iter: int) -> tuple[S, int]:
    """while (cond(state) and it < max_iter): state = body(state).
    Returns (final_state, iterations_run); one host read per step."""
    it = 0
    while it < max_iter and bool(cond(state)):
        state = body(state)
        it += 1
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
                  state: S, max_iter: int):
    """Batched BSP loop: iterate while any lane of ``cond(state)`` holds.

    ``cond(state)`` is the (B,) bool of still-active lanes; ``plan(state)``
    a 1-D int32 tensor of step parameters for the host (may be empty).
    Both are read together, once per step, and ``body(state, active,
    params)`` gets them as Python lists. Lanes inactive entering a step
    are frozen. Returns (final_state, per_lane_iters (B,) list,
    iterations_run)."""
    it = 0
    lane_iters = None
    while True:
        flags = cond(state)
        b = int(flags.shape[0])
        host = torch.cat([flags.to(torch.int32),
                          plan(state).to(torch.int32)]).tolist()
        active, params = host[:b], host[b:]
        if lane_iters is None:
            lane_iters = [0] * b
        if it >= max_iter or not any(active):
            return state, lane_iters, it
        new = body(state, active, params)
        if not all(active):
            new = select_lanes(flags, new, state)
        state = new
        lane_iters = [k + a for k, a in zip(lane_iters, active)]
        it += 1


def tiered_step(need: int, caps: Sequence[int],
                step_of: Callable[[int], Callable[[S], S]], state: S) -> S:
    """Run one step at the smallest tier of ``caps`` holding ``need``
    (a host int); ``step_of(cap)`` builds the step for one tier."""
    return step_of(caps[tier_index(need, tuple(caps))])(state)
