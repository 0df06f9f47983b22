"""Elastic, restartable training loop (counterpart of
``repro.ft.elastic``).

``RestartableTrainer.run`` executes a step function in a crash-tolerant
loop: checkpoints every ``ckpt_every`` steps, and on an injected
``FailAt`` (the fault the tests and the launcher's
``--simulate-failure`` raise) it restores the latest checkpoint —
possibly under a different mesh, since checkpoints are mesh-agnostic
(``ckpt/checkpoint.py``).
"""
from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from ..ckpt import latest_step, restore_checkpoint, save_checkpoint
from ..kernels.runtime import resolve_device
from .health import StepWatchdog

log = logging.getLogger("repro_torch.ft")


class FailAt(Exception):
    """Injected failure for fault-tolerance tests/examples."""


@dataclass
class RestartableTrainer:
    ckpt_dir: str
    ckpt_every: int = 50
    max_restarts: int = 3
    device: Optional[object] = None     # restored state's home; None: card

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def _fence(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, *, init_state: Callable[[], tuple],
            step_fn: Callable, data_state: Callable[[], dict],
            restore_data: Callable[[dict], None], total_steps: int,
            fail_at: Optional[int] = None,
            mesh=None, spec_tree=None) -> dict:
        """init_state() -> state; step_fn(state, step) -> (state,
        metrics). Returns the run report."""
        restarts = 0
        watchdog = StepWatchdog()
        history = []

        while True:
            try:
                state = init_state()
                start = 0
                last = latest_step(self.ckpt_dir)
                if last is not None:
                    state, extra = restore_checkpoint(
                        self.ckpt_dir, last, state, mesh=mesh,
                        spec_tree=spec_tree, device=self.device)
                    restore_data(extra.get("data", {"step": last,
                                                    "seed": 0}))
                    start = last
                    log.info("resumed from step %d", last)
                for step in range(start, total_steps):
                    if fail_at is not None and step == fail_at \
                            and restarts == 0:
                        raise FailAt(f"injected failure at step {step}")
                    watchdog.start(step)
                    state, metrics = step_fn(state, step)
                    self._fence()
                    dt = watchdog.stop()
                    history.append({"step": step, "dt": dt,
                                    **{k: float(v) for k, v
                                       in metrics.items()}})
                    if (step + 1) % self.ckpt_every == 0 \
                            or step + 1 == total_steps:
                        save_checkpoint(self.ckpt_dir, step + 1, state,
                                        extra={"data": data_state()})
                return {"completed": True, "restarts": restarts,
                        "history": history,
                        "stragglers": watchdog.stragglers}
            except FailAt as e:
                restarts += 1
                log.warning("failure: %s — restart %d", e, restarts)
                if restarts > self.max_restarts:
                    return {"completed": False, "restarts": restarts,
                            "history": history,
                            "stragglers": watchdog.stragglers}
                continue
