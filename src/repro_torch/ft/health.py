"""Health monitoring: a device liveness probe and a straggler watchdog
(counterpart of ``repro.ft.health``).

``check_devices`` runs a tiny reduction on each CUDA device (the CPU when
there is none) in a worker thread and waits at most ``timeout_s`` for
it: a hung card fails the probe instead of hanging the caller.
``StepWatchdog`` flags a step whose wall time passes a multiple of the
running median; it is host-only, and its caller fences the device
before ``stop()``.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Optional

import torch


def _probe(device: torch.device, out: dict) -> None:
    try:
        x = torch.ones((8,), dtype=torch.float32, device=device)
        out["ok"] = float(x.sum()) == 8.0        # the host copy fences
    except Exception as exc:                     # reported, not raised
        out["error"] = f"{type(exc).__name__}: {exc}"


def check_devices(timeout_s: float = 30.0) -> dict:
    """{device name: healthy} for every CUDA device (the CPU when there
    is none)."""
    devices = ([torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
               if torch.cuda.is_available() else [torch.device("cpu")])
    report = {}
    for dev in devices:
        out: dict = {}
        worker = threading.Thread(target=_probe, args=(dev, out),
                                  daemon=True)
        worker.start()
        worker.join(timeout_s)
        report[str(dev)] = bool(out.get("ok")) and not worker.is_alive()
    return report


class StepWatchdog:
    """Flags straggler steps: wall time > threshold × running median."""

    def __init__(self, window: int = 32, threshold: float = 2.0,
                 on_straggler: Optional[Callable[[int, float, float],
                                                 None]] = None):
        self.times = deque(maxlen=window)
        self.threshold = threshold
        self.on_straggler = on_straggler
        self.stragglers = []
        self._t0 = None
        self._step = 0

    def start(self, step: int):
        self._step = step
        self._t0 = time.monotonic()

    def stop(self) -> float:
        # reprolint: disable=RL004 -- the caller fences the step first
        dt = time.monotonic() - self._t0
        med = self.median()
        if med is not None and dt > self.threshold * med:
            self.stragglers.append((self._step, dt, med))
            if self.on_straggler:
                self.on_straggler(self._step, dt, med)
        self.times.append(dt)
        return dt

    def median(self):
        if len(self.times) < 4:
            return None
        s = sorted(self.times)
        return s[len(s) // 2]
