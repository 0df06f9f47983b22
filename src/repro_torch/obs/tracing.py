"""Host-side span tracing: phase timing as Chrome trace events
(counterpart of ``repro.obs.tracing``).

``obs.telemetry`` says what the BSP loop did each step; this module says
where the wall clock went — graph build, warmup, serving, validation —
as nested spans written as Chrome trace-event JSON (load the file at
ui.perfetto.dev or chrome://tracing).

  * ``span("warmup", category="compile", args={...})`` times its block
    with ``time.perf_counter_ns`` and records (name, category, start,
    duration, thread) into the ambient ``SpanRegistry``. Spans nest.
  * Fencing: kernels run asynchronously, so a span that should measure
    execution passes the tensors it waits for as ``sync=`` (a tensor or
    any nesting of tuples, lists, dicts, NamedTuples). Each CUDA device
    they lie on is synchronized inside the span, just before the end
    stamp; CPU tensors need no fence.
  * Every span is also a ``torch.profiler.record_function`` range, so a
    profile taken around a launch script carries the phase names.
  * ``export_chrome_trace(path)`` writes ``{"traceEvents": [...]}`` of
    complete ("ph": "X") events with microsecond timestamps.

Categories: "setup" (graph build; under a placement the partition and
the shard upload, spans "partition" and "shard"), "compile" (warmup:
the kernels' first launches), "dispatch" (a timed run), "validate",
"serve". The
registry is per process and cleared with ``reset()``, so a CLI writes
one file a run.
"""
from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch


@dataclass
class SpanEvent:
    name: str
    category: str
    start_ns: int
    duration_ns: int
    thread_id: int
    args: Dict[str, Any] = field(default_factory=dict)


@dataclass
class SpanRegistry:
    """Finished spans; appends are thread-safe."""

    events: List[SpanEvent] = field(default_factory=list)
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False)

    def add(self, ev: SpanEvent) -> None:
        with self._lock:
            self.events.append(ev)

    def reset(self) -> None:
        with self._lock:
            self.events.clear()

    def total_ns(self, name: str) -> int:
        return sum(e.duration_ns for e in self.events if e.name == name)

    def to_chrome(self) -> dict:
        """The Chrome trace-event JSON object."""
        pid = os.getpid()
        return {
            "displayTimeUnit": "ms",
            "traceEvents": [
                {"name": e.name, "cat": e.category, "ph": "X",
                 "pid": pid, "tid": e.thread_id,
                 "ts": e.start_ns / 1e3, "dur": e.duration_ns / 1e3,
                 "args": e.args}
                for e in self.events
            ],
        }


_registry = SpanRegistry()


def registry() -> SpanRegistry:
    """The per-process registry ``span()`` records into."""
    return _registry


def reset() -> None:
    _registry.reset()


def cuda_devices(tree) -> set:
    """The CUDA devices the tensors in ``tree`` lie on."""
    out: set = set()
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                out.add(x.device)
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
    return out


def fence(tree) -> None:
    """Wait for the work that produces the CUDA tensors in ``tree``."""
    for dev in cuda_devices(tree):
        torch.cuda.synchronize(dev)


@contextmanager
def span(name: str, category: str = "phase",
         args: Optional[Dict[str, Any]] = None, sync=None,
         into: Optional[SpanRegistry] = None):
    """Time a block as one span; ``sync`` holds the tensors fenced
    before the end stamp (see the module docstring)."""
    reg = into if into is not None else _registry
    with torch.profiler.record_function(name):
        t0 = time.perf_counter_ns()
        try:
            yield reg
        finally:
            if sync is not None:
                fence(sync)
            dur = time.perf_counter_ns() - t0
            reg.add(SpanEvent(name=name, category=category, start_ns=t0,
                              duration_ns=dur,
                              thread_id=threading.get_ident(),
                              args=dict(args or {})))


@contextmanager
def timed_span(name: str, **kw):
    """``span`` that also hands back its duration: yields a dict whose
    ``"ms"`` key is filled at exit."""
    out: Dict[str, float] = {}
    t0 = time.perf_counter_ns()
    with span(name, **kw):
        yield out
    out["ms"] = (time.perf_counter_ns() - t0) / 1e6


def export_chrome_trace(path: str,
                        reg: Optional[SpanRegistry] = None) -> int:
    """Write the registry as Chrome trace-event JSON; returns the event
    count (the CLIs log it, so an empty trace shows)."""
    reg = reg if reg is not None else _registry
    obj = reg.to_chrome()
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)
    return len(obj["traceEvents"])
