"""The traced run's device timeline: torch.profiler over the window,
reduced to busy time, device time by kernel, and the idle gaps named by
what the host was doing.

Busy time is the union of every device interval (kernels, copies,
memsets). A device operation is one of the program's own kernels when
its name is one of the ``__global__`` functions of the program's CUDA
sources, which are read from the program's ``csrc`` directory, so a
kernel a later change adds is known without an edit here.
"""
from __future__ import annotations

import bisect
import re
from collections import defaultdict
from pathlib import Path

import torch

_GLOBAL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")
NO_HOST_OP = "host: no traced op"
IN_PYTHON = "host: python inside serve_mixed, no op"
SPAN = "serve_mixed"          # the harness's span around each chunk


def program_kernels(csrc: Path) -> frozenset:
    """The names of the ``__global__`` functions of the CUDA sources."""
    names = set()
    for path in sorted(Path(csrc).glob("*.cu*")):
        names.update(_GLOBAL.findall(path.read_text()))
    return frozenset(names)


def base_name(name: str) -> str:
    """``void (anonymous namespace)::af_expand<256, X>(int const*, ...)``
    -> ``af_expand``."""
    head = name[5:] if name.startswith("void ") else name
    head = head.replace("(anonymous namespace)::", "")
    head = re.split(r"[<(]", head, maxsplit=1)[0].strip()
    return head.rsplit("::", 1)[-1]


def profile(device: torch.device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _events(prof):
    """(device events, host events) as (start_ns, end_ns, name). A
    record_function span also shows on the device's timeline as an
    annotation: that is no device work."""
    dev, host = [], []
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        item = (start, start + e.duration_ns(), e.name())
        if e.device_type() != cuda:
            host.append(item)
        elif e.name() != SPAN:
            dev.append(item)
    return dev, host


def _union(intervals):
    """Merged busy intervals of sorted (start, end, name) triples."""
    merged = []
    for s, e, _ in intervals:
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def _host_at(host, starts, spans, t):
    """The innermost host op running at time ``t``; else whether the
    host was inside one of the harness's spans."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - 256, -1), -1):
        s, e, name = host[j]
        if e >= t and name != SPAN:
            return name
    k = bisect.bisect_right(spans, (t, float("inf"))) - 1
    return IN_PYTHON if k >= 0 and spans[k][1] >= t else NO_HOST_OP


def summarize(prof, kernels: frozenset, top: int = 10) -> dict:
    """Busy seconds, device seconds by kernel base name, and the
    contract's breakdown lists, from a finished profile."""
    return summarize_events(*_events(prof), kernels, top)


def summarize_events(dev: list, host: list, kernels: frozenset,
                     top: int = 10) -> dict:
    """``summarize`` of (start_ns, end_ns, name) device and host
    events."""
    dev.sort()
    host.sort()
    by_name = defaultdict(float)
    by_base = defaultdict(float)
    count = defaultdict(int)
    for s, e, name in dev:
        base = base_name(name)
        by_name[name] += (e - s) * 1e-9
        by_base[base] += (e - s) * 1e-9
        count[base] += 1
    busy = _union(dev)
    busy_s = sum(e - s for s, e in busy) * 1e-9
    starts = [h[0] for h in host]
    spans = [(s, e) for s, e, name in host if name == SPAN]
    gaps = defaultdict(float)
    for (_, end), (nxt, _) in zip(busy, busy[1:]):
        gaps[_host_at(host, starts, spans, (end + nxt) // 2)] += (
            nxt - end) * 1e-9
    glue_s = sum(t for name, t in by_base.items()
                 if name not in kernels and _is_kernel(name))

    def topn(d):
        rows = sorted(d.items(), key=lambda kv: -kv[1])[:top]
        return [[k if len(k) <= 120 else k[:117] + "...", v] for k, v in rows]

    return {"busy_s": busy_s, "kernel_s": dict(by_base),
            "kernel_n": dict(count), "glue_s": glue_s,
            "device_ops": topn(by_name), "idle_gaps": topn(gaps)}


def _is_kernel(base: str) -> bool:
    """Copies and memsets are device work but no kernel."""
    return not base.startswith(("Memcpy", "Memset"))
