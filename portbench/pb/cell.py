"""One run of one cell: set-up, the measured window, the check, the
result line.

  1. set-up (``setup_s``, from the process's start): the configuration's
     generator draws the edge list on the device from the seed; the
     program builds its graph from the host copy of those arrays through
     ``repro_torch.core.graph.from_edge_list`` (``build_s``); one chunk
     of the mix is served to warm every kernel and cache the window
     uses;
  2. the window: chunks of the mix through ``serve_mixed`` for
     ``seconds`` (with ``trace``, under torch.profiler and the roofline
     readers' counting wrappers);
  3. the peak memory is read, the program's graph freed, and the kept
     answers compared with the plain reference;
  4. every metric of the cell is read by its reader from one record.
"""
from __future__ import annotations

import contextlib
import gc
import json
import sys
import time

import torch

from reference import traversal as reference

from . import check, loop, roofline, spec, trace


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _device_info(dev: torch.device, peak: int) -> dict:
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": 1, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0}


def draw_graph(cell: spec.Cell, seed: int, dev: torch.device) -> dict:
    """The cell's edge list from the seed, as host arrays, with the
    vertices a query may start from (degree >= 1, self loops not
    counted)."""
    gen = spec.generator(cell.root, cell.config["generator"])
    e = gen.edges(cell.config["params"], seed, dev)
    n = int(e["n"])
    keep = e["src"] != e["dst"]
    deg = (torch.bincount(e["src"][keep], minlength=n)
           + torch.bincount(e["dst"][keep], minlength=n))
    eligible = torch.nonzero(deg > 0).reshape(-1).cpu().numpy()
    return {"n": n, "src": e["src"].cpu().numpy(),
            "dst": e["dst"].cpu().numpy(),
            "weight": e["weight"].cpu().numpy(), "eligible": eligible}


def reference_answers(graph: dict, dev: torch.device, rounds_short=0):
    """``answer(kind, source, hops)`` of the plain reference, built from
    the benchmark's own edge arrays on ``dev``."""
    edges = reference.undirected(torch.from_numpy(graph["src"]).to(dev),
                                 torch.from_numpy(graph["dst"]).to(dev),
                                 torch.from_numpy(graph["weight"]).to(dev),
                                 graph["n"])

    def answer(kind, source, hops):
        return reference.answer(kind, edges, int(source), hops,
                                rounds_short).cpu().numpy()

    return answer


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool,
             device: str, t_start: float) -> dict:
    """The result object of one run (the contract's keys, ``checks``
    last)."""
    from repro_torch.core import backend as B
    from repro_torch.core import enactor
    from repro_torch.core.graph import from_edge_list
    from repro_torch.kernels import runtime
    from repro_torch.launch import graph_serve as gs

    dev = torch.device(device)
    mix = cell.mix
    loop.check_mix(mix)
    hops = int(mix.get("hops", 3))

    graph = draw_graph(cell, seed, dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.monotonic()
    g = from_edge_list(graph["src"], graph["dst"], n=graph["n"],
                       values=graph["weight"], undirected=True, device=dev)
    _sync(dev)
    build_s = time.monotonic() - t0
    backend = B.resolve(None, dev)
    warm = loop.Traffic(mix, graph["eligible"], seed, stream=1)
    loop.serve(gs, g, warm.chunk(), mix, backend)
    _sync(dev)
    setup_s = time.monotonic() - t_start

    wanted = cell.per_layer if traced else cell.end_to_end
    readers = spec.readers(cell.root, wanted)
    wraps = {}
    for r in readers.values():
        wraps.update(getattr(r, "WRAP", {}))
    sample = check.Reservoir(mix["sample"], seed)
    traffic = loop.Traffic(mix, graph["eligible"], seed, stream=2)
    reads0 = enactor.host_reads()
    prof = None
    with contextlib.ExitStack() as stack:
        span = contextlib.nullcontext
        if traced:
            calls = stack.enter_context(roofline.counting(wraps))
            prof = stack.enter_context(trace.profile(dev))
            span = lambda: torch.profiler.record_function(trace.SPAN)  # noqa: E731
        out = loop.window(gs, g, traffic, mix, backend, seconds,
                          sample.offer, span)
        _sync(dev)
    host_reads = enactor.host_reads() - reads0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del g
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    rec = {"setup_s": setup_s, "build_s": build_s,
           "window_s": out["window_s"], "records": out["records"],
           "flushes": out["flushes"], "host_reads": host_reads}
    if traced:
        rec.update(trace.summarize(prof, trace.program_kernels(
            runtime.CSRC)))
        rec["calls"] = calls
    del prof

    t_ref = time.monotonic()
    answer = reference_answers(graph, dev)
    checks, wrong = check.compare(sample.kept, answer, hops)
    rec["reference_s"] = time.monotonic() - t_ref
    not_ok = sum(r["status"] != "ok" for r in out["records"])
    checks["queries_not_ok"] = {"value": not_ok, "max": 0}
    checks["answers_unmatched"] = {"value": out["unmatched"], "max": 0}

    print("phases: " + " ".join(
        f"{k}={rec[k]:.3f}" for k in ("setup_s", "build_s", "window_s",
                                      "reference_s")), file=sys.stderr)
    if traced:
        print(f"trace: launches {json.dumps(rec['kernel_n'])}; calls "
              f"{json.dumps({k: len(v) for k, v in calls.items()})}",
              file=sys.stderr)
    metrics = {}
    for m in wanted:
        value = readers[m["name"]].read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device_info = _device_info(dev, peak)
    result = {"correct": check.passed(checks),
              "attempted": len(out["records"]),
              "failed": not_ok + wrong, "metrics": metrics,
              "device": device_info}
    if traced:
        device_info.update(busy_s=rec["busy_s"], window_s=rec["window_s"])
        result["breakdown"] = {"device_ops": rec["device_ops"],
                               "idle_gaps": rec["idle_gaps"]}
    result["checks"] = checks
    return result
