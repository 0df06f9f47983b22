"""What a cell is made of, read from files found by name.

``BENCHMARK.json`` at the checkout's root names the cells; everything
that belongs to one configuration, traffic mix, generator or per-layer
metric is a file of its own under ``portbench/``:

  configs/<config>.json      (the path BENCHMARK.json gives)
  traffic/<mix>.json
  generators/<generator>.py  defines ``edges(params, seed, device)``
  metrics/<metric>.py        defines ``read(rec)``; optionally ``WRAP``
                             (kernel op -> counting function) and
                             ``KERNELS`` (device kernel names it times)

so a later cell, mix or metric is added by adding files.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

BENCH_DIR = "portbench"


@dataclass
class Cell:
    name: str
    root: Path
    chips: int
    config: dict
    mix: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)


def _listed(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, workload: str) -> Cell:
    """The cell ``workload`` of ``root``'s BENCHMARK.json, with its
    configuration, mix and metrics (raises KeyError for an unknown
    cell)."""
    root = Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"have {sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    mix = json.loads((root / BENCH_DIR / "traffic" /
                      f"{w['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _listed(m, workload)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if _listed(m, workload) and m["moves"] in reported]
    return Cell(name=workload, root=root, chips=int(w["chips"]),
                config=config, mix=mix, end_to_end=e2e, per_layer=layer)


def load_module(path: Path, name: str):
    """A Python file of the benchmark, loaded by its path."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def generator(root: Path, name: str):
    return load_module(Path(root) / BENCH_DIR / "generators" / f"{name}.py",
                       f"portbench_generator_{name}")


def readers(root: Path, metrics: list) -> dict:
    """metric name -> its reader module, for each metric entry."""
    return {m["name"]: load_module(
        Path(root) / BENCH_DIR / "metrics" / f"{m['name']}.py",
        "portbench_metric_" + m["name"].replace(".", "_"))
        for m in metrics}
