"""Shared fixtures of the benchmark's tests: a checkout-like root with a
tiny Kronecker configuration, built from the benchmark's own files."""
from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
for _p in (str(REPO / "src"), str(BENCH)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

SEED = 2 ** 31 + 977          # larger than 32 signed bits hold


def tiny_root(tmp: Path, scale: int = 7) -> Path:
    """``tmp`` as a checkout: the benchmark's generators, metrics and
    mixes, and BENCHMARK.json with the cells tiny.traverse and
    tiny.reach on a Kronecker graph of 2^scale vertices."""
    bench = tmp / "portbench"
    bench.mkdir(parents=True)
    for d in ("generators", "metrics", "traffic"):
        shutil.copytree(BENCH / d, bench / d)
    (bench / "configs").mkdir()
    cfg = json.loads((BENCH / "configs" / "graph500-22.json").read_text())
    cfg["params"]["scale"] = scale
    (bench / "configs" / "tiny.json").write_text(json.dumps(cfg))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    spec["configs"] = [{"name": "tiny", "source": "test",
                        "file": "portbench/configs/tiny.json",
                        "reduced": ["scale"], "why": "test"}]
    spec["workloads"] = [
        {"name": f"tiny.{mix}", "config": "tiny", "traffic": mix,
         "chips": 1, "why": "test"} for mix in ("traverse", "reach")]
    spec["per_layer"].append({"name": "roofline.reach", "unit": "%",
                              "better": "higher", "source": "device_trace",
                              "layer": "kernels", "moves": "qps",
                              "workloads": ["tiny.reach"]})
    for m in spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = ["tiny." + w.split(".", 1)[1]
                              for w in m["workloads"]]
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp


def run(root: Path, cell: str, traced: bool = False, seconds: float = 0.2,
        seed: int = SEED) -> dict:
    """One run of ``cell`` on the CPU, the harness's look for a card
    skipped."""
    from pb import cell as C
    from pb import spec
    return C.run_cell(spec.load_cell(root, cell), seed, seconds, traced,
                      "cpu", time.monotonic())
