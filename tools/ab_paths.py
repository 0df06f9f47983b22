"""Warm A/B of graph_run's single-source sssp, bfs_batch, cc, bc_batch
and pagerank (20 sweeps) between two checkouts of this repo on one card.

  python tools/ab_paths.py BASE_DIR [--pairs 20] [--scale 22]

BASE_DIR is another checkout (for example the parent commit, unpacked
with ``git archive``). One worker process per tree imports that tree's
``repro_torch`` (``PYTHONPATH=<tree>/src``), builds
``rmat(scale, 16, seed=0, weighted)`` and runs every path once to warm
it (printed as "warm-up"). The two workers build at once and then
take turns: every pair times each path through
``launch.graph_run.run_primitive`` on both trees, base first in even
pairs and change first in odd ones, one worker at a time. sssp starts
at the max-degree vertex, bfs_batch and bc_batch at it and three random
non-isolated vertices (seed 0), the sources ``chip_smoke.py`` uses.
Prints every run, then per path the median of each tree and the median
of the change-minus-base differences within a pair.
"""
from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
PATHS = ("sssp", "bfs_batch", "cc", "bc_batch", "pagerank")


def worker(scale: int) -> None:
    """Build the graph, warm every path, then time the path named on each
    line of standard input and answer with its milliseconds."""
    import numpy as np
    import torch
    from repro_torch.launch import graph_run as gr

    print(f"worker: {gr.__file__}", file=sys.stderr, flush=True)
    dev = torch.device("cuda")
    g = gr.make_graph("rmat", scale, 16, 0, device=dev)
    deg = np.diff(g.row_offsets.cpu().numpy())
    hub = int(np.argsort(-deg, kind="stable")[0])
    rng = np.random.default_rng(0)
    srcs = [hub] + [int(v) for v in rng.choice(np.flatnonzero(deg > 0), 3,
                                               replace=False)]
    run = {"sssp": lambda: gr.run_primitive("sssp", g, hub, False, "cuda"),
           "bfs_batch": lambda: gr.run_primitive("bfs", g, hub, False,
                                                 "cuda", sources=srcs),
           "cc": lambda: gr.run_primitive("cc", g, hub, False, "cuda"),
           "bc_batch": lambda: gr.run_primitive("bc", g, hub, False, "cuda",
                                                sources=srcs),
           "pagerank": lambda: gr.run_primitive("pagerank", g, hub, False,
                                                "cuda")}
    print(" ".join(f"{run[p]()[0] * 1e3:.3f}" for p in PATHS), flush=True)
    for line in sys.stdin:
        print(f"{run[line.strip()]()[0] * 1e3:.3f}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("base", type=Path, nargs="?")
    ap.add_argument("--pairs", type=int, default=20)
    ap.add_argument("--scale", type=int, default=22)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        worker(args.scale)
        return 0
    if args.base is None:
        ap.error("BASE_DIR is required")
    procs = {}
    for label, root in (("base", args.base), ("change", HERE)):
        env = dict(os.environ, PYTHONPATH=str(root.resolve() / "src"))
        procs[label] = subprocess.Popen(
            [sys.executable, __file__, "--worker", "--scale",
             str(args.scale)], stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            text=True, env=env, cwd=root)
    try:
        for label, p in procs.items():
            warm = p.stdout.readline().split()
            if len(warm) != len(PATHS):
                raise SystemExit(f"{label} worker failed")
            for name, ms in zip(PATHS, warm):
                print(f"warm-up {label:6s} {name:9s} {ms:>9s} ms",
                      flush=True)
        runs = {(t, p): [] for t in procs for p in PATHS}
        for i in range(args.pairs):
            order = ("base", "change") if i % 2 == 0 else ("change", "base")
            for name in PATHS:
                for label in order:
                    p = procs[label]
                    p.stdin.write(name + "\n")
                    p.stdin.flush()
                    ms = float(p.stdout.readline())
                    runs[(label, name)].append(ms)
                    print(f"pair {i:2d} {label:6s} {name:9s} {ms:9.3f} ms",
                          flush=True)
    finally:
        for p in procs.values():
            p.stdin.close()
            p.wait(timeout=60)
    for name in PATHS:
        b, c = runs[("base", name)], runs[("change", name)]
        diff = [y - x for x, y in zip(b, c)]
        print(f"{name:9s} median base {statistics.median(b):.3f} ms, "
              f"change {statistics.median(c):.3f} ms, change - base "
              f"{statistics.median(diff):+.3f} ms (pairs {len(diff)}, "
              f"change slower in {sum(d > 0 for d in diff)})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
