"""Graph-analytics driver for the port (counterpart of
``repro.launch.graph_run``): the paper's six primitives, k-hop reach,
label propagation and who-to-follow.

Builds a graph, runs the requested primitives, optionally validates them
against the host oracles, and prints the run time and MTEPS (edges
visited / run time) per primitive. Exits nonzero when a validation
fails.

  PYTHONPATH=src python -m repro_torch.launch.graph_run --graph rmat \
      --scale 14 --primitives bfs,sssp,pagerank,cc,bc,tc --validate

``--device`` defaults to the card; ``--device cpu`` runs the plain
PyTorch path. ``--sources 3,99,512`` runs bfs/sssp as ONE batched
multi-source program over the listed roots, and makes bc accumulate
exactly those roots; reach then answers one batched query per root.
``--hops`` is reach's k (default 3). Triangle counting expands
Σ min(deg'(u), deg'(v)) slots over the oriented edges, which must fit
int32: on rmat graphs (edge factor 16) scale 19 is the largest that
does; a larger graph is refused before any kernel launches. Label
propagation sweeps every one of the n labels in 32-column SpMM blocks,
m·n products per iteration: keep it to rmat scale 16 or so. wtf (the
max-degree user, k = min(1000, n - 1)) prints its time but no
PASS/FAIL, as in the reference.

Observability: ``--stats`` reruns each primitive with ``telemetry=True``
and prints its per-iteration trajectory (frontier, tier, direction, …;
lane 0 of a batched run); ``--trace OUT.json`` writes the phase spans
(build, each run, each stats rerun) as Chrome trace-event JSON. Output
goes through ``obs.log`` (``[graph] ...`` lines; ``--log-level``).
``--graph rgg`` is the random geometric graph of 2^scale points with
radius sqrt(8 / n) (average degree about 2π).
"""
from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

from .. import obs
from ..core import backend as B
from ..core import graph as G
from ..core import ref as R
from ..core.primitives import (bc, bc_batch, bfs, bfs_batch,
                               connected_components, label_propagation,
                               pagerank, reach, reach_batch, sssp,
                               sssp_batch, triangle_count, who_to_follow)
from ..kernels.runtime import resolve_device
from ..linalg.ops import CapacityError
from ..obs import telemetry as T

log = obs.get_logger("graph")

PRIMITIVES = ("bfs", "sssp", "pagerank", "cc", "bc", "tc", "reach",
              "label_propagation", "wtf")


def make_graph(kind: str, scale: int, edge_factor: int, seed: int,
               index_dtype: str | None = None, encoding: str = "dense",
               device=None) -> G.Graph:
    """The CLI's graph under a storage plan (``index_dtype=None`` sizes
    the ids to the graph, as the reference does)."""
    plan = dict(index_dtype=index_dtype, encoding=encoding)
    if kind == "rmat":
        return G.rmat(scale, edge_factor, seed=seed, weighted=True,
                      device=device, **plan)
    if kind == "rgg":
        n = 1 << scale
        radius = math.sqrt(8.0 / n)   # ~average degree 8·π/4
        return G.random_geometric(n, radius, seed=seed, weighted=True,
                                  device=device, **plan)
    if kind == "grid":
        side = int((1 << scale) ** 0.5)
        return G.grid2d(side, weighted=True, seed=seed, device=device,
                        **plan)
    raise ValueError(kind)


def _warn_overflow(overflow) -> None:
    """A nonzero ``BFSResult.overflow`` means a capped frontier dropped
    discoveries (possible only under idempotent hash culling): the labels
    are untrustworthy and must not pass silently."""
    total = int(overflow.sum())
    if total:
        log.warning(f"bfs dropped {total} frontier entries "
                    f"(overflow); rerun with idempotence=False")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_primitive(name: str, g: G.Graph, src: int, validate: bool,
                  backend: str, sources=None, hops: int = 3):
    """Run one primitive; returns (seconds, MTEPS, ok or None)."""
    dev = g.device
    edges = g.num_edges
    ok = None
    _sync(dev)
    t0 = time.monotonic()
    if name == "bfs":
        r = (bfs_batch(g, sources, backend=backend) if sources
             else bfs(g, src, backend=backend))
        _sync(dev)
        dt = time.monotonic() - t0
        edges = int(r.edges_visited.sum())
        _warn_overflow(r.overflow)
        if validate:
            labels = r.labels.cpu().numpy().reshape(-1, g.num_vertices)
            ok = all(np.array_equal(labels[i], R.bfs_ref(g, s))
                     for i, s in enumerate(sources or [src]))
    elif name == "sssp":
        r = (sssp_batch(g, sources, backend=backend) if sources
             else sssp(g, src, backend=backend))
        _sync(dev)
        dt = time.monotonic() - t0
        if validate:
            dist = r.dist.cpu().numpy().reshape(-1, g.num_vertices)
            want = R.sssp_ref(g, sources or [src])
            ok = bool(np.allclose(dist, want, rtol=1e-5))
    elif name == "pagerank":
        r = pagerank(g, max_iter=20, backend=backend)
        _sync(dev)
        dt = time.monotonic() - t0
        if validate:
            ok = R.pagerank_rel_err(r.rank.cpu().numpy(),
                                    R.pagerank_ref(g, iters=20)) <= R.PR_RTOL
    elif name == "cc":
        r = connected_components(g, backend=backend)
        _sync(dev)
        dt = time.monotonic() - t0
        if validate:
            ok = np.array_equal(r.labels.cpu().numpy(), R.cc_ref(g))
    elif name == "bc":
        roots = sources or [src]
        r = (bc_batch(g, sources, backend=backend) if sources
             else bc(g, src, backend=backend))
        total = r.bc.reshape(len(roots), -1).sum(dim=0)
        _sync(dev)
        dt = time.monotonic() - t0
        edges = 2 * g.num_edges * len(roots)
        if validate:
            want = sum(R.bc_ref(g, s).astype(np.float64) for s in roots)
            ok = bool(np.allclose(total.cpu().numpy(), want, rtol=1e-3,
                                  atol=1e-3))
    elif name == "tc":
        try:
            r = triangle_count(g, backend=backend)
        except CapacityError as e:
            raise SystemExit(
                f"tc: {e}; on rmat graphs (edge factor 16) scale 19 is the "
                f"largest whose expansion fits") from e
        _sync(dev)
        dt = time.monotonic() - t0
        if validate:
            ok = int(r.total) == R.tc_ref(g)
    elif name == "reach":
        roots = sources or [src]
        r = (reach_batch(g, sources, hops, backend=backend) if sources
             else reach(g, src, hops, backend=backend))
        _sync(dev)
        dt = time.monotonic() - t0
        edges = g.num_edges * hops * len(roots)
        if validate:
            got = r.reached.cpu().numpy().reshape(len(roots), -1)
            ok = all(np.array_equal(got[i], R.reach_ref(g, s, hops))
                     for i, s in enumerate(roots))
    elif name == "label_propagation":
        r = label_propagation(g, backend=backend)
        _sync(dev)
        dt = time.monotonic() - t0
        edges = g.num_edges * r.iterations
        if validate:
            labels, iters = R.label_propagation_ref(g)
            ok = (np.array_equal(r.labels.cpu().numpy(), labels)
                  and r.iterations == iters)
    elif name == "wtf":
        who_to_follow(g, src, k=min(1000, g.num_vertices - 1),
                      backend=backend)
        _sync(dev)
        dt = time.monotonic() - t0
    else:
        raise ValueError(f"unknown primitive {name!r}; this driver runs "
                         f"{', '.join(PRIMITIVES)}")
    return dt, edges / dt / 1e6, ok


def collect_stats(name: str, g: G.Graph, src: int, backend: str,
                  sources=None):
    """Rerun ``name`` with ``telemetry=True`` and return its host trace
    (lane 0 of a batched run), or None for a primitive without a
    telemetry hook. A separate run: the timed run stays the program the
    times describe."""
    roots = sources or [src]
    if name == "bfs":
        r, buf = bfs_batch(g, roots, backend=backend, telemetry=True)
        return T.trim(buf, r.iterations).lane(0)
    if name == "sssp":
        r, buf = sssp_batch(g, roots, backend=backend, telemetry=True)
        return T.trim(buf, r.iterations).lane(0)
    if name == "pagerank":
        _, buf = pagerank(g, max_iter=20, backend=backend, telemetry=True)
        return T.trim(buf)
    if name == "cc":
        _, buf = connected_components(g, backend=backend, telemetry=True)
        return T.trim(buf)
    if name == "bc":
        _, buf = bc_batch(g, roots, backend=backend, telemetry=True)
        return T.trim(buf).lane(0)
    if name == "tc":
        _, buf = triangle_count(g, backend=backend, telemetry=True)
        return T.trim(buf)
    return None


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--graph", default="rmat",
                    choices=("rmat", "rgg", "grid"))
    ap.add_argument("--scale", type=int, default=14)
    ap.add_argument("--edge-factor", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--primitives", default="bfs,sssp,pagerank",
                    help=f"comma-separated, of {','.join(PRIMITIVES)}")
    ap.add_argument("--validate", action="store_true")
    ap.add_argument("--src", type=int, default=None)
    ap.add_argument("--sources", default=None, metavar="S0,S1,...",
                    help="comma-separated roots: bfs/sssp/reach run as "
                         "one batched multi-source program over them, and "
                         "bc accumulates exactly them")
    ap.add_argument("--hops", type=int, default=3,
                    help="k of the k-hop reach")
    ap.add_argument("--backend", default=None, choices=B.BACKENDS,
                    help="operator backend (default: cuda on the card, "
                         "torch on the CPU)")
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    ap.add_argument("--stats", action="store_true",
                    help="print each primitive's per-iteration telemetry "
                         "(frontier / tier / direction ...)")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="write phase spans as Chrome trace-event JSON "
                         "(open at ui.perfetto.dev)")
    ap.add_argument("--log-level", default="info",
                    choices=sorted(obs.log.LEVELS))
    args = ap.parse_args(argv)
    obs.configure(args.log_level)

    dev = resolve_device(args.device)
    backend = B.resolve(args.backend, dev)
    if args.trace:
        obs.reset()
    t0 = time.monotonic()
    with obs.span("build_graph", category="setup",
                  args={"kind": args.graph, "scale": args.scale}):
        g = make_graph(args.graph, args.scale, args.edge_factor, args.seed,
                       device=dev)
        _sync(dev)
    build_s = time.monotonic() - t0
    if args.validate:
        G.validate_graph(g)
    deg = np.diff(g.row_offsets.cpu().numpy())
    src = args.src if args.src is not None else int(np.argmax(deg))
    sources = ([int(s) for s in args.sources.split(",")]
               if args.sources else None)
    log.info(f"{args.graph} scale={args.scale}: n={g.num_vertices} "
             f"m={g.num_edges} max_deg={deg.max()} "
             f"src={sources if sources else src} device={dev} "
             f"backend={backend} build={build_s:.2f}s")
    failures = 0
    for name in args.primitives.split(","):
        name = name.strip()
        with obs.span(f"run:{name}", category="dispatch",
                      args={"backend": backend}):
            dt, mteps, ok = run_primitive(name, g, src, args.validate,
                                          backend, sources=sources,
                                          hops=args.hops)
        status = "" if ok is None else ("  PASS" if ok else "  FAIL")
        log.info(f"{name:9s} {dt * 1000:9.2f} ms  {mteps:9.2f} MTEPS"
                 f"  backend={backend}{status}")
        failures += ok is False
        if args.stats:
            with obs.span(f"stats:{name}", category="dispatch"):
                trace = collect_stats(name, g, src, backend, sources)
            if trace is not None and trace.steps:
                log.info(f"{name} per-iteration trajectory"
                         + (" (lane 0)" if sources else "") + ":")
                # reprolint: disable=RL005 -- CLI output channel
                print(trace.format_table(prefix="  "))
    if args.trace:
        n_ev = obs.export_chrome_trace(args.trace)
        log.info(f"wrote {n_ev} trace events to {args.trace}")
    if failures:
        raise SystemExit(f"{failures} primitives failed validation")


if __name__ == "__main__":
    main()
