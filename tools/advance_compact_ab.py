"""A/B of K1 (advance_filter_batch), K2 (compact), K3 (advance_batch), K5
(segment_search / segment_locate) and K6 (lb_expand) between two
checkouts of this repo on one card, at the shapes of ``chip_smoke.py``.

  python tools/advance_compact_ab.py BASE_DIR [--pairs 10] [--bfs-pairs 3]
      [--grid-depth 256] [--profile] [--only k3,k6,sssp]

BASE_DIR is another checkout (for example the parent commit, unpacked
with ``git archive``). One worker process per tree imports that tree's
``repro_torch`` (``PYTHONPATH=<tree>/src``) and makes the same inputs
from the same seeds:

  * ``k1_top4`` / ``k1_top1``: K1 at rmat-22's top tier (cap_out = m,
    cap_front = n) on the level-1 frontier of its 4 (1) largest hubs,
    visited = that frontier and the hubs (phase 2 of ``chip_smoke.py``);
  * ``k1_grid`` / ``k1_grid_delta``: K1 on grid2d(2048) under int32 and
    escape-free delta columns, a quarter of the vertices in each of 4
    lanes, half of them visited, at the tier the expansion needs;
  * ``k2``: K2 on rmat-22's (4, n) level-1 bitmap with the shared ids
    row (BFS pull's ``to_sparse``);
  * ``k3_top4`` / ``k3_top1``: K3 at rmat-22's top tier (cap_out = m) on
    the level-1 frontier of its 4 (1) largest hubs as an SSSP near pile
    (capacity n, so cap_in = n); ``k3_small4``: K3 at the seed step's
    tier (262,144) on the hubs alone, cap_in = n;
  * ``k3_grid`` / ``k3_grid_delta``: K3 on the grid's quarter frontier
    (cap_in = n) at its tier under int32 and delta columns;
  * ``k3_tc``: K3 (B = 1) at triangle counting's shape, the mxm expansion
    of the oriented rmat scale-18 graph (659,157,569 slots);
  * ``k6``: K6 at rmat-22's whole-graph expansion (its out-degrees over
    2^27 slots);
  * ``k5_tc_locate``: K5 (locate) at triangle counting's probes, the mxm
    expansion's needles searched in the rows of rmat-18's oriented graph;
    ``k5_found22``: K5 (found) on segmented_intersect's probes of random
    edge pairs of rmat-22, up to 3e8 lanes (chip_smoke.py's);
    ``k5_subgraph16``: K5 (found) at subgraph_match's join on rmat-16,
    the triangle query's one probe launch (its inputs kept from a run;
    1.2e9 lanes, so run it with ``--only k5_subgraph16``);
  * ``bfs_rmat``: one ``bfs_batch`` on rmat-22 from the max-degree vertex
    and three random ones (path (a)'s sources), host clock;
  * ``bfs_grid_push`` / ``bfs_grid_pull``: ``bfs_batch`` on the int32
    grid from path (e)'s four sources (push only; pull only), the BSP
    loop cut at ``--grid-depth`` levels (the full run takes ~4,100),
    host clock;
  * ``sssp_rmat``: one ``sssp_batch`` on rmat-22 from path (a)'s sources;
    ``sssp_grid``: ``sssp_batch`` on the int32 grid from path (e)'s
    sources, its loop cut at ``--grid-depth`` steps; host clock;
  * ``tc18``: one ``triangle_count`` at rmat scale 18, host clock.

The workers take turns, base first in even pairs: each kernel case is
the mean of ``--reps`` calls by CUDA events after a warm-up call; the
``bfs_*``, ``sssp_*`` and ``tc18`` cases run in the first ``--bfs-pairs`` pairs.
Each worker checks its kernels against their plain versions first (K1
leaving its first-slot table all INT32_MAX; K3 at rmat-22's top tier
lane by lane, K3 at the TC shape, whose plain version would not fit
beside the other worker, only through the checksums below; K5 on its
first 2^24 lanes), and answers
with a checksum of every case's outputs: the two trees' checksums must
agree, or the tool stops. ``--only`` keeps the cases whose names start
with one of the given prefixes. Prints every run, then per
case the median of each tree and of the change-minus-base differences;
with ``--profile``, each tree's device time per call by kernel name for
every kernel case (``torch.profiler`` over ``--reps`` calls). Each
tree's peak device memory over one ``k1_top4`` call and one
``bfs_rmat`` run is printed too (its inputs and graphs included). The
grid is made only when a case on it is kept.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
KERNEL_CASES = ("k1_top4", "k1_top1", "k1_grid", "k1_grid_delta", "k2",
                "k3_top4", "k3_top1", "k3_small4", "k3_grid", "k3_grid_delta",
                "k3_tc", "k6", "k5_tc_locate", "k5_found22", "k5_subgraph16")
BFS_CASES = ("bfs_rmat", "bfs_grid_push", "bfs_grid_pull", "sssp_rmat",
             "sssp_grid", "tc18")
INT32_MAX = 2 ** 31 - 1


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def _checksum(torch, outs) -> int:
    """A position-weighted sum of every output, in chunks (int64)."""
    total = 0
    for t in outs:
        if t.dtype == torch.float32:
            t = t.view(torch.int32)
        flat = t.reshape(-1)
        for a in range(0, flat.numel(), 1 << 26):
            part = flat[a:a + (1 << 26)].to(torch.int64)
            w = torch.arange(a, a + part.numel(), device=part.device) % 8191
            total += (int((part * (w + 1)).sum(dtype=torch.int64))
                      + 7 * int(part.numel()))
    return total


def worker(reps: int, grid_depth: int, only) -> None:
    """Make the inputs, check and warm every case, then time the case
    named on each line of standard input and answer with its ms."""
    import numpy as np
    import torch
    from repro_torch.core import frontier as F
    from repro_torch.core import graph as G
    from repro_torch.core import operators as O
    bfs_mod = importlib.import_module("repro_torch.core.primitives.bfs")
    sssp_mod = importlib.import_module("repro_torch.core.primitives.sssp")
    tc_mod = importlib.import_module("repro_torch.core.primitives.tc")
    from repro_torch.kernels import ops as K
    from repro_torch.kernels import ref as P
    from repro_torch.linalg import ops as L

    print(f"worker: {K.__file__}", file=sys.stderr, flush=True)
    dev = torch.device("cuda")
    g = G.rmat(22, 16, seed=0, weighted=True, device=dev)
    n, m = g.num_vertices, g.num_edges
    deg = g.degrees.cpu().numpy()
    hubs = [int(v) for v in np.argsort(-deg, kind="stable")[:4]]
    rng = np.random.default_rng(0)
    sources = [hubs[0]] + [int(v) for v in rng.choice(
        np.flatnonzero(deg > 0), 3, replace=False)]
    ro, ci = g.row_offsets, g.col_indices

    def hub_case(lanes):
        mask = torch.zeros((len(lanes), n), dtype=torch.bool, device=dev)
        for i, h in enumerate(lanes):
            mask[i, ci[int(ro[h]):int(ro[h + 1])].long()] = True
        seed = torch.zeros_like(mask)
        seed[torch.arange(len(lanes), device=dev),
             torch.tensor(lanes, device=dev)] = True
        front = F.compact_indices_batch(mask, n, backend="torch")
        base, sizes = O._base_and_sizes(g, front.ids, front.valid_mask,
                                        "vertex")
        return (ro, ci, base, sizes, mask | seed, m, n), mask

    top4, nbr4 = hub_case(hubs)
    top1, _ = hub_case(hubs[:1])
    ids_row = torch.arange(n, dtype=torch.int32, device=dev)[None, :]

    def near_pile(gr, mask):
        """K3's (base, sizes) of an SSSP near pile: capacity n."""
        front = F.compact_indices_batch(mask, gr.num_vertices,
                                        backend="torch")
        return O._base_and_sizes(gr, front.ids, front.valid_mask, "vertex")

    def tier(gr, sizes):
        caps = F.tier_caps(gr.num_edges)
        return caps[F.tier_index(int(sizes.sum(dim=1).max()), caps)]

    seed4 = torch.zeros((4, n), dtype=torch.bool, device=dev)
    seed4[torch.arange(4, device=dev), torch.tensor(hubs, device=dev)] = True
    k3_in = {"k3_top4": (g, near_pile(g, nbr4), m),
             "k3_top1": (g, near_pile(g, nbr4[:1]), m)}
    b3, s3 = near_pile(g, seed4)
    k3_in["k3_small4"] = (g, (b3, s3), tier(g, s3))

    k1 = {"k1_top4": (top4, g.cache), "k1_top1": (top1, g.cache)}
    grids, ng = {}, 0         # the grid, made only for its cases
    grid_cases = ("k1_grid", "k3_grid", "bfs_grid", "sssp_grid")
    if any(_kept(c, only) for c in grid_cases):
        grids = {enc: G.grid2d(2048, weighted=True, seed=0, device=dev,
                               **({"encoding": "delta"} if enc == "delta"
                                  else {}))
                 for enc in ("int32", "delta")}
        gg = grids["int32"]
        ng = gg.num_vertices
        gen = torch.Generator(device=dev).manual_seed(11)
        qmask = torch.rand((4, ng), generator=gen, device=dev) < 0.25
        gvisited = torch.rand((4, ng), generator=gen, device=dev) < 0.5
        gfront = F.compact_indices_batch(qmask, ng, backend="torch")

        def grid_case(gr):
            base, sizes = O._base_and_sizes(gr, gfront.ids, gfront.valid_mask,
                                            "vertex")
            caps = F.tier_caps(gr.num_edges)
            cap = caps[F.tier_index(int(sizes.sum(dim=1).max()), caps)]
            return (gr.row_offsets, gr.col_store, base, sizes, gvisited, cap,
                    ng)

        k1.update({"k1_grid": (grid_case(gg), gg.cache),
                   "k1_grid_delta": (grid_case(grids["delta"]),
                                     grids["delta"].cache)})
        for name, gr in (("k3_grid", gg), ("k3_grid_delta", grids["delta"])):
            base, sizes = O._base_and_sizes(gr, gfront.ids, gfront.valid_mask,
                                            "vertex")
            k3_in[name] = (gr, (base, sizes), tier(gr, sizes))
        gsrc = [0, ng // 2 + 1024, 12345, ng - 1]
    # triangle counting's mxm expansion at rmat scale 18 (B = 1)
    g_tc = G.rmat(18, 16, seed=0, weighted=True, device=dev)
    sub, ssrc, sdst = tc_mod._orient(g_tc)
    (a_off, a_idx, _), (bt_off, bt_idx, _), tbase, tprobe, tcap = (
        L.mxm_plan(sub, sub, (ssrc, sdst), b_transpose=True))
    tsizes = (torch.index_select(a_off, 0, tbase + 1)
              - torch.index_select(a_off, 0, tbase)).to(torch.int32)
    run = {name: (lambda a=a, c=c: K.advance_filter_batch(*a, c))
           for name, (a, c) in k1.items()}
    run["k2"] = lambda: K.compact(ids_row, nbr4)
    for name, (gr, (base, sizes), cap) in k3_in.items():
        run[name] = (lambda gr=gr, base=base, sizes=sizes, cap=cap:
                     K.advance_batch(gr.row_offsets, gr.col_store, base,
                                     sizes, cap, gr.cache))
    run["k3_tc"] = lambda: K.advance(a_off, a_idx, tbase, tsizes, tcap)
    deg32 = g.degrees.to(torch.int32).contiguous()
    k6_cap = 1 << (m - 1).bit_length()
    run["k6"] = lambda: K.lb_expand(deg32, k6_cap)
    k5 = {}              # K5's inputs (haystack, lo, hi, needles)
    if _kept("k5_tc_locate", only):
        _, tneedles, _, tpair, _, _, _ = K.advance(a_off, a_idx, tbase,
                                                   tsizes, tcap)
        rows = torch.index_select(tprobe, 0, tpair)
        del tpair
        k5["k5_tc_locate"] = (bt_idx, torch.index_select(bt_off, 0, rows),
                              torch.index_select(bt_off, 0, rows + 1),
                              tneedles)
        del rows
    if _kept("k5_found22", only):
        prng = np.random.default_rng(1)
        e_ids = torch.from_numpy(prng.integers(0, m, 1 << 20)).to(dev)
        pu = torch.index_select(g.row_seg, 0, e_ids)
        pv = torch.index_select(ci, 0, e_ids)
        mins = torch.minimum(g.degrees[pu.long()], g.degrees[pv.long()])
        npairs = int((torch.cumsum(mins.long(), 0, dtype=torch.int64)
                      <= 3 * 10 ** 8).sum(dtype=torch.int64))
        length = torch.tensor(npairs, dtype=torch.int32, device=dev)
        needles, lo, hi, _, _ = O._intersect_probes(
            g, F.SparseFrontier(ids=pu[:npairs].contiguous(), length=length),
            F.SparseFrontier(ids=pv[:npairs].contiguous(), length=length),
            int(mins[:npairs].sum()), "cuda")
        k5["k5_found22"] = (ci, lo, hi, needles)
        del e_ids, pu, pv, mins
    if _kept("k5_subgraph16", only):
        from search_steps import join_probe
        from repro_torch.core import backend as B
        from repro_torch.core.primitives import subgraph_match
        g16 = G.rmat(16, 16, seed=0, weighted=True, device=dev)
        tri = int(tc_mod.triangle_count(g16, backend="cuda").total)
        k5["k5_subgraph16"] = join_probe(
            B, subgraph_match, g16, max(6 * tri, g16.num_edges))
    for name, args5 in k5.items():
        fn5 = K.segment_locate if name == "k5_tc_locate" else (
            K.segment_search)
        run[name] = lambda fn5=fn5, args5=args5: [fn5(*args5)]

    def on_grid(mod, fn, **kw):
        real_loop = mod.run_until_any

        def cut_loop(cond, plan, body, state, max_iter):
            return real_loop(cond, plan, body, state,
                             min(max_iter, grid_depth))
        mod.run_until_any = cut_loop
        try:
            return fn(gg, gsrc, backend="cuda", **kw)
        finally:
            mod.run_until_any = real_loop

    bfs_runs = {
        "bfs_rmat": lambda: bfs_mod.bfs_batch(g, sources, backend="cuda"),
        "bfs_grid_push": lambda: on_grid(bfs_mod, bfs_mod.bfs_batch,
                                         direction=False),
        "bfs_grid_pull": lambda: on_grid(bfs_mod, bfs_mod.bfs_batch,
                                         do_a=0.0, do_b=0.0),
        "sssp_rmat": lambda: sssp_mod.sssp_batch(g, sources, backend="cuda"),
        "sssp_grid": lambda: on_grid(sssp_mod, sssp_mod.sssp_batch),
        "tc18": lambda: tc_mod.triangle_count(g_tc, backend="cuda"),
    }
    run = {k: v for k, v in run.items() if _kept(k, only)}
    bfs_runs = {k: v for k, v in bfs_runs.items() if _kept(k, only)}

    def plain3(name):
        gr, (base, sizes), cap = k3_in[name]
        return P.advance_batch(gr.row_offsets, gr.col_store, base, sizes,
                               cap)

    for name in run:
        if name.startswith("k1"):
            a, c = k1[name]
            want = P.advance_filter_batch(*a)
        elif name == "k2":
            want = P.compact(ids_row, nbr4)
        elif name == "k6":
            want = P.lb_expand(torch.cat([deg32.new_zeros(1), torch.cumsum(
                deg32, 0, dtype=torch.int32)]), k6_cap)
        elif name in ("k3_top4", "k3_tc"):
            continue                       # lane by lane below; checksums
        elif name in k5:
            # the plain version on the first 2^24 lanes (all of them
            # would not fit beside the other worker)
            hay5, lo5, hi5, nd5 = k5[name]
            head = slice(0, min(int(nd5.shape[0]), 1 << 24))
            plain5 = (P.segment_locate if name == "k5_tc_locate"
                      else P.segment_search)
            if not torch.equal(run[name]()[0][head], plain5(
                    hay5, lo5[head], hi5[head], nd5[head])):
                raise AssertionError(f"{name} differs from its plain "
                                     f"version")
            torch.cuda.empty_cache()
            continue
        else:
            want = plain3(name)
        if not all(torch.equal(x, y) for x, y in zip(run[name](), want)):
            raise AssertionError(f"{name} differs from its plain version")
        del want
        torch.cuda.empty_cache()
    if "k3_top4" in run:
        gr, (base, sizes), cap = k3_in["k3_top4"]
        got = run["k3_top4"]()
        for lane in range(base.shape[0]):
            want = P.advance_batch(gr.row_offsets, gr.col_store,
                                   base[lane:lane + 1], sizes[lane:lane + 1],
                                   cap)
            if not all(torch.equal(x[lane], y[0]) for x, y in zip(got, want)):
                raise AssertionError(f"k3_top4 lane {lane} differs from its "
                                     f"plain version")
            del want
        del got
        torch.cuda.empty_cache()
    for key, table in [kv for gr in [g, *grids.values()]
                       for kv in gr.cache.items()]:
        if isinstance(key, tuple) and key[0] == "advance_filter_first":
            if not bool((table == INT32_MAX).all()):
                raise AssertionError("first-slot table not INT32_MAX")
    sums = {}
    for name, fn in run.items():
        sums[name] = _checksum(torch, fn())
        torch.cuda.empty_cache()
    for name, fn in bfs_runs.items():
        r = fn()
        sums[name] = _checksum(torch, [r[0]])
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    def profile(name):
        from torch.profiler import ProfilerActivity, profile as prof
        run[name]()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        with prof(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as pr:
            for _ in range(reps):
                run[name]()
            torch.cuda.synchronize()
        torch.cuda.empty_cache()
        rows = [(e.key, e.device_time_total / reps, e.count / reps)
                for e in pr.key_averages() if e.device_time_total > 0]
        rows.sort(key=lambda r: -r[1])
        return "; ".join(f"{k[:50]} {us:.1f} us x{c:g}" for k, us, c in
                         rows[:8])

    print(f"n={n} m={m} grid n={ng}; K1 slots "
          f"{ {k: int(a[3].sum()) for k, (a, _) in k1.items()} }; K3 slots "
          f"{ {k: int(s.sum()) for k, (_, (_, s), _) in k3_in.items()} }, "
          f"TC {tcap}", file=sys.stderr, flush=True)
    print("ready " + json.dumps(sums), flush=True)
    for line in sys.stdin:
        name = line.strip()
        if name.startswith("profile "):
            print(profile(name.split()[1]), flush=True)
        elif name.startswith("peak "):
            fn = {**run, **bfs_runs}[name.split()[1]]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            fn()
            torch.cuda.synchronize()
            print(f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f}",
                  flush=True)
            torch.cuda.empty_cache()
        elif name in bfs_runs:
            print(f"{wall(bfs_runs[name]):.4f}", flush=True)
            torch.cuda.empty_cache()
        else:
            print(f"{timed(run[name]):.4f}", flush=True)
            torch.cuda.empty_cache()


def _kept(name: str, only) -> bool:
    return not only or any(name.startswith(p) for p in only)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("base", type=Path, nargs="?")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--bfs-pairs", type=int, default=3)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--grid-depth", type=int, default=256)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--only", default="",
                    help="comma-separated case-name prefixes to run")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    only = [p for p in args.only.split(",") if p]
    if args.worker:
        worker(args.reps, args.grid_depth, only)
        return 0
    if args.base is None:
        ap.error("BASE_DIR is required")
    print(f"card: {_smi()}", flush=True)
    procs, sums = {}, {}
    # one worker at a time makes its inputs and checks them: two at once
    # would not fit on the card beside each other's plain versions
    for label, root in (("base", args.base), ("change", HERE)):
        env = dict(os.environ, PYTHONPATH=str(root.resolve() / "src"))
        p = procs[label] = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--worker",
             "--reps", str(args.reps), "--grid-depth",
             str(args.grid_depth), "--only", args.only],
            stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, text=True, env=env, cwd=root)
        line = p.stdout.readline().strip()
        if not line.startswith("ready "):
            for q in procs.values():
                q.kill()
            raise SystemExit(f"{label} worker failed")
        sums[label] = json.loads(line[len("ready "):])

    def ask(label, name):
        p = procs[label]
        p.stdin.write(name + "\n")
        p.stdin.flush()
        line = p.stdout.readline()
        return line.strip() if name.startswith("profile ") else float(line)

    cases = [c for c in KERNEL_CASES + BFS_CASES if _kept(c, only)]
    runs = {(t, c): [] for t in procs for c in cases}
    try:
        if sums["base"] != sums["change"]:
            raise SystemExit(f"the trees' outputs differ: {sums}")
        print(f"outputs equal in both trees (checksums {sums['change']})",
              flush=True)
        for i in range(args.pairs):
            order = ("base", "change") if i % 2 == 0 else ("change", "base")
            for name in cases:
                if name in BFS_CASES and i >= args.bfs_pairs:
                    continue
                for label in order:
                    ms = ask(label, name)
                    runs[(label, name)].append(ms)
                    print(f"pair {i:2d} {label:6s} {name:14s} {ms:10.4f} ms",
                          flush=True)
        for name in ("k1_top4", "k3_top4", "bfs_rmat", "sssp_rmat"):
            if name not in cases:
                continue
            for label in procs:
                print(f"peak   {label:6s} {name:14s} "
                      f"{ask(label, 'peak ' + name):.3f} GiB of device "
                      f"memory (the worker's graphs included)", flush=True)
        if args.profile:
            for name in [c for c in cases if c in KERNEL_CASES]:
                for label in procs:
                    print(f"profile {label:6s} {name:14s} "
                          f"{ask(label, 'profile ' + name)}", flush=True)
    finally:
        for p in procs.values():
            p.stdin.close()
            p.wait(timeout=300)
    for name in cases:
        b, c = runs[("base", name)], runs[("change", name)]
        if not b:
            continue
        diff = [y - x for x, y in zip(b, c)]
        print(f"{name:14s} median base {statistics.median(b):.4f} ms, "
              f"change {statistics.median(c):.4f} ms, change - base "
              f"{statistics.median(diff):+.4f} ms (pairs {len(diff)}, "
              f"change slower in {sum(d > 0 for d in diff)})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
