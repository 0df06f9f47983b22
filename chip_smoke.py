#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA Hopper card.

  python3 chip_smoke.py [--scale 22]

``--scale`` cuts the rmat graph for a quick check after a kernel edit;
the default, 22, is the main path's size.

Phases:
  1. device and build — the card's name and power limit, the PyTorch and
     CUDA toolkit versions, and the build of the four CUDA kernels from
     ``src/repro_torch/kernels/csrc`` (one nvcc per source, in parallel
     with the host-side graph generation);
  2. kernel vs plain — each kernel's wrapper against its plain PyTorch
     version on the same card tensors, at the main path's shapes on the
     rmat graph (two capacity tiers, the top one included; B = 1 and
     B = 4), integer outputs equal and the SpMV bit-equal to its plain
     version run on the CPU; each kernel timed beside its plain version,
     one PyTorch library call where one computes the same function, and
     the least time the card could take;
  3. main path — bfs from the max-degree vertex, bfs_batch, sssp,
     sssp_batch and 20 PageRank sweeps on the cuda backend, validated
     against host oracles (numpy BFS hop counts, scipy Dijkstra, a numpy
     power iteration); every kernel's launch counter must have grown;
  4. where the time goes — the batched primitives once more under
     torch.profiler: device busy time, idle share, top kernels.

Prints one JSON line of kernel numbers, then the card's name and power
limit, then ``{"ok": true, "device": ...}`` as the last line. Any failure
raises and exits nonzero. Without a CUDA device, or outside a checkout
of the repository, it exits 2 and prints no result.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12         # non-tensor-core peak, the rate for int ops
EDGE_FACTOR = 16
BATCH = 4
# PageRank (float32) against a float64 power iteration, per vertex
# relative: float32 folds of up to ~1.6e5 in-edges drift by ~1e-6..1e-5
PR_RTOL = 1e-4


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def _nvcc_version(runtime) -> str:
    try:
        out = subprocess.run([runtime._nvcc(), "--version"],
                             capture_output=True, text=True, timeout=60,
                             check=True).stdout
    except RuntimeError as exc:
        return str(exc)
    return out.strip().splitlines()[-1]


def _timed(torch, fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` calls, by CUDA events,
    after one warm-up call."""
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


def _bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=22)
    args = ap.parse_args(argv)

    root = Path(__file__).resolve().parent
    if not (root / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke.py: src/repro_torch is missing; run this script "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root / "src"))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device is available", file=sys.stderr)
        return 2

    from repro_torch.core import frontier as F
    from repro_torch.core import graph as G
    from repro_torch.core import operators as O
    from repro_torch.core import ref as R
    from repro_torch.core.primitives import (bfs, bfs_batch, pagerank, sssp,
                                             sssp_batch)
    from repro_torch.core.primitives.pagerank import _inv_out_degrees
    from repro_torch.kernels import ops as K
    from repro_torch.kernels import ref as P
    from repro_torch.kernels import runtime
    from repro_torch.linalg import semiring as SR

    t_start = time.monotonic()
    dev = runtime.resolve_device(None)
    smi = _smi()
    print(f"card: {smi}")
    print(f"torch {torch.__version__} (CUDA {torch.version.cuda}), "
          f"nvcc: {_nvcc_version(runtime)}, python {sys.version.split()[0]}")

    # ---- phase 1: kernel build, overlapped with the host graph build ----
    built: dict = {}

    def build():
        try:
            built["seconds"] = runtime.build()
        except BaseException as exc:         # re-raised in the main thread
            built["error"] = exc

    builder = threading.Thread(target=build)
    builder.start()
    t0 = time.monotonic()
    g = G.rmat(args.scale, EDGE_FACTOR, seed=0, weighted=True, device=dev)
    torch.cuda.synchronize()
    build_graph_s = time.monotonic() - t0
    builder.join()
    if "error" in built:
        raise built["error"]
    print(f"kernels built and loaded in {built['seconds']:.2f} s "
          f"(one nvcc per source, in parallel)")
    n, m, b = g.num_vertices, g.num_edges, BATCH
    deg_np = g.degrees.cpu().numpy()
    print(f"rmat scale {args.scale} edge factor {EDGE_FACTOR}: "
          f"n={n} m={m} max_deg={deg_np.max()} ell_width={g.ell_width} "
          f"csc_ell_width={g.csc_ell_width}, host build "
          f"{build_graph_s:.2f} s")

    # the device-side stable sorts give the host builder's arrays
    small_cpu = G.rmat(14, 16, seed=1, weighted=True, device="cpu")
    small_gpu = G.rmat(14, 16, seed=1, weighted=True, device=dev)
    for f in G.TENSOR_FIELDS:
        if not torch.equal(getattr(small_cpu, f),
                           getattr(small_gpu, f).cpu()):
            raise AssertionError(f"graph field {f} differs cpu vs cuda")

    # ---- phase 2: every kernel against its plain version ----
    hubs = [int(v) for v in np.argsort(-deg_np, kind="stable")[:b]]
    ro, ci = g.row_offsets, g.col_indices
    cap_v = max(min(n, m), 1)
    results: dict = {}

    def record(name, err, ms, plain_ms, nbytes, ops, library_ms=None):
        bound, by = _bound_ms(nbytes, ops)
        results[name] = {"max_abs_err": float(err), "ms": ms,
                         "plain_ms": plain_ms, "bound_ms": bound,
                         "bound_by": by, "library_ms": library_ms}

    def level1_masks(lanes):
        """(B, n) bool: each hub's neighbours (its BFS level 1)."""
        mask = torch.zeros((len(lanes), n), dtype=torch.bool, device=dev)
        for i, h in enumerate(lanes):
            mask[i, ci[int(ro[h]):int(ro[h + 1])].long()] = True
        return mask

    def equal_ints(name, got, want):
        for i, (x, y) in enumerate(zip(got, want)):
            if not torch.equal(x, y):
                raise AssertionError(f"{name}: output {i} differs from "
                                     f"the plain version")

    def tier_of(need):
        caps = F.tier_caps(m)
        return caps[F.tier_index(need, caps)]

    for lanes in (hubs[:1], hubs):
        bl = len(lanes)
        nbr = level1_masks(lanes)
        seed = torch.zeros_like(nbr)
        seed[torch.arange(bl, device=dev),
             torch.tensor(lanes, device=dev)] = True
        # (frontier, visited) of a BFS push step: the seed step (a small
        # tier) and the hubs' level-1 frontier at the top tier (m)
        for front_mask, visited, cap_out in (
                (seed, seed, None), (nbr, nbr | seed, m)):
            front = F.compact_indices_batch(front_mask, cap_v,
                                            backend="torch")
            base, sizes = O._base_and_sizes(g, front.ids, front.valid_mask,
                                            "vertex")
            need = int(sizes.sum(dim=1).max())
            cap_out = cap_out or tier_of(need)
            live = int(front.lengths.sum())
            slots = int(torch.clamp(sizes.sum(dim=1), max=cap_out).sum())
            iters = K._iters(cap_v)

            # K1: fused advance + filter
            def k1():
                return K.advance_filter_batch(ro, ci, base, sizes, visited,
                                              cap_out, cap_v, g.cache)

            def p1():
                return P.advance_filter_batch(ro, ci, base, sizes, visited,
                                              cap_out, cap_v)

            equal_ints("advance_filter_batch", k1(), p1())
            reps = 3 if cap_out == m else 20
            ms = _timed(torch, k1, reps)
            pms = _timed(torch, p1, 2 if cap_out == m else 5)
            nbytes = live * 16 + slots * 5 + bl * cap_v * 8 + bl * 8
            ops = slots * (iters * 4 + 8)
            print(f"K1 advance_filter_batch B={bl} cap_out={cap_out} "
                  f"slots={slots}: {ms:.3f} ms, plain {pms:.3f} ms, "
                  f"bound {_bound_ms(nbytes, ops)[0]:.3f} ms")
            if bl == b and cap_out == m:
                record("advance_filter_batch", 0, ms, pms, nbytes, ops)
            del front

            # K3: advance over an SSSP near pile (frontier capacity n)
            near = F.compact_indices_batch(front_mask, n, backend="torch")
            base3, sizes3 = O._base_and_sizes(g, near.ids, near.valid_mask,
                                              "vertex")

            def k3():
                return K.advance_batch(ro, ci, base3, sizes3, cap_out)

            def p3():
                return P.advance_batch(ro, ci, base3, sizes3, cap_out)

            equal_ints("advance_batch", k3(), p3())
            ms = _timed(torch, k3, reps)
            pms = _timed(torch, p3, 2 if cap_out == m else 5)
            nbytes = live * 16 + slots * 4 + bl * cap_out * 21 + bl * 4
            ops = bl * cap_out * (K._iters(n) * 4 + 8)
            print(f"K3 advance_batch B={bl} cap_out={cap_out} "
                  f"slots={slots}: {ms:.3f} ms, plain {pms:.3f} ms, "
                  f"bound {_bound_ms(nbytes, ops)[0]:.3f} ms")
            if bl == b and cap_out == m:
                record("advance_batch", 0, ms, pms, nbytes, ops)
            del near, base3, sizes3, base, sizes
            torch.cuda.empty_cache()

        # K2: compaction of a (B, n) bitmap (BFS pull's to_sparse, SSSP's
        # near pile): the level-1 bitmap and its complement
        ids_row = torch.arange(n, dtype=torch.int32, device=dev)[None, :]
        for mask in (nbr, ~nbr):
            def k2():
                return K.compact(ids_row, mask)

            def p2():
                return P.compact(ids_row, mask)

            def lib2():
                return [torch.masked_select(ids_row[0], mask[i])
                        for i in range(bl)]

            equal_ints("compact", k2(), p2())
            packed, totals = k2()
            for i in range(bl):        # the library call agrees too
                t = int(totals[i])
                if not torch.equal(packed[i, :t], lib2()[i]):
                    raise AssertionError("compact differs from "
                                         "masked_select")
            kept = int(totals.sum())
            ms = _timed(torch, k2, 20)
            pms = _timed(torch, p2, 5)
            lms = _timed(torch, lib2, 5)
            nbytes = bl * n * 5 + kept * 4 + bl * 4
            print(f"K2 compact B={bl} cap={n} kept={kept}: {ms:.3f} ms, "
                  f"plain {pms:.3f} ms, masked_select {lms:.3f} ms, "
                  f"bound {_bound_ms(nbytes, bl * n * 4)[0]:.3f} ms")
            if bl == b and mask is nbr:
                record("compact", 0, ms, pms, nbytes, bl * n * 4, lms)
        del nbr, seed
        torch.cuda.empty_cache()

    # K4: all five semirings on a small weighted graph, bit for bit with
    # the plain version (run on the CPU, where its overflow fold adds in
    # edge order); masked and unmasked
    gs = small_gpu
    xs = torch.rand(gs.num_vertices, generator=torch.Generator().manual_seed(
        5)).to(dev)
    rowmask = torch.rand(gs.num_vertices, generator=torch.Generator(
    ).manual_seed(6)) < 0.5
    for name, sr in SR.SEMIRINGS.items():
        for vals in (None, gs.edge_values):
            for mask in (None, rowmask.to(dev)):
                args_k = (gs.row_offsets, gs.col_indices, vals, xs, sr,
                          gs.ell_width, mask, None, gs.over_pos,
                          gs.over_row)
                got = K.spmv(*args_k)
                want = P.spmv(*(a.cpu() if torch.is_tensor(a) else a
                                for a in args_k))
                if not torch.equal(got.cpu(), want):
                    raise AssertionError(f"spmv {name} differs from the "
                                         f"plain version")
    print("K4 spmv: five semirings x (structural, weighted) x (masked, "
          "unmasked) bit-equal to the plain version on rmat scale 14")

    # K4 at full size: one PageRank sweep (structural plus_times over the
    # CSC transpose), bit for bit with the plain version run on the CPU
    # (on the card its overflow fold is an atomic index_add_ in no fixed
    # order; that run is timed, not compared), and beside cuSPARSE
    # through torch.sparse
    rank = torch.full((n,), 1.0 / n, dtype=torch.float32, device=dev)
    contrib = rank * _inv_out_degrees(g)
    spmv_args = (g.csc_offsets, g.csc_indices, None, contrib,
                 SR.plus_times, g.csc_ell_width, None, g.csc_row_seg,
                 g.csc_over_pos, g.csc_over_row)

    def k4():
        return K.spmv(*spmv_args)

    def p4():
        return P.spmv(*spmv_args)

    a_csr = torch.sparse_csr_tensor(g.csc_offsets, g.csc_indices,
                                    torch.ones(m, device=dev), size=(n, n))

    def lib4():
        return torch.mv(a_csr, contrib)

    y_k, y_l = k4().cpu(), lib4().cpu()
    t0 = time.monotonic()
    y_c = P.spmv(*(a.cpu() if torch.is_tensor(a) else a for a in spmv_args))
    plain_cpu_s = time.monotonic() - t0
    err4 = float((y_k - y_c).abs().max())
    if not torch.equal(y_k, y_c):
        raise AssertionError(f"spmv differs from its plain version on the "
                             f"CPU by up to {err4}")
    err_lib = float(((y_k - y_l).abs() / y_l.abs().clamp_min(1e-30)).max())
    ms, pms, lms = (_timed(torch, k4, 20), _timed(torch, p4, 3),
                    _timed(torch, lib4, 20))
    # compulsory traffic: the columns once, x once (16.8 MB at scale 22,
    # it stays in the 50 MB L2), the offsets and y
    nbytes = m * 4 + n * 4 + (n + 1) * 4 + n * 4
    print(f"K4 spmv plus_times n={n} m={m}: {ms:.3f} ms, plain {pms:.3f} "
          f"ms, torch.sparse {lms:.3f} ms, bound "
          f"{_bound_ms(nbytes, 2 * m)[0]:.3f} ms; bit-equal to the plain "
          f"version on the CPU ({plain_cpu_s:.1f} s there), max "
          f"|kernel-library|/|library| {err_lib:.3g}")
    record("spmv", err4, ms, pms, nbytes, 2 * m, lms)
    del a_csr, y_k, y_l, y_c
    torch.cuda.empty_cache()

    # ---- phase 3: the main path on the cuda backend ----
    rng = np.random.default_rng(0)
    sources = [hubs[0]] + [int(v) for v in rng.choice(
        np.flatnonzero(deg_np > 0), b - 1, replace=False)]
    hub = sources[0]
    K.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timings = {}

    def run(label, fn):
        torch.cuda.synchronize()
        t = time.monotonic()
        out = fn()
        torch.cuda.synchronize()
        timings[label] = time.monotonic() - t
        return out

    r_bfs = run("bfs", lambda: bfs(g, hub, backend="cuda"))
    r_bfsb = run("bfs_batch", lambda: bfs_batch(g, sources, backend="cuda"))
    r_sssp = run("sssp", lambda: sssp(g, hub, backend="cuda"))
    r_ssspb = run("sssp_batch",
                  lambda: sssp_batch(g, sources, backend="cuda"))
    r_pr = run("pagerank", lambda: pagerank(g, max_iter=20, backend="cuda"))
    launches = {k: v.launches for k, v in K.KERNELS.items()}
    peak = torch.cuda.max_memory_allocated()
    print(f"main path launches: {launches}; peak device memory "
          f"{peak / 2 ** 30:.2f} GiB")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")

    edges = {"bfs": int(r_bfs.edges_visited),
             "bfs_batch": int(r_bfsb.edges_visited.sum()),
             "sssp": m, "sssp_batch": m * b, "pagerank": m}
    for label, dt in timings.items():
        print(f"{label:10s} {dt * 1e3:10.2f} ms {edges[label] / dt / 1e6:10.2f}"
              f" MTEPS")
    print(f"bfs iterations {int(r_bfs.iterations)} (pull "
          f"{int(r_bfs.pull_iters)}); sssp iterations "
          f"{int(r_sssp.iterations)}, relaxations {int(r_sssp.relaxations)}")

    # validation against the host oracles
    t0 = time.monotonic()
    for i, s in enumerate(sources):
        want = R.bfs_ref(g, s)
        if not np.array_equal(r_bfsb.labels[i].cpu().numpy(), want):
            raise AssertionError(f"bfs_batch lane {i} differs from the "
                                 f"oracle")
    for f in r_bfs._fields:
        if not torch.equal(getattr(r_bfs, f), getattr(r_bfsb, f)[0]):
            raise AssertionError(f"bfs {f} differs from bfs_batch lane 0")
    dist = R.sssp_ref(g, sources)
    if not np.array_equal(r_ssspb.dist.cpu().numpy(), dist):
        raise AssertionError("sssp_batch differs from Dijkstra")
    for f in r_sssp._fields:
        if not torch.equal(getattr(r_sssp, f), getattr(r_ssspb, f)[0]):
            raise AssertionError(f"sssp {f} differs from sssp_batch lane 0")
    want_pr = R.pagerank_ref(g, iters=20).astype(np.float64)
    got_pr = r_pr.rank.cpu().numpy()
    if got_pr.shape != (n,) or not np.isfinite(got_pr).all():
        raise AssertionError("pagerank ranks are not n finite values")
    pr_rel = float((np.abs(got_pr - want_pr) / want_pr).max())
    if pr_rel > PR_RTOL or r_pr.iterations != 20:
        raise AssertionError(f"pagerank off the oracle by {pr_rel} "
                             f"(relative)")
    print(f"validated against numpy BFS, scipy Dijkstra and numpy "
          f"PageRank (max |rank error| / rank {pr_rel:.3g}, limit "
          f"{PR_RTOL:g}) in {time.monotonic() - t0:.1f} s")

    # ---- where the time goes: the batched main path once more under
    # torch.profiler (its overhead inflates the wall time; the device
    # time per kernel is what it is for) ----
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        bfs_batch(g, sources, backend="cuda")
        sssp_batch(g, sources, backend="cuda")
        pagerank(g, max_iter=20, backend="cuda")
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    # device-side events only: a host op's row repeats its kernels' time
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy = sum(r[0] for r in rows) / 1e3
    print(f"profiled bfs_batch+sssp_batch+pagerank: wall {wall * 1e3:.1f} "
          f"ms, device busy {busy:.1f} ms, idle share "
          f"{1 - busy / (wall * 1e3):.3f}")
    for us, count, key in sorted(rows, reverse=True)[:12]:
        print(f"  {us / 1e3:10.3f} ms {count:6d}x  {key[:90]}")

    kernels = []
    for name, k in K.KERNELS.items():
        kernels.append({"name": name, "route": "cuda", "source": k.source,
                        "replaces": k.replaces,
                        "launches": launches[name], **results[name]})
    print(f"total {time.monotonic() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
