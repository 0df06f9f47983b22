#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA Hopper card.

  python3 chip_smoke.py [--scale 22]

``--scale`` cuts the rmat graph for a quick check after a kernel edit;
the default, 22, is the main path's size. Triangle counting runs at
min(scale, 18) and its unfiltered variant two scales lower, whose
expansion (Σ min(deg(u), deg(v)) slots over every edge) passes int32
from scale 18 on (PERF.md §4). Label propagation and subgraph matching
run at min(scale, 16): LP sweeps all n labels every iteration (m·n
products), and the triangle query's join expands about Σ deg² slots,
which passes int32 from scale 17 on.

Phases:
  1. device and build — the card's name and power limit, the PyTorch and
     CUDA toolkit versions, and the build of the six CUDA kernels from
     ``src/repro_torch/kernels/csrc`` (one nvcc per source, in parallel
     with the host-side graph generation);
  2. kernel vs plain — each kernel's wrapper against its plain PyTorch
     version on the same card tensors, at the main path's shapes on the
     rmat graph (two capacity tiers, the top one included; B = 1 and
     B = 4), integer outputs equal and the SpMV bit-equal to its plain
     version run on the CPU; K3 (B = 1) and K5 (locate) at triangle
     counting's shape, the mxm expansion of the oriented rmat scale-18
     graph (6.6e8 slots); K5 (found) on segmented_intersect's probes of
     edge pairs of the scale-22 graph, and on an empty haystack; K4m
     (spmm) bit-equal to its plain version on integer-valued blocks over
     five semirings x (structural, weighted) x (masked, unmasked) x
     k in {1, 4, 5, 32, 33}, and at reach's and label propagation's
     shapes; each kernel timed beside its plain version, one PyTorch
     library call where one computes the same function, and the least
     time the card could take;
  3. main path — (a) the first slice's: bfs from the max-degree vertex,
     bfs_batch, sssp, sssp_batch and 20 PageRank sweeps; (b) the second
     slice's: connected components and bc_batch at scale 22,
     triangle_count at scale 18 and triangle_count_full at scale 16;
     (c) the third slice's: reach_batch (3 hops) and who_to_follow at
     scale 22, label_propagation and the triangle query of
     subgraph_match at scale 16 — all on the cuda backend, validated
     against host oracles (numpy BFS hop counts, scipy Dijkstra, a numpy
     power iteration, scipy components, numpy Brandes, scipy products
     for the triangles, a sort-based LP, float64 PPR and SALSA, 6 x the
     triangle count); each path runs with the launch counters set to 0
     and every kernel of it must have launched;
  4. where the time goes — path (a)'s batched primitives, then paths
     (b) and (c), once more under torch.profiler: device busy time,
     idle share, top kernels.

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
TC_SCALE = 18
LP_SCALE = 16          # label propagation and subgraph matching
HOPS = 3               # reach's k
WTF_K = 1000           # circle of trust
WTF_TOL = 1e-5         # PPR / SALSA against float64 (atomic float sums)
TRIANGLE = [(0, 1), (0, 2), (1, 2)]
INT32_MAX = 2 ** 31 - 1
K4M_HEAVY = 1024       # spmm splits longer rows over a block (spmv.cu)
# triangles of rmat(scale, 16, seed=0), counted by a chunked scipy product
TRIANGLES = {14: 2_808_907, 16: 15_681_649, 18: 82_931_365}


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
    from repro_torch.core.primitives import (bc_batch, bfs, bfs_batch,
                                             connected_components,
                                             label_propagation, pagerank,
                                             reach_batch, sssp, sssp_batch,
                                             subgraph_match, triangle_count,
                                             triangle_count_full,
                                             who_to_follow)
    from repro_torch.core.primitives import tc as TC
    from repro_torch.core.primitives.pagerank import _inv_out_degrees
    from repro_torch.kernels import ops as K
    from repro_torch.kernels import ref as P
    from repro_torch.kernels import runtime
    from repro_torch.linalg import ops as L
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

    # K3 (B = 1) and K5 (locate) at triangle counting's shape: the mxm
    # expansion of the oriented rmat graph, every slot live
    tc_scale = min(args.scale, TC_SCALE)
    t0 = time.monotonic()
    g_tc = G.rmat(tc_scale, EDGE_FACTOR, seed=0, weighted=True, device=dev)
    sub, ssrc, sdst = TC._orient(g_tc)
    (a_off, a_idx, _), (bt_off, bt_idx, _), base, probe, cap = L.mxm_plan(
        sub, sub, (ssrc, sdst), b_transpose=True)
    sizes = (torch.index_select(a_off, 0, base + 1)
             - torch.index_select(a_off, 0, base)).to(torch.int32)
    n_tc, m_sub = g_tc.num_vertices, sub.num_edges
    print(f"TC shape: rmat scale {tc_scale}, m={g_tc.num_edges}, oriented "
          f"m'={m_sub}, mxm expansion {cap} slots (host "
          f"{time.monotonic() - t0:.1f} s)")

    def k3t():
        return K.advance(a_off, a_idx, base, sizes, cap)

    def p3t():
        return O._advance_torch(a_off, a_idx, base, sizes, cap)

    equal_ints("advance (B=1, TC shape)", k3t(), p3t())
    torch.cuda.empty_cache()
    ms, pms = _timed(torch, k3t, 3), _timed(torch, p3t, 1)
    nbytes = m_sub * 16 + cap * 4 + cap * 21
    print(f"K3 advance B=1 cap_out={cap} (TC shape): {ms:.3f} ms, plain "
          f"{pms:.3f} ms, bound "
          f"{_bound_ms(nbytes, cap * (K._iters(m_sub) * 4 + 8))[0]:.3f} ms")
    _, needles, _, pair, _, _, _ = k3t()
    rows = torch.index_select(probe, 0, pair)
    del pair
    lo = torch.index_select(bt_off, 0, rows)
    hi = torch.index_select(bt_off, 0, rows + 1)
    torch.cuda.empty_cache()

    def k5l():
        return K.segment_locate(bt_idx, lo, hi, needles)

    def p5l():
        return P.segment_locate(bt_idx, lo, hi, needles)

    pos = k5l()
    equal_ints("segment_search (locate)", [pos], [p5l()])
    # the library call: in mxm every [lo, hi) is one whole CSR row, so
    # torch.searchsorted over (row, column) keys finds the same positions
    keys = sub.row_seg.long() * n_tc + bt_idx.long()
    query = rows.long() * n_tc + needles.long()
    del rows

    def lib5():
        return torch.searchsorted(keys, query)

    lpos = lib5()
    hit = pos >= 0
    if not torch.equal(lpos[hit], pos[hit].long()) or bool(
            (keys[lpos[~hit].clamp(max=m_sub - 1)] == query[~hit]).any()):
        raise AssertionError("segment_search (locate) differs from "
                             "torch.searchsorted")
    n_hit = int(hit.sum())
    del lpos, hit, pos
    ms, pms, lms = (_timed(torch, k5l, 10), _timed(torch, p5l, 1),
                    _timed(torch, lib5, 3))
    # each lane reads needle, lo, hi and writes one int32; the haystack
    # once. Operations: at most floor(log2 len) + 1 steps of ~5 per lane
    seg = (hi - lo).clamp(min=1).to(torch.float32)
    steps = float(torch.where(hi > lo, torch.floor(torch.log2(seg)) + 1,
                              0.0).sum(dtype=torch.float64))
    nbytes, ops = cap * 16 + m_sub * 4, steps * 5 + cap * 4
    print(f"K5 segment_search locate cap={cap} hits={n_hit} (TC shape): "
          f"{ms:.3f} ms, plain {pms:.3f} ms, torch.searchsorted {lms:.3f} "
          f"ms, bound {_bound_ms(nbytes, ops)[0]:.3f} ms")
    record("segment_search", 0, ms, pms, nbytes, ops, lms)
    del keys, query, seg, needles, lo, hi, base, probe, sizes
    torch.cuda.empty_cache()

    # K5 (found) on segmented_intersect's probes: edges (u, v) of the
    # scale-22 graph drawn at random, as many as keep the expansion at
    # most 3e8 slots; their neighbour lists are probed from HBM
    rng = np.random.default_rng(1)
    e_ids = torch.from_numpy(rng.integers(0, m, 1 << 20)).to(dev)
    pu = torch.index_select(g.row_seg, 0, e_ids)
    pv = torch.index_select(ci, 0, e_ids)
    mins = torch.minimum(g.degrees[pu.long()], g.degrees[pv.long()])
    npairs = int((torch.cumsum(mins.long(), 0) <= 3 * 10 ** 8).sum())
    need = int(mins[:npairs].sum())
    length = torch.tensor(npairs, dtype=torch.int32, device=dev)
    fa = F.SparseFrontier(ids=pu[:npairs].contiguous(), length=length)
    fb = F.SparseFrontier(ids=pv[:npairs].contiguous(), length=length)
    needles, lo, hi, _, _ = O._intersect_probes(g, fa, fb, need, "cuda")

    def k5f():
        return K.segment_search(ci, lo, hi, needles)

    def p5f():
        return P.segment_search(ci, lo, hi, needles)

    found = k5f()
    equal_ints("segment_search (found)", [found], [p5f()])
    keys = g.row_seg.long() * n + ci.long()
    query = ((torch.searchsorted(ro, lo, right=True) - 1).long() * n
             + needles.long())

    def lib5f():
        return torch.searchsorted(keys, query)

    lfound = keys[lib5f().clamp_(max=m - 1)] == query
    if not torch.equal(lfound, found):
        raise AssertionError("segment_search (found) differs from "
                             "torch.searchsorted")
    del lfound
    ms, pms, lms = (_timed(torch, k5f, 10), _timed(torch, p5f, 1),
                    _timed(torch, lib5f, 3))
    # 13 B per lane (needle, lo, hi, one bool); no haystack term: each
    # probe reads ~log2(deg) entries of one row, a small part of the
    # 513 MB of columns, and which entries it reads is not counted
    print(f"K5 segment_search found pairs={npairs} cap={need} hits="
          f"{int(found.sum())} (scale {args.scale}): {ms:.3f} ms, plain "
          f"{pms:.3f} ms, torch.searchsorted {lms:.3f} ms, bound "
          f"{_bound_ms(need * 13, 0)[0]:.3f} ms")
    del keys, query, found, needles, lo, hi
    torch.cuda.empty_cache()
    r_k = O.segmented_intersect(g, fa, fb, need, backend="cuda")
    r_p = O.segmented_intersect(g, fa, fb, need, backend="torch")
    equal_ints("segmented_intersect", r_k, r_p)
    print(f"segmented_intersect of {npairs} edge pairs: {int(r_k.total)} "
          f"common neighbours, cuda equal to torch")
    del r_k, r_p, fa, fb, pu, pv, mins, e_ids

    # K5 on an empty haystack: nothing is read, nothing found
    empty = torch.zeros((0,), dtype=torch.int32, device=dev)
    lo0 = torch.zeros((1 << 16,), dtype=torch.int32, device=dev)
    nd0 = torch.arange(1 << 16, dtype=torch.int32, device=dev)
    equal_ints("segment_search (empty haystack)",
               [K.segment_search(empty, lo0, lo0 + 1, nd0),
                K.segment_locate(empty, lo0, lo0 + 1, nd0)],
               [P.segment_search(empty, lo0, lo0 + 1, nd0),
                P.segment_locate(empty, lo0, lo0 + 1, nd0)])
    print("K5 on an empty haystack: equal to the plain version")
    torch.cuda.empty_cache()

    # K4m: the SpMM kernel against its plain version (run on the card,
    # whose plus fold is an atomic index_add_). Integer-valued blocks and
    # the integer weights make every semiring's fold exact in any order,
    # so the two must agree bit for bit: five semirings x (structural,
    # weighted) x (masked, unmasked) x k on rmat scale 14
    gen = torch.Generator(device=dev).manual_seed(7)
    rowmask_d = rowmask.to(dev)
    for k in (1, 4, 5, 32, 33):
        xk = torch.randint(0, 4, (gs.num_vertices, k), generator=gen,
                           device=dev).to(torch.float32)
        for name, sr in SR.SEMIRINGS.items():
            for vals in (None, gs.edge_values):
                for mask in (None, rowmask_d):
                    args_k = (gs.row_offsets, gs.col_indices, vals, xk, sr,
                              gs.ell_width, mask, gs.row_seg)
                    if not torch.equal(K.spmm(*args_k), P.spmm(*args_k)):
                        raise AssertionError(f"spmm {name} k={k} differs "
                                             f"from the plain version")
    # general floats, plus_times: at k >= 32, on rows of at most
    # K4M_HEAVY edges, each lane folds its column in ascending edge order,
    # as the plain version on the CPU does (bit for bit); elsewhere the
    # edge groups and a heavy row's per-warp shares regroup each sum
    # (rtol 1e-5, the reference's own limit between its two providers)
    light = (gs.degrees <= K4M_HEAVY).cpu()
    float_err = 0.0
    for k in (4, 32, 33):
        xf = torch.rand((gs.num_vertices, k), generator=gen, device=dev)
        args_k = (gs.row_offsets, gs.col_indices, gs.edge_values, xf,
                  SR.plus_times, gs.ell_width, None, gs.row_seg)
        got = K.spmm(*args_k).cpu()
        want = P.spmm(*(a.cpu() if torch.is_tensor(a) else a
                        for a in args_k))
        rel = float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())
        if (k >= 32 and not torch.equal(got[light], want[light])
                or rel > 1e-5):
            raise AssertionError(f"spmm plus_times k={k} on floats off its "
                                 f"plain version by {rel:.3g} (relative)")
        float_err = max(float_err, rel)
    print(f"K4m spmm: five semirings x (structural, weighted) x (masked, "
          f"unmasked) x k in (1, 4, 5, 32, 33) bit-equal to the plain "
          f"version on integer-valued blocks (rmat scale 14); float "
          f"plus_times bit-equal at k = 32, 33 on the rows of at most "
          f"{K4M_HEAVY} edges, max relative error {float_err:.3g}")

    rng = np.random.default_rng(0)
    sources = [hubs[0]] + [int(v) for v in rng.choice(
        np.flatnonzero(deg_np > 0), b - 1, replace=False)]
    hub = sources[0]

    # K4m at reach's shape: the scale-22 CSC, k = 4 (path a's sources),
    # or_and, the second hop (R after one hop, masked to the rows some
    # lane has not reached); cuSPARSE's plus_times product of the same
    # block is the library yardstick (its counts, > 0, are the or)
    r_hop = torch.zeros((n, b), dtype=torch.float32, device=dev)
    r_hop[torch.tensor(sources, device=dev), torch.arange(b, device=dev)] = 1
    csc = (g.csc_offsets, g.csc_indices, None)
    r_hop = torch.maximum(r_hop, K.spmm(
        *csc, r_hop, SR.or_and, g.csc_ell_width,
        torch.amin(r_hop, dim=1) < 1, g.csc_row_seg))
    need = torch.amin(r_hop, dim=1) < 1
    reach_args = (*csc, r_hop, SR.or_and, g.csc_ell_width, need,
                  g.csc_row_seg)

    def k4r():
        return K.spmm(*reach_args)

    def p4r():
        return P.spmm(*reach_args)

    a_csc = torch.sparse_csr_tensor(g.csc_offsets, g.csc_indices,
                                    torch.ones(m, device=dev), size=(n, n))

    def lib4r():
        return torch.sparse.mm(a_csc, r_hop)

    y_k = k4r()
    equal_ints("spmm (reach shape)", [y_k], [p4r()])
    if not torch.equal(y_k > 0, (lib4r() > 0) & need[:, None]):
        raise AssertionError("spmm (reach shape) differs from torch.sparse")
    ms_r, pms_r, lms_r = (_timed(torch, k4r, 10), _timed(torch, p4r, 2),
                          _timed(torch, lib4r, 10))
    m_live = int(torch.where(need, g.csc_offsets[1:] - g.csc_offsets[:-1],
                             0).sum(dtype=torch.int64))
    # offsets, mask, the live rows' columns, X once, Y once
    nbytes_r = (n + 1) * 4 + n + m_live * 4 + 2 * n * b * 4
    bound_r = _bound_ms(nbytes_r, 2 * m_live * b)[0]
    print(f"K4m spmm or_and k={b} (reach's 2nd hop, {int(need.sum())} rows "
          f"live, {m_live} edges): {ms_r:.3f} ms, plain {pms_r:.3f} ms, "
          f"torch.sparse.mm {lms_r:.3f} ms, bound {bound_r:.3f} ms")
    del a_csc, y_k, r_hop, need, reach_args
    torch.cuda.empty_cache()

    # K4m at label propagation's shape: rmat scale 16, k = 32, the
    # one-hot block of the first 32 labels of the first iteration
    # (labels0 = arange(n)); plus_times, the vote counts
    lp_scale = min(args.scale, LP_SCALE)
    g16 = G.rmat(lp_scale, EDGE_FACTOR, seed=0, weighted=True, device=dev)
    n16, m16 = g16.num_vertices, g16.num_edges
    lanes32 = torch.arange(32, dtype=torch.int32, device=dev)
    onehot = (torch.arange(n16, dtype=torch.int32, device=dev)[:, None]
              == lanes32[None, :]).to(torch.float32)
    lp_args = (g16.row_offsets, g16.col_indices, None, onehot,
               SR.plus_times, g16.ell_width, None, g16.row_seg)

    def k4l():
        return K.spmm(*lp_args)

    def p4l():
        return P.spmm(*lp_args)

    a16 = torch.sparse_csr_tensor(g16.row_offsets, g16.col_indices,
                                  torch.ones(m16, device=dev),
                                  size=(n16, n16))

    def lib4l():
        return torch.sparse.mm(a16, onehot)

    y_k = k4l()
    equal_ints("spmm (label propagation shape)", [y_k], [p4l()])
    lib_err = float((y_k - lib4l()).abs().max())
    ms, pms, lms = (_timed(torch, k4l, 50), _timed(torch, p4l, 5),
                    _timed(torch, lib4l, 50))
    nbytes = (n16 + 1) * 4 + m16 * 4 + 2 * n16 * 32 * 4
    print(f"K4m spmm plus_times k=32 (label propagation, rmat scale "
          f"{lp_scale}: n={n16} m={m16}): {ms:.3f} ms, plain {pms:.3f} ms, "
          f"torch.sparse.mm {lms:.3f} ms (max |difference| {lib_err:g}), "
          f"bound {_bound_ms(nbytes, 2 * m16 * 32)[0]:.3f} ms")
    record("spmm", 0, ms, pms, nbytes, 2 * m16 * 32, lms)
    del a16, y_k, onehot, lp_args
    torch.cuda.empty_cache()

    # ---- phase 3: the main path on the cuda backend ----
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
    print(f"main path (a) launches: {launches}; peak device memory "
          f"{peak / 2 ** 30:.2f} GiB")
    missing = [k for k in ("advance_filter_batch", "compact",
                           "advance_batch", "spmv") if launches[k] == 0]
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
    depths = [R.bfs_ref(g, s) for s in sources]     # reach reuses them
    for i, want in enumerate(depths):
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
    pr_rel = R.pagerank_rel_err(r_pr.rank.cpu().numpy(),
                                R.pagerank_ref(g, iters=20))
    if pr_rel > R.PR_RTOL or r_pr.iterations != 20:
        raise AssertionError(f"pagerank off the oracle by {pr_rel} "
                             f"(relative)")
    print(f"validated against numpy BFS, scipy Dijkstra and numpy "
          f"PageRank (max |rank error| / rank {pr_rel:.3g}, limit "
          f"{R.PR_RTOL:g}) in {time.monotonic() - t0:.1f} s")

    # ---- phase 3 (b): the second slice's path: cc and bc_batch at the
    # main scale, triangle counting (K3 + K5 through mxm) ----
    g_full = G.rmat(tc_scale - 2, EDGE_FACTOR, seed=0, weighted=True,
                    device=dev)
    torch.cuda.empty_cache()
    K.reset_launches()
    torch.cuda.synchronize()
    timings2 = {}

    def run2(label, fn):
        torch.cuda.synchronize()
        t = time.monotonic()
        out = fn()
        torch.cuda.synchronize()
        timings2[label] = time.monotonic() - t
        return out

    r_cc = run2("cc", lambda: connected_components(g, backend="cuda"))
    r_bc = run2("bc_batch", lambda: bc_batch(g, sources, backend="cuda"))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    r_tc = run2("tc", lambda: triangle_count(g_tc, backend="cuda"))
    tc_peak = torch.cuda.max_memory_allocated()
    r_tcs = run2("tc_small", lambda: triangle_count(g_full, backend="cuda"))
    r_tcf = run2("tc_full",
                 lambda: triangle_count_full(g_full, backend="cuda"))
    launches2 = {k: v.launches for k, v in K.KERNELS.items()}
    print(f"main path (b) launches: {launches2}; triangle_count peak "
          f"device memory {tc_peak / 2 ** 30:.2f} GiB "
          f"({(tc_peak - held) / 2 ** 30:.2f} GiB above the "
          f"{held / 2 ** 30:.2f} GiB held before it)")
    missing = [k for k in ("advance_batch", "segment_search")
               if launches2[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    edges2 = {"cc": m, "bc_batch": 2 * m * b, "tc": g_tc.num_edges,
              "tc_small": g_full.num_edges, "tc_full": g_full.num_edges}
    for label, dt in timings2.items():
        print(f"{label:10s} {dt * 1e3:10.2f} ms "
              f"{edges2[label] / dt / 1e6:10.2f} MTEPS")
    print(f"cc iterations {r_cc.iterations}, components "
          f"{int(r_cc.num_components)}; bc levels "
          f"{r_bc.max_level.tolist()}; triangles: scale {tc_scale} "
          f"{int(r_tc.total)}, scale {tc_scale - 2} {int(r_tcs.total)} "
          f"(unfiltered {int(r_tcf)})")

    t0 = time.monotonic()
    if not np.array_equal(r_cc.labels.cpu().numpy(), R.cc_ref(g)):
        raise AssertionError("cc labels differ from scipy's components")
    bc_err = 0.0
    for i, s in enumerate(sources):
        got, want = r_bc.bc[i].cpu().numpy(), R.bc_ref(g, s)
        if not np.allclose(got, want, rtol=1e-3, atol=1e-3):
            raise AssertionError(f"bc_batch lane {i} differs from Brandes")
        bc_err = max(bc_err, float((np.abs(got - want) / np.maximum(
            np.abs(want), 1.0)).max()))
    total = int(r_tc.total)
    if (total != R.tc_ref(g_tc) or total != int(r_tc.per_edge.long().sum())
            or total != TRIANGLES.get(tc_scale, total)):
        raise AssertionError(f"triangle_count {total} differs from the "
                             f"oracle")
    small = int(r_tcs.total)
    if (small != int(r_tcf) or small != R.tc_ref(g_full)
            or small != TRIANGLES.get(tc_scale - 2, small)):
        raise AssertionError(f"triangle_count_full {int(r_tcf)} / "
                             f"triangle_count {small} differ")
    print(f"validated cc against scipy, bc_batch against numpy Brandes "
          f"(max |error| / max(|bc|, 1) {bc_err:.3g}; limit rtol 1e-3, "
          f"atol 1e-3) and the triangles against scipy in "
          f"{time.monotonic() - t0:.1f} s")
    del r_cc, r_bc, r_tc, r_tcs, r_tcf, g_full, sub
    torch.cuda.empty_cache()

    # ---- phase 3 (c): the third slice's path: reach_batch and
    # who_to_follow at the main scale, label_propagation and the triangle
    # query of subgraph_match at scale 16 ----
    deg16 = g16.degrees.cpu().numpy().astype(np.int64)
    join_bound = int((deg16 * deg16).sum())
    if join_bound > INT32_MAX:
        raise AssertionError(f"the triangle join may expand {join_bound:,} "
                             f"slots at rmat scale {lp_scale}, past int32")
    tri = int(triangle_count(g16, backend="cuda").total)
    sm_cap = max(6 * tri, m16)
    print(f"path (c) graph: rmat scale {lp_scale} n={n16} m={m16} max_deg="
          f"{deg16.max()}, Σ deg² {join_bound:,} (the triangle join's "
          f"expansion bound), {tri} triangles, subgraph cap {sm_cap}")
    torch.cuda.empty_cache()
    K.reset_launches()
    timings3 = {}

    def run3(label, fn):
        torch.cuda.synchronize()
        t = time.monotonic()
        out = fn()
        torch.cuda.synchronize()
        timings3[label] = time.monotonic() - t
        return out

    r_reach = run3("reach_batch",
                   lambda: reach_batch(g, sources, HOPS, backend="cuda"))
    r_lp = run3("label_propagation",
                lambda: label_propagation(g16, max_iter=30, backend="cuda"))
    r_wtf = run3("wtf", lambda: who_to_follow(
        g, hub, k=WTF_K, ppr_iters=30, salsa_iters=10, backend="cuda"))
    before = K.KERNELS["segment_search"].launches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    r_sm = run3("subgraph_match", lambda: subgraph_match(
        g16, 3, TRIANGLE, cap=sm_cap, backend="cuda"))
    sm_peak = torch.cuda.max_memory_allocated()
    join_probes = K.KERNELS["segment_search"].launches - before
    launches3 = {k: v.launches for k, v in K.KERNELS.items()}
    print(f"main path (c) launches: {launches3} ({join_probes} K5 launches "
          f"in subgraph_match's join); subgraph_match peak device memory "
          f"{sm_peak / 2 ** 30:.2f} GiB ({(sm_peak - held) / 2 ** 30:.2f} "
          f"GiB above the {held / 2 ** 30:.2f} GiB held before it)")
    missing = [k for k in ("spmm", "compact") if launches3[k] == 0]
    if missing or join_probes == 0:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing + ['segment_search'] * (not join_probes)}")
    edges3 = {"reach_batch": m * HOPS * b,
              "label_propagation": m16 * r_lp.iterations, "wtf": m,
              "subgraph_match": m16}
    for label, dt in timings3.items():
        print(f"{label:17s} {dt * 1e3:10.2f} ms "
              f"{edges3[label] / dt / 1e6:10.2f} MTEPS")
    print(f"reach counts {r_reach.counts.tolist()}; label_propagation "
          f"{r_lp.iterations} iterations, "
          f"{int(torch.unique(r_lp.labels).numel())} labels; subgraph "
          f"{r_sm.count} embeddings")

    t0 = time.monotonic()
    for i, dep in enumerate(depths):
        want = (dep >= 0) & (dep <= HOPS)
        if not np.array_equal(r_reach.reached[i].cpu().numpy(), want):
            raise AssertionError(f"reach_batch lane {i} differs from BFS "
                                 f"depth <= {HOPS}")
    lp_labels, lp_iters = R.label_propagation_ref(g16, max_iter=30)
    if (not np.array_equal(r_lp.labels.cpu().numpy(), lp_labels)
            or r_lp.iterations != lp_iters):
        raise AssertionError("label_propagation differs from the oracle")
    # who-to-follow: PPR against float64, the circle of trust against the
    # oracle's top k up to swaps among ranks within the tolerance of its
    # k-th, SALSA against float64 on the port's own circle
    ppr = r_wtf.ppr.cpu().numpy()
    ppr_want = R.ppr_ref(g, hub, iters=30)
    ppr_err = float(np.abs(ppr.astype(np.float64) - ppr_want).max())
    cot = r_wtf.cot.cpu().numpy()
    ranked = ppr_want.astype(np.float64)
    ranked[hub] = -np.inf
    cot_want = np.argsort(-ranked, kind="stable")[:len(cot)]
    kth = ranked[cot_want[-1]]
    swapped = np.setxor1d(cot, cot_want)
    if (ppr_err > WTF_TOL or hub in cot or len(np.unique(cot)) != len(cot)
            or (np.abs(ranked[swapped] - kth) > WTF_TOL).any()):
        raise AssertionError(f"who_to_follow: PPR off by {ppr_err:.3g} or "
                             f"its circle of trust differs")
    hubs_cot = np.zeros(n, bool)
    hubs_cot[cot[ppr[cot] > 0]] = True
    h_want, a_want = R.salsa_ref(g, hubs_cot, iters=10)
    salsa_err = max(
        float(np.abs(r_wtf.hub_scores.cpu().numpy() - h_want).max()),
        float(np.abs(r_wtf.auth_scores.cpu().numpy() - a_want).max()))
    if salsa_err > WTF_TOL:
        raise AssertionError(f"who_to_follow SALSA off by {salsa_err:.3g}")
    # subgraph matching: 6 ordered embeddings per triangle, each of
    # distinct vertices with every query edge in the graph, and the same
    # table as the torch backend on the card
    if r_sm.count != 6 * tri or r_sm.truncated or tri != TRIANGLES.get(
            lp_scale, tri):
        raise AssertionError(f"subgraph_match found {r_sm.count} triangle "
                             f"embeddings, not 6 x {tri}")
    emb = r_sm.embeddings[:r_sm.count].long()
    keys = g16.row_seg.long() * n16 + g16.col_indices.long()
    for a, c in TRIANGLE:
        q = emb[:, a] * n16 + emb[:, c]
        pos = torch.searchsorted(keys, q).clamp_(max=m16 - 1)
        if not bool((keys[pos] == q).all() and (emb[:, a] != emb[:, c])
                    .all()):
            raise AssertionError(f"a subgraph embedding lacks the query "
                                 f"edge ({a}, {c})")
    del emb, keys, q, pos
    torch.cuda.empty_cache()
    r_smt = subgraph_match(g16, 3, TRIANGLE, cap=sm_cap, backend="torch")
    if r_smt.count != r_sm.count or not torch.equal(r_smt.embeddings,
                                                    r_sm.embeddings):
        raise AssertionError("subgraph_match differs between the cuda and "
                             "torch backends")
    print(f"validated reach_batch against BFS depth <= {HOPS}, "
          f"label_propagation against the sort-based oracle, "
          f"who_to_follow against float64 PPR (max |error| {ppr_err:.3g}) "
          f"and SALSA ({salsa_err:.3g}; limit {WTF_TOL:g}; {len(swapped)} "
          f"circle-of-trust ids swapped at ties), subgraph_match against "
          f"6 x the triangle count and the torch backend, in "
          f"{time.monotonic() - t0:.1f} s")
    del r_reach, r_lp, r_wtf, r_sm, r_smt
    torch.cuda.empty_cache()

    # ---- where the time goes: each slice's path once more under
    # torch.profiler (its overhead inflates the wall time; the device
    # time per kernel is what it is for) ----
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def profiled(label, fn, top):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            fn()
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
        # device-side events only: a host op's row repeats its kernels'
        rows = [(e.self_device_time_total, e.count, e.key)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.self_device_time_total > 0]
        busy = sum(r[0] for r in rows) / 1e3
        print(f"profiled {label}: wall {wall * 1e3:.1f} ms, device busy "
              f"{busy:.1f} ms, idle share {1 - busy / (wall * 1e3):.3f}")
        for us, count, key in sorted(rows, reverse=True)[:top]:
            print(f"  {us / 1e3:10.3f} ms {count:6d}x  {key[:90]}")

    def path_a():
        bfs_batch(g, sources, backend="cuda")
        sssp_batch(g, sources, backend="cuda")
        pagerank(g, max_iter=20, backend="cuda")

    def path_b():
        connected_components(g, backend="cuda")
        bc_batch(g, sources, backend="cuda")
        triangle_count(g_tc, backend="cuda")

    def path_c():
        reach_batch(g, sources, HOPS, backend="cuda")
        label_propagation(g16, max_iter=2, backend="cuda")
        who_to_follow(g, hub, k=WTF_K, ppr_iters=30, salsa_iters=10,
                      backend="cuda")
        subgraph_match(g16, 3, TRIANGLE, cap=sm_cap, backend="cuda")

    profiled("bfs_batch+sssp_batch+pagerank", path_a, 12)
    profiled("cc+bc_batch+triangle_count", path_b, 12)
    profiled("reach_batch+label_propagation (2 iterations)+wtf+"
             "subgraph_match", path_c, 12)
    del g_tc, g16

    kernels = []
    for name, k in K.KERNELS.items():
        kernels.append({"name": name, "route": "cuda", "source": k.source,
                        "replaces": k.replaces,
                        "launches": (launches[name] + launches2[name]
                                     + launches3[name]),
                        **results[name]})
    print(f"total {time.monotonic() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
