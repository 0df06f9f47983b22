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
     CUDA toolkit versions, and the build of the ten CUDA kernels from
     ``src/repro_torch/kernels/csrc`` (one nvcc per source, in parallel
     with the host-side graph generation);
  2. kernel vs plain — each kernel's wrapper against its plain PyTorch
     version on the same card tensors, at the main path's shapes on the
     rmat graph (two capacity tiers, the top one included; B = 1 and
     B = 4), integer outputs equal and the SpMV bit-equal to its plain
     version run on the CPU, timed whole and on its light and heavy rows
     beside its byte bound and the serial-chain floor of its longest
     overflow; K1, K2, K3 and K6 also with the device operations one call
     puts on the card and their device time (torch.profiler; a K3 or K6
     call may show nothing but its two kernels, and at least one K3 call
     and the K6 call must show exactly those), K1 and K2 with a practical
     floor beside the byte bound (streamed bytes at the rate of a device
     copy, the random accesses the function needs at the rate of an
     index_select from an L2-resident table, both measured in the run),
     and K1's first-slot table checked all INT32_MAX after every call
     (its storage-plan variants too); K3 bit-equal on every slot, dead
     ones included, at every block size at each of its shapes (the SSSP
     near pile at cap_in = n, the grid, rmat-15 and the dense fallback,
     the TC shape); K3 (B = 1) and K5 (locate) at triangle
     counting's shape, the mxm expansion of the oriented rmat scale-18
     graph (6.6e8 slots); K5 (found) on segmented_intersect's probes of
     edge pairs of the scale-22 graph, on an empty haystack, and at
     subgraph_match's join on rmat-16 (its one probe launch, 1.2e9
     lanes, beside torch.searchsorted on (row, column) keys); K5
     (locate) at rmat-15's TC probes over int16, int32 and int64
     columns, each beside its bound and torch.searchsorted on (row,
     column) keys, in turns; every K5 call bit-equal to its
     plain version at every
     block size, with the device operations one call puts on the card
     (K5's one kernel, nothing else; printed); K4m
     (spmm) bit-equal to its plain version on integer-valued blocks over
     five semirings x (structural, weighted) x (masked, unmasked) x
     k in {1, 4, 5, 32, 33}, on uniform floats (plus_times) bit-equal
     on every row it does not split at each of those k, and at reach's
     and label propagation's shapes (the latter on the one-hot block and
     on uniform floats, beside the index_select of the rows it gathers);
     K6 (lb_expand) bit-equal on every slot at every block size at
     rmat-22's whole-graph expansion (2^27 slots), at a capacity that is
     no power of two, on zero-size segments, on a segment spanning 40
     tiles and at cap_in = 0; K7
     (flash_attention) at Qwen2-VL-2B's and Kimi K2's head widths (128,
     112) in bf16 and fp32 — prefill 8192 x 8192 causal, a 128-query
     chunk against 8192 keys, more queries than keys, non-causal —
     within one rounding of its output (bf16: rtol 8e-3, atol 1e-4) and
     3e-5 (fp32) of its plain version, rows that see no key exactly 0,
     its SASS holding tensor-core (HMMA) instructions in every
     instantiation, and at the chunk its split form (kv parts) and its
     combine kernel (K7c) each against their plain versions, K7c timed
     from a CUDA graph, by events and by its device time (bf16, 64
     parts; fp32, 128), the whole chunk call (one C call: K7, then K7c
     as a programmatic dependent launch; its device operations exactly
     those two) the same three ways beside SDPA; K8 (moe_gather)
     bit-equal at Kimi K2's
     dispatch (8192 x 7168 bf16 tokens, 384 experts x capacity 216), on
     shuffled, repeated, -1 and past-the-end slot ids and on rows that
     are no multiple of 16 bytes, its bytes beside those of a walk in
     slot order; every tuned kernel (K1,
     K2, K3, K4 at k = 1, K5, K6) bit-equal to its plain version at
     every block size from 64 to 1024 threads; each kernel timed beside
     its plain version, one PyTorch library call where one computes the
     same function, and the least time the card could take; (e) the
     storage plans' kernel variants, each bit-equal to its plain version
     and timed beside the int32 form on the same frontier: K1 and K3
     decoding the anchored-delta stream in the kernel at the grid's
     shape (grid2d 2048, a quarter of the vertices in each of 4 lanes),
     reading int16 and int64 columns at rmat scale 15, and on rmat-22's
     delta stream, whose escapes send it to the decoded dense view; K4
     at bf16 precision (plus_times and plus_and, structural and weighted,
     fp32 and bf16 values, on rmat scale 15; one PageRank sweep at
     rmat-22 against the plain version on the CPU) and K4m at bf16 at
     label propagation's shape;
  3. main path — (a) the first slice's: bfs from the max-degree vertex,
     bfs_batch, sssp, sssp_batch and 20 PageRank sweeps; (b) the second
     slice's: connected components and bc_batch at scale 22,
     triangle_count at scale 18 and triangle_count_full at scale 16;
     (c) the third slice's: reach_batch (3 hops) and who_to_follow at
     scale 22, label_propagation and the triangle query of
     subgraph_match at scale 16; (d) the fourth slice's: the kernel
     tuner (its five probes over the default capacity ladder, into a
     cache under build/, its picks printed) and the kernel API's
     lb_expand, flash_attention and moe_gather at phase 2's shapes; (e)
     the fifth slice's: the storage plans — bfs_batch (B = 4: push, pull,
     auto) and sssp_batch (B = 4) on grid2d 1024 and 20 PageRank sweeps
     on grid2d 2048 (n = 4,194,304, the road-network stand-in at
     rmat-22's vertex count) under dense int32 and under the escape-free
     delta encoding,
     and on rmat scale 15 (n = 32,768, the int16 ladder's top) under
     int16, int32 and int64, with triangle_count under int16 and int32,
     each plan bit-equal to its int32 twin; bfs_batch and sssp_batch on
     rmat-22's delta stream (escaped: the dense fallback) equal to int32;
     bf16 PageRank at rmat-22 within 1e-2 of fp32; resident_bytes of
     every plan; (f) the sixth slice's: serving — a clean
     ``graph_serve.serve_mixed`` stream at the main scale (64 queries,
     bfs / sssp / pagerank / reach interleaved, batch 4, path (a)'s
     sources among them: every query ok, nothing retried or declared,
     K1, K2, K3, K4 and K4m launched, every served lane bit-equal to a
     direct call of its primitive and, on path (a)'s sources, to paths
     (a) and (c)'s oracle-checked answers; qps, per-kind p50/p95/p99 and
     where a flush's host time goes beside its primitive's), a chaos
     stream at scale 16 under ``provider_miss@0.3;nan@0.2;straggler@0.1``
     (seed 0, 256 queries: one status a query, counters that reconcile,
     every clause fired, degraded answers from the torch rung on the
     card, no exception out of the stream), bfs with telemetry on and off at the main scale (bit-equal,
     its frontier column the level sizes, the same host reads — one a
     step — and synchronizing calls), and graph_serve's CLI at scale 16
     with ``--trace`` (the build, warmup and serve spans); (g) the
     seventh slice's: the paper's load-balancing and idempotence
     ablations — bfs_batch (push only, exact uniquify) and sssp_batch
     under LB, TWC and THREAD at the main scale on path (a)'s sources
     (Fig. 20) and on grid2d 256 (the mesh contrast), bfs_batch under
     TWC with idempotence x direction (Fig. 19, each lane's overflow
     printed), one advance of table8_utilization.py's hub frontier under
     each strategy (its utilization; a THREAD advance launches no K3),
     the filter family (exact and hash), partition_frontier,
     neighborhood_reduce and advance_to_edge_frontier on it, and the
     reference's oracle names at path (a)'s shapes, each equal to the
     kernel it models; labels and distances equal to the
     oracles and predecessors a valid tree wherever nothing overflowed,
     every TWC and THREAD run bit-equal to the same run on the torch
     backend on the card (TWC launching K3 and K2, THREAD K2 and no K3),
     with its times and peak device memory printed; (h) the eighth
     slice's: the sharded (1-D, 4 parts) and 2-D (2 x 2 vertex cut)
     placements with every part on the one card — distributed bfs,
     sssp, cc, pagerank (20 sweeps) and reach (path (c)'s sources, 3
     hops) at the main scale, label propagation and the masked product
     of triangle counting at scale 16, each bit-equal to its
     single-placement run on the card (paths (a)-(c)'s where they ran
     it) with no kernel launched under a placement; graph_serve
     ``--parts 4`` and ``--mesh 2x2`` at scale 16 with ``--validate``,
     and a chaos stream on the 2 x 2 mesh under ``shard_loss@0.2``
     (every degraded answer from a declared placement rung); (i) the
     ninth slice's: the analysis layer on the card; (j) the tenth
     slice's: LM serving of the seven dense / moe / vlm archs; (k) the
     eleventh slice's: the ssm, hybrid and encdec archs — their SMOKE
     configs card against CPU, Mamba2-780m, Zamba2-2.7B and
     Whisper-large-v3 (1,500 frames) whole in bf16, decode against
     direct, 0 host syncs a decode step, the chunked SSD against its
     recurrence at full width; (l) the twelfth slice's: LM training —
     a make_train_step step of the ten archs' SMOKE configs card
     against CPU (loss, gradients, params), MiniCPM-2B whole in bf16
     (B = 4, S = 512: 8 AdamW steps with fp32 moments, 2 under remat
     "dots" and "full", 4 with int8 moments; ms a step, tok/s and peak
     memory beside the bound, one step profiled), a checkpoint of its
     2-layer cut at full width saved and restored bit-equal,
     launch.train with an injected fault, the GPipe pipeline over a
     4-part mesh; run last, after the profiles below, when the earlier
     paths' graphs are freed; (j), (k) and (l) launch no kernel —
     all on the cuda backend, validated
     against host oracles (numpy BFS hop counts, scipy Dijkstra, a numpy
     power iteration, scipy components, numpy Brandes, scipy products
     for the triangles, a sort-based LP, float64 PPR and SALSA, 6 x the
     triangle count); each path runs with the launch counters set to 0
     and every kernel of it must have launched;
  4. where the time goes — path (a)'s batched primitives, then paths
     (b) and (c), path (e) on the delta grid (its BFS and SSSP at
     side 256, device events only; PageRank at 2048), path (g)'s TWC
     bfs_batch and 16 decode steps of MiniCPM-2B (path (j)) and of
     Mamba2-780m (path (k)), once more under torch.profiler: device busy
     time, idle share, device operations, top kernels; path (l) profiles
     one MiniCPM-2B train step itself.

Prints one JSON line of kernel numbers (each kernel with its launches by
variant — column storage or precision — and a row of its own for each
variant phase 2 (e) timed), then the card's name and power limit, then
``{"ok": true, "device": ...}`` as the last line. Any failure raises and
exits nonzero. Without a CUDA device, or outside a checkout
of the repository, it exits 2 and prints no result.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12         # non-tensor-core peak, the rate for int ops
TF32_OPS_PER_S = 495e12        # dense tensor-core peak, TF32
FADD_CYCLES = 4                # dependent fp32 add latency, cycles
EDGE_FACTOR = 16
BATCH = 4
TC_SCALE = 18
LP_SCALE = 16          # label propagation and subgraph matching
HOPS = 3               # reach's k
WTF_K = 1000           # circle of trust
WTF_TOL = 1e-5         # PPR / SALSA against float64 (atomic float sums)
TRIANGLE = [(0, 1), (0, 2), (1, 2)]
# path (i): a sanitized run of a call whose plain runs differ among
# themselves (float atomics) against the plain one
BC_RTOL = 1e-5
INT32_MAX = 2 ** 31 - 1
GRID_SIDE = 2048       # grid2d: n = 4,194,304, rmat-22's vertex count
GRID_TRAVERSAL_SIDE = 1024  # path (e)'s grid bfs_batch and sssp_batch
MESH_PARTS = 4         # path (h): the 1-D placement's parts ...
MESH_SHAPE = (2, 2)    # ... and the 2-D placement's mesh
LP_MESH_ITERS = 2      # path (h)'s label propagation sweeps
ORACLE_THREADS = 6     # paths (a) and (b)'s host oracles, side by side
TIMING_ROUNDS = 5      # interleaved rounds when plans are compared
PROFILE_GRID_SIDE = 256  # path (e)'s profiled BFS and SSSP
FIG20_GRID_SIDE = 512  # path (g)'s Fig. 20 mesh contrast
DEVICE_OPS_PAD = 0.25  # s of host idle around a one-call profiler session
INT16_SCALE = 15       # rmat scale 15: n = 32,768, the int16 ladder's top
# triangles of rmat(scale, 16, seed=0), counted by a chunked scipy product
TRIANGLES = {14: 2_808_907, 16: 15_681_649, 18: 82_931_365}
BF16_OPS_PER_S = 989e12        # dense tensor-core peak, bf16 and fp16
QWEN2_VL_HEAD = 128    # Qwen2-VL-2B: 1536 wide, 12 heads (arXiv:2409.12191)
KIMI_HEAD = 112        # Kimi K2, src/repro/configs/kimi_k2_1t_a32b.py
KIMI_D_MODEL = 7168
KIMI_EXPERTS, KIMI_TOP_K = 384, 8
MOE_TOKENS = 8192
MOE_CAPACITY_FACTOR = 1.25     # the reference's default (models/api.py)
# (label, Sq, Sk, causal): prefill, a chunk against a filled cache,
# more queries than keys (rows 0 .. Sq - Sk - 1 see none), non-causal
ATTENTION_SHAPES = (("prefill", 8192, 8192, True),
                    ("chunk", 128, 8192, True),
                    ("sq>sk", 2048, 1024, True),
                    ("non-causal", 4096, 4096, False))
# K7 against its plain version, (rtol, atol): fp32 within the reference's
# 3e-5; bf16 within one rounding of the output (an ulp is at most 2^-7 of
# the value), since both sides compute in fp32 and round once
ATTENTION_TOL = {"float32": (3e-5, 3e-5), "bfloat16": (8e-3, 1e-4)}


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def _sm_clock_mhz() -> float:
    """The card's maximum SM clock, as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return float(out[0])


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


def _graph_timed(torch, fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` on the card with the host out of the
    way: ``reps`` calls captured in a CUDA graph (after one warm-up call
    on a side stream), the graph replayed once, then one replay timed by
    CUDA events. For calls whose wrapper takes longer on the host than
    its kernels on the card, where ``_timed`` measures the host."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def _in_turns(torch, fns, reps: int) -> list:
    """The median ms of each of ``fns`` over TIMING_ROUNDS rounds of
    ``_timed``, taken in turns, the order rotated each round."""
    times = [[] for _ in fns]
    for r in range(TIMING_ROUNDS):
        for i in [(r + j) % len(fns) for j in range(len(fns))]:
            times[i].append(_timed(torch, fns[i], reps))
    return [statistics.median(t) for t in times]


def _bound_ms(nbytes: float, ops: float,
              rate: float = FP32_OPS_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _device_ops(torch, fn) -> tuple:
    """The device operations (kernels, memsets, copies) one warm call of
    ``fn`` puts on the card, by torch.profiler: ([(name, count)], their
    device ms, the operations a host and device session without the pad
    recorded). A session of one short call loses some or all of its
    device records minutes into a run, with most of the card's memory
    free; so the measured session traces the device alone and keeps the
    host idle ``DEVICE_OPS_PAD`` s before and after the call, and one
    host and device session without the pad is taken first, for
    comparison."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    sessions = []
    for acts, pad in (([ProfilerActivity.CPU, ProfilerActivity.CUDA], 0.0),
                      ([ProfilerActivity.CUDA], DEVICE_OPS_PAD)):
        with profile(activities=acts) as prof:
            time.sleep(pad)
            fn()
            torch.cuda.synchronize()
            time.sleep(pad)
        sessions.append([(e.key, e.count, e.self_device_time_total)
                         for e in prof.key_averages()
                         if e.device_type == DeviceType.CUDA
                         and e.self_device_time_total > 0])
    bare, rows = sessions
    return ([(k, c) for k, c, _ in rows], sum(r[2] for r in rows) / 1e3,
            sum(c for _, c, _ in bare))


LB_OPS = ("lb_offsets", "lb_expand_tiles")     # K3's and K6's two kernels


def _check_blocks(torch, what, kf, want, blocks) -> None:
    """Raises unless ``kf(t=t)`` equals ``want`` on every output and every
    slot at each block size t of ``blocks``."""
    for t in blocks:
        got = kf(t=t)
        for i, (x, y) in enumerate(zip(got, want)):
            if not torch.equal(x, y):
                raise AssertionError(f"{what} at {t} threads per block: "
                                     f"output {i} differs from the plain "
                                     f"version")
        del got


def _lb_ops(ops, bare, what, seen) -> str:
    """The device-ops text of a K3 or K6 call. Raises if the profiler
    recorded any operation but K3's / K6's two kernels, or one of them
    twice; ``seen`` collects the calls it recorded as exactly the two
    (a session that lost a record shows fewer and raises nothing)."""
    names = _ops_text(ops, bare)
    if any(c != 1 or not any(k in o for k in LB_OPS) for o, c in ops):
        raise AssertionError(f"{what}: {names}, expected exactly "
                             f"{LB_OPS}")
    if len(ops) == 2:
        seen.append(what)
    return names


K5_OP = "search_rows"                          # K5's one kernel


def _k5_ops(ops, bare, what, seen) -> str:
    """The device-ops text of a K5 call. Raises if the profiler recorded
    any operation but K5's kernel, or it twice; ``seen`` collects the
    calls recorded as exactly that one kernel."""
    names = _ops_text(ops, bare)
    if any(c != 1 or K5_OP not in o for o, c in ops):
        raise AssertionError(f"{what}: {names}, expected exactly {K5_OP}")
    if len(ops) == 1:
        seen.append(what)
    return names


K7_OPS = ("attn_kernel", "attn_combine")      # the split form's two


def _k7_ops(ops, bare, what) -> str:
    """The device-ops text of a split-form flash_attention call. Raises
    if the profiler recorded any operation but K7's and K7c's kernels,
    or one of them twice."""
    names = _ops_text(ops, bare)
    kinds = [k for o, _ in ops for k in K7_OPS if k in o]
    if any(c != 1 for _, c in ops) or len(kinds) != len(ops) or len(
            set(kinds)) != len(kinds):
        raise AssertionError(f"{what}: {names}, expected one of each of "
                             f"{K7_OPS}")
    return names


def _ops_text(ops, bare) -> str:
    """'3 device ops a call (lb_offsets, af_expand, af_emit; 0 in a session
    without the idle pad)'."""
    names = [re.sub(r"^(?:void )?(?:\(anonymous namespace\)::)?"
                    r"([A-Za-z_0-9]+).*$", r"\1", k) for k, _ in ops]
    return (f"{sum(c for _, c in ops)} device ops a call "
            f"({', '.join(names)}; {bare} in a session without the idle "
            f"pad)")


def _yardsticks(torch, dev) -> dict:
    """Two rates the card reaches in this run, the yardsticks of the
    practical floors: ``copy`` bytes a second of a device-to-device copy
    of 256 MB (each byte read and written once), and ``gather`` elements
    a second of index_select from a 16 MB int32 table (it stays in L2)
    at 2^25 random int32 indices (the 8 streamed bytes of an element
    included)."""
    gen = torch.Generator(device=dev).manual_seed(17)
    a = torch.empty(2 ** 26, dtype=torch.int32, device=dev)
    b = torch.empty_like(a)
    copy_ms = _timed(torch, lambda: b.copy_(a), 10)
    table = torch.randint(0, 2 ** 30, (2 ** 22,), generator=gen, device=dev,
                          dtype=torch.int32)
    idx = torch.randint(0, 2 ** 22, (2 ** 25,), generator=gen, device=dev,
                        dtype=torch.int32)
    gather_ms = _timed(torch, lambda: torch.index_select(table, 0, idx), 10)
    out = {"copy": 2 * a.numel() * 4 / (copy_ms * 1e-3),
           "gather": idx.numel() / (gather_ms * 1e-3)}
    print(f"yardsticks: copy {out['copy'] / 1e12:.3f} TB/s "
          f"({copy_ms:.3f} ms for 2 x 256 MB), random gather from an "
          f"L2-resident table {out['gather'] / 1e9:.1f} G elements/s "
          f"({gather_ms:.3f} ms for {idx.numel()})")
    del a, b, table, idx
    torch.cuda.empty_cache()
    return out


def _k1_traffic(torch, row_seg, cols, front_mask, visited):
    """(live slots, kept slots) of a K1 call whose frontier is
    ``front_mask`` (B, n) with every lane at its full degree: the slots,
    and those whose destination is unvisited."""
    live = kept = 0
    for b in range(front_mask.shape[0]):
        on = front_mask[b][row_seg.long()]
        live += int(on.sum())
        kept += int((on & ~visited[b][cols.long()]).sum(dtype=torch.int64))
    return live, kept


def _first_clean(torch, cache) -> bool:
    """Every K1 first-slot table in ``cache`` is all INT32_MAX."""
    return all(bool((t == INT32_MAX).all()) for k, t in cache.items()
               if isinstance(k, tuple) and k[0] == "advance_filter_first")


def _k1_floor_ms(ys, nbytes, live, kept, survivors) -> float:
    """K1's practical floor: its streamed bytes at the copy rate, plus the
    random accesses the function needs at the gather rate — a bitmap
    byte a live slot, a first-slot access a kept slot (to cull it), a
    reset a survivor."""
    return (nbytes / ys["copy"] + (live + kept + survivors)
            / ys["gather"]) * 1e3


def _moe_slots(torch, tokens, experts, top_k, capacity, dev):
    """slot_token (experts x capacity,) int32 of a seeded top-k routing:
    each expert's slots take its tokens in token order, -1 after the
    last; a token past the expert's capacity is dropped."""
    gen = torch.Generator(device=dev).manual_seed(0)
    scores = torch.rand((tokens, experts), generator=gen, device=dev)
    expert = torch.topk(scores, top_k, dim=1).indices.reshape(-1)
    token = torch.arange(tokens, device=dev).repeat_interleave(top_k)
    order = torch.sort(expert, stable=True).indices
    expert, token = expert[order], token[order]
    counts = torch.bincount(expert, minlength=experts)
    start = torch.cumsum(counts, 0) - counts
    rank = torch.arange(expert.numel(), device=dev) - start[expert]
    keep = rank < capacity
    slot_token = torch.full((experts * capacity,), -1, dtype=torch.int32,
                            device=dev)
    slot_token[(expert * capacity + rank)[keep]] = token[keep].to(
        torch.int32)
    return slot_token


def _attention_pairs(np, sq, sk, causal) -> int:
    """(query, key) pairs the end-aligned mask lets through."""
    if not causal:
        return sq * sk
    return int(np.clip(np.arange(sq, dtype=np.int64) + (sk - sq + 1), 0,
                       sk).sum())


def _attention_parts(torch, K, P, q, k, v, nsplit, rtol, atol, record):
    """K7's split form and the combine kernel (K7c), each against its
    plain version on the same inputs: every part's m within 1e-5 and its
    acc / l within (rtol, atol) (the parts are fp32; rtol is the output
    type's), and the combine within (rtol, atol) of the plain combine of
    the kernel's parts. Times the combine from a CUDA graph of wrapper
    calls, by events over the same calls and by one launch's device time
    (torch.profiler); with ``record``, records the first."""
    causal = True
    acc, ml = K.attention_partials(q, k, v, causal, nsplit)
    pacc, pml = P.attention_partials(q, k, v, causal, nsplit)
    err_m = float((ml[..., 0] - pml[..., 0]).abs().max())
    got = acc / ml[..., 1:].clamp_min(1e-30)
    want = pacc / pml[..., 1:].clamp_min(1e-30)
    err_p = (got - want).abs()
    if err_m > 1e-5 * (1 + float(pml[..., 0].abs().max())) or bool(
            (err_p > atol + rtol * want.abs()).any()) or not torch.equal(
            ml[..., 1] == 0, pml[..., 1] == 0):
        raise AssertionError(f"flash_attention parts off their plain "
                             f"version: m by {err_m:.3g}, acc / l by "
                             f"{float(err_p.max()):.3g}")
    out = K.attention_combine(acc, ml, q.dtype)
    pout = P.attention_combine(acc, ml, q.dtype).float()
    err_c = (out.float() - pout).abs()
    if bool((err_c > atol + rtol * pout.abs()).any()):
        raise AssertionError(f"attention_combine off its plain version by "
                             f"{float(err_c.max()):.3g}")
    sq, d = q.shape
    print(f"K7 parts: {nsplit} kv parts of Sq={sq} D={d} {q.dtype}: m "
          f"within {err_m:.3g}, acc / l within {float(err_p.max()):.3g} of "
          f"the plain parts; combine within {float(err_c.max()):.3g} of the "
          f"plain combine")

    def k7c():
        return K.attention_combine(acc, ml, q.dtype)

    # the kernel is quicker than its wrapper's host time: its time is
    # taken from a CUDA graph of wrapper calls, beside events and the
    # profiler's device time
    ms = _graph_timed(torch, k7c, 20)
    ev_ms = _timed(torch, k7c, 20)
    pms = _timed(torch, lambda: P.attention_combine(acc, ml, q.dtype), 5)
    devops, dev_ms, bare = _device_ops(torch, k7c)
    nbytes = nsplit * sq * (d + 2) * 4 + sq * d * q.element_size()
    print(f"K7c attention_combine {nsplit} x ({sq}, {d}) -> {q.dtype}: "
          f"{ms:.4f} ms (CUDA graph of 20 calls), {ev_ms:.4f} ms by events "
          f"over 20 wrapper calls, device {dev_ms:.4f} ms "
          f"({_ops_text(devops, bare)}), plain {pms:.4f} ms, bound "
          f"{_bound_ms(nbytes, 0)[0]:.4f} ms")
    if record is not None:
        record("attention_combine", float(err_c.max()), ms, pms, nbytes, 0)


def _hmma_counts(runtime) -> dict:
    """HMMA (tensor-core) instructions in each attention kernel of the
    built library, from its SASS (cuobjdump, demangled by cu++filt)."""
    nvcc = Path(runtime._nvcc())
    lib = runtime.BUILD_ROOT / runtime._digest() / "libattention.so"
    sass = subprocess.run([str(nvcc.with_name("cuobjdump")), "-sass",
                           str(lib)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    filt = nvcc.with_name("cu++filt")
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = 0
        elif name is not None and "HMMA" in line:
            counts[name] += 1
    if filt.exists() and counts:
        names = subprocess.run([str(filt)], input="\n".join(counts),
                               capture_output=True, text=True, timeout=60,
                               check=True).stdout.splitlines()
        counts = dict(zip(names, counts.values()))
    return counts


def _fourth_slice_kernels(torch, np, K, P, tuner, SR, g, gs, dev, record,
                          k6_ops):
    """K6, K7 and K8 against their plain versions at full width, timed
    beside one PyTorch library call and their bounds (``k6_ops``: K6's
    device-ops text, taken at the start of phase 2); every tuned kernel
    at every candidate block size. Returns the entry points' inputs for
    path (d)."""
    import torch.nn.functional as TF
    n, m = g.num_vertices, g.num_edges

    # K6 at rmat-22's whole-graph expansion: every vertex's out-degree
    sizes = g.degrees.to(torch.int32).contiguous()
    cap = tuner.pow2_ceil(m)
    slots = torch.arange(cap, dtype=torch.int32, device=dev)
    offsets = P.lb_offsets(sizes)
    prefix = offsets[:-1].contiguous()

    def k6(t=None):
        return K.lb_expand(sizes, cap, threads=t)

    def p6():
        return P.lb_expand(P.lb_offsets(sizes), cap)

    def lib6():
        return torch.searchsorted(prefix, slots, right=True)

    want = p6()
    for t in (None,) + tuple(tuner.candidates(tuner.MAX_THREADS)):
        got = k6(t)
        for i, name in enumerate(("in_pos", "rank", "valid")):
            if not torch.equal(got[i], want[i]):
                raise AssertionError(f"lb_expand {name} differs from the "
                                     f"plain version at {t} threads")
    if int(got.total) != m or int(got.valid.sum()) != m or not torch.equal(
            lib6()[:m] - 1, got.in_pos[:m].long()):
        raise AssertionError("lb_expand differs from torch.searchsorted")
    del got, want
    ms, pms, lms = (_timed(torch, k6, 20), _timed(torch, p6, 5),
                    _timed(torch, lib6, 5))
    # the sizes read once, 9 bytes written a slot and the total
    nbytes, ops = cap * 9 + n * 4 + 4, cap * 2
    print(f"K6 lb_expand cap_in={n} cap_out={cap} total={m}: {ms:.3f} ms, "
          f"plain {pms:.3f} ms, torch.searchsorted {lms:.3f} ms, bound "
          f"{_bound_ms(nbytes, ops)[0]:.3f} ms; bit-equal on every slot at "
          f"every block size; {k6_ops}")
    record("lb_expand", 0, ms, pms, nbytes, ops, lms)
    del slots, prefix, offsets
    torch.cuda.empty_cache()
    # a capacity that is no power of two, zero-size segments, cap_in = 0
    rng = np.random.default_rng(4)
    zs = torch.from_numpy(rng.integers(0, 9, 300_000).astype(np.int32))
    zs[torch.from_numpy(rng.random(300_000) < 0.4)] = 0
    # a segment spanning many tiles among tiles spanning many segments,
    # and a trailing empty one
    ls = (torch.from_numpy(rng.random(300_000) < 0.05)).to(torch.int32)
    ls[1234], ls[-1] = 40 * K.LB_TILE_SLOTS + 7, 0
    for sz, c in ((sizes, m + 777_777), (zs.to(dev), 1_000_003),
                  (zs.to(dev), 999),
                  (ls.to(dev), int(ls.sum(dtype=torch.int64)) + 4099),
                  (sizes[:0], 4097)):
        want = P.lb_expand(P.lb_offsets(sz), c)
        for t in tuner.candidates(tuner.MAX_THREADS):
            got = K.lb_expand(sz, c, threads=t)
            if not all(torch.equal(a, b) for a, b in zip(got[:3], want)):
                raise AssertionError(f"lb_expand cap_in={sz.numel()} "
                                     f"cap_out={c} differs from the plain "
                                     f"version at {t} threads")
    print("K6 lb_expand at cap_out = m + 777,777, on 40 % zero-size "
          "segments (cap_out 1,000,003 and 999), on a segment spanning 40 "
          "tiles among 5 % one-slot segments and at cap_in = 0: bit-equal "
          "to the plain version on every slot at every block size")

    # K7 at two published head widths, bf16 and fp32
    attention = []
    gen = torch.Generator(device=dev).manual_seed(2)
    for head, model in ((QWEN2_VL_HEAD, "Qwen2-VL-2B"),
                        (KIMI_HEAD, "Kimi K2")):
        for dtype in (torch.bfloat16, torch.float32):
            rtol, atol = ATTENTION_TOL[str(dtype)[6:]]
            rate = FP32_OPS_PER_S if dtype == torch.float32 else (
                BF16_OPS_PER_S)
            for label, sq, sk, causal in ATTENTION_SHAPES:
                q, k, v = (torch.randn((r, head), generator=gen,
                                       device=dev).to(dtype)
                           for r in (sq, sk, sk))
                got = K.flash_attention(q, k, v, causal=causal)
                want = P.flash_attention(q, k, v, causal=causal).float()
                err = (got.float() - want).abs()
                if bool((err > atol + rtol * want.abs()).any()) or (
                        causal and sq > sk
                        and bool((got[:sq - sk] != 0).any())):
                    raise AssertionError(
                        f"flash_attention {model} D={head} {dtype} {label} "
                        f"off its plain version by {float(err.max()):.3g}")
                mask = None
                if causal and sq != sk:
                    mask = (torch.arange(sk, device=dev)[None, :]
                            <= torch.arange(sq, device=dev)[:, None]
                            + (sk - sq))
                q4, k4, v4 = q[None, None], k[None, None], v[None, None]

                def k7():
                    return K.flash_attention(q, k, v, causal=causal)

                def p7():
                    return P.flash_attention(q, k, v, causal=causal)

                def lib7():
                    return TF.scaled_dot_product_attention(
                        q4, k4, v4, attn_mask=mask,
                        is_causal=causal and mask is None)

                ms, pms, lms = (_timed(torch, k7, 3), _timed(torch, p7, 2),
                                _timed(torch, lib7, 5))
                ops = 4 * _attention_pairs(np, sq, sk, causal) * head
                nbytes = 2 * (sq + sk) * head * q.element_size()
                bound = _bound_ms(nbytes, ops, rate)[0]
                # the rate the kernel issues at: fp32 three TF32 products
                # for each, bf16 two for P V (4 operations take 6)
                issue = (TF32_OPS_PER_S / 3 if dtype == torch.float32
                         else BF16_OPS_PER_S * 4 / 6)
                nsplit = K.attention_splits(sq, sk, dtype, K.sm_count(dev))
                print(f"K7 flash_attention {model} D={head} "
                      f"{str(dtype)[6:]} {label} Sq={sq} Sk={sk} "
                      f"(kv parts {nsplit}): {ms:.3f} ms, plain {pms:.3f} "
                      f"ms, sdpa {lms:.3f} ms, bound {bound:.4f} ms at "
                      f"{rate / 1e12:.0f} TFLOP/s, "
                      f"{_bound_ms(nbytes, ops, issue)[0]:.4f} ms at the "
                      f"tensor-core rate the kernel issues "
                      f"({issue / 1e12:.0f} TFLOP/s), max |error| "
                      f"{float(err.max()):.3g} (limit {atol:g} + {rtol:g} "
                      f"|want|)")
                if (head, dtype, label) == (QWEN2_VL_HEAD, torch.bfloat16,
                                            "prefill"):
                    record("flash_attention", float(err.max()), ms, pms,
                           nbytes, ops, lms, rate)
                if label == "chunk":
                    # the whole split-form call: K7 and K7c in one C call
                    call_ms, graph_ms, sdpa_ms = (
                        _timed(torch, k7, 20), _graph_timed(torch, k7, 20),
                        _timed(torch, lib7, 20))
                    devops, dev_ms, bare = _device_ops(torch, k7)
                    print(f"K7 chunk call {model} D={head} "
                          f"{str(dtype)[6:]} ({nsplit} kv parts): "
                          f"{call_ms:.4f} ms by events, {graph_ms:.4f} ms "
                          f"in a CUDA graph, device {dev_ms:.4f} ms "
                          f"({_k7_ops(devops, bare, 'chunk call')}), sdpa "
                          f"{sdpa_ms:.4f} ms")
                if head == QWEN2_VL_HEAD and label == "chunk":
                    _attention_parts(torch, K, P, q, k, v, nsplit, rtol,
                                     atol, record if dtype == torch.bfloat16
                                     else None)
                attention.append((q, k, v, causal, rtol, atol))
                del got, want, err, mask
    torch.cuda.empty_cache()

    # K8 at Kimi K2's dispatch: 8192 tokens of width 7168 in bf16 into
    # 384 experts x the reference's capacity (models/moe.py _capacity)
    cap_e = max(8 * math.ceil(math.ceil(
        MOE_TOKENS * KIMI_TOP_K / KIMI_EXPERTS * MOE_CAPACITY_FACTOR) / 8), 8)
    slot = _moe_slots(torch, MOE_TOKENS, KIMI_EXPERTS, KIMI_TOP_K, cap_e, dev)
    nslots, filled = slot.numel(), int((slot >= 0).sum(dtype=torch.int64))
    x = torch.randn((MOE_TOKENS, KIMI_D_MODEL), generator=gen,
                    device=dev).to(torch.bfloat16)
    xz = torch.cat([x, x.new_zeros((1, KIMI_D_MODEL))])
    idx = torch.where(slot < 0, MOE_TOKENS, slot).long()

    def k8():
        return K.moe_gather(x, slot)

    def p8():
        return P.moe_gather(x, slot)

    def lib8():
        return torch.index_select(xz, 0, idx)

    got = k8()
    if not torch.equal(got, p8()) or not torch.equal(got, lib8()):
        raise AssertionError("moe_gather differs from its plain version or "
                             "index_select")
    del got
    ms, pms, lms = (_timed(torch, k8, 20), _timed(torch, p8, 5),
                    _timed(torch, lib8, 20))
    row = KIMI_D_MODEL * 2
    nbytes = (MOE_TOKENS + nslots) * row + nslots * 4
    # what device memory moves when the slots are walked in slot
    # (expert-major) order: x does not fit L2, so every filled slot reads
    # its row again
    slot_order = (filled + nslots) * row + nslots * 4
    print(f"K8 moe_gather x=({MOE_TOKENS}, {KIMI_D_MODEL}) bf16, "
          f"{KIMI_EXPERTS} experts x capacity {cap_e} = {nslots} slots, "
          f"{filled} filled: {ms:.3f} ms (its sort by token included), "
          f"plain {pms:.3f} ms, index_select {lms:.3f} ms, bound "
          f"{_bound_ms(nbytes, 0)[0]:.3f} ms ({nbytes / 1e9:.3f} GB: x once, "
          f"the output, 4 B a slot); a walk in slot order moves "
          f"{slot_order / 1e9:.3f} GB ({_bound_ms(slot_order, 0)[0]:.3f} ms "
          f"at the memory rate); bit-equal")
    record("moe_gather", 0, ms, pms, nbytes, 0, lms)
    # slot ids in no order: shuffled, repeated, -1 and past the last token
    sgen = torch.Generator(device=dev).manual_seed(5)
    shuffled = slot[torch.randperm(nslots, generator=sgen, device=dev)]
    repeated = torch.randint(-1, 64, (nslots,), generator=sgen, device=dev,
                             dtype=torch.int32)
    odd = shuffled.clone()
    odd[::13] = MOE_TOKENS + 7
    for label, st in (("shuffled", shuffled), ("repeated", repeated),
                      ("-1 and past the end", odd),
                      ("all -1", torch.full_like(slot, -1))):
        if not torch.equal(K.moe_gather(x, st), P.moe_gather(x, st)):
            raise AssertionError(f"moe_gather on {label} slot ids differs "
                                 f"from the plain version")
    del shuffled, repeated, odd
    print("K8 moe_gather on shuffled, repeated (64 tokens), -1 and "
          "past-the-end, and all -1 slot ids: bit-equal to the plain "
          "version")
    # rows whose bytes are no multiple of 16, an unaligned view, fp32
    dm = KIMI_D_MODEL
    for xi in (x[:, :dm - 1].contiguous(),
               x.reshape(-1)[1:1 + (MOE_TOKENS - 1) * dm].view(-1, dm),
               x[:, :999].float().contiguous()):
        if not torch.equal(K.moe_gather(xi, slot), P.moe_gather(xi, slot)):
            raise AssertionError(f"moe_gather on {tuple(xi.shape)} "
                                 f"{xi.dtype} differs from the plain version")
    print(f"K8 moe_gather on rows of {dm - 1} bf16 (2-byte copies), an "
          f"unaligned view (2-byte copies) and rows of 999 fp32 (4-byte "
          f"copies): bit-equal to the plain version")
    del xz, idx
    torch.cuda.empty_cache()

    # every tuned kernel (K1-K6 but K4m) at every candidate block size, on
    # rmat scale 14 at its full capacity
    ro, ci = gs.row_offsets, gs.col_indices
    ns, ms_ = gs.num_vertices, gs.num_edges
    gen = torch.Generator(device=dev).manual_seed(3)
    base = torch.randint(0, ns, (2, 3000), generator=gen, device=dev,
                         dtype=torch.int32)
    bsizes = gs.degrees.to(torch.int32)[base.long()]
    bsizes[:, 2500:] = 0                        # dead input lanes
    visited = torch.rand((2, ns), generator=gen, device=dev) < 0.3
    bitmap = torch.rand((2, ns), generator=gen, device=dev) < 0.4
    ids = torch.arange(ns, dtype=torch.int32, device=dev)[None, :]
    xs = torch.rand(ns, generator=gen, device=dev)
    spmv_args = (ro, ci, gs.edge_values, xs, SR.min_plus, gs.ell_width,
                 None, gs.row_seg, gs.over_pos, gs.over_row)
    rows = torch.randint(0, ns, (200_000,), generator=gen, device=dev)
    lo, hi = ro[rows], ro[rows + 1]
    needles = torch.where(torch.rand(rows.shape, generator=gen, device=dev)
                          < 0.5, ci[lo.long().clamp(max=ms_ - 1)],
                          torch.randint(0, ns, rows.shape, generator=gen,
                                        device=dev, dtype=torch.int32))
    runs = {
        "advance": (lambda t: K.advance_batch(ro, ci, base, bsizes, ms_,
                                              threads=t),
                    lambda: P.advance_batch(ro, ci, base, bsizes, ms_)),
        "advance_filter": (
            lambda t: K.advance_filter_batch(ro, ci, base, bsizes, visited,
                                             ms_, ns, {}, threads=t),
            lambda: P.advance_filter_batch(ro, ci, base, bsizes, visited,
                                           ms_, ns)),
        "compact": (lambda t: K.compact(ids, bitmap, threads=t),
                    lambda: P.compact(ids, bitmap)),
        "spmv": (lambda t: (K.spmv(*spmv_args, threads=t),),
                 lambda: (P.spmv(*spmv_args),)),
        "segment_search": (
            lambda t: (K.segment_search(ci, lo, hi, needles, threads=t),
                       K.segment_locate(ci, lo, hi, needles, threads=t)),
            lambda: (P.segment_search(ci, lo, hi, needles),
                     P.segment_locate(ci, lo, hi, needles))),
        "lb_expand": (lambda t: K.lb_expand(gs.degrees.to(torch.int32),
                                            ms_ + 999, threads=t)[:3],
                      lambda: P.lb_expand(P.lb_offsets(
                          gs.degrees.to(torch.int32)), ms_ + 999)),
    }
    blocks = tuner.candidates(tuner.MAX_THREADS)
    for op, (kern, plain) in runs.items():
        want = plain()
        for t in blocks:
            if not all(torch.equal(a, b) for a, b in zip(kern(t), want)):
                raise AssertionError(f"{op} at {t} threads per block "
                                     f"differs from the plain version")
    print(f"block-size invariance: advance, advance_filter, compact, spmv "
          f"(min_plus), segment_search (found and locate) and lb_expand "
          f"bit-equal to their plain versions at {blocks} threads per "
          f"block (rmat scale 14, full capacity)")
    return {"sizes": sizes, "cap": cap, "attention": attention, "x": x,
            "slot": slot}


def _fourth_slice_path(torch, K, P, tuner, runtime, root, dev, fourth):
    """Path (d): the tuner over its default ladder into a cache of its own
    under build/, then the kernel API's lb_expand, flash_attention and
    moe_gather once each, with the launch counters set to 0 first;
    validated against the plain versions. Returns the launch counts, in
    total and by variant."""
    cache = root / "build" / "chip_smoke_tuner.json"
    cache.parent.mkdir(parents=True, exist_ok=True)
    cache.unlink(missing_ok=True)
    prev = tuner.cache_path()
    K.reset_launches()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    tuner.set_cache(cache)
    try:
        picked = tuner.autotune_all(tuner.DEFAULT_CAPS)
        picks = {(op, cap, enc): tuner.entry(op, cap, dev, encoding=enc)
                 for (op, cap, enc) in picked}
    finally:
        tuner.set_cache(prev)
    tune_s = time.monotonic() - t0
    t0 = time.monotonic()
    exp = K.lb_expand(fourth["sizes"], fourth["cap"])
    att = [K.flash_attention(q, k, v, causal=c)
           for q, k, v, c, *_ in fourth["attention"]]
    moe = K.moe_gather(fourth["x"], fourth["slot"])
    torch.cuda.synchronize()
    api_s = time.monotonic() - t0
    launches4 = {k: v.launches for k, v in K.KERNELS.items()}
    variants4 = {k: dict(v.variants) for k, v in K.KERNELS.items()}
    print(f"main path (d) launches: {launches4}; tuner {tune_s:.2f} s, "
          f"kernel API {api_s * 1e3:.1f} ms")
    missing = [k for k in ("advance_filter_batch", "compact",
                           "advance_batch", "spmv", "lb_expand",
                           "flash_attention", "attention_combine",
                           "moe_gather")
               if launches4[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    print(f"tuner picks ({runtime.platform(dev)}), threads per block and "
          f"ms per launch at each capacity:")
    for (op, cap, enc), e in sorted(picks.items()):
        print(f"  {op:15s} cap={cap:<7d} {enc:5s} -> {e['tile']:4d} "
              f"threads, {e['ms']:.5f} ms")
    want = P.lb_expand(P.lb_offsets(fourth["sizes"]), fourth["cap"])
    if not all(torch.equal(a, b) for a, b in zip(exp[:3], want)):
        raise AssertionError("path (d) lb_expand differs from the plain "
                             "version")
    for got, (q, k, v, c, rtol, atol) in zip(att, fourth["attention"]):
        w = P.flash_attention(q, k, v, causal=c).float()
        if bool(((got.float() - w).abs() > atol + rtol * w.abs()).any()):
            raise AssertionError("path (d) flash_attention off its plain "
                                 "version")
    if not torch.equal(moe, P.moe_gather(fourth["x"], fourth["slot"])):
        raise AssertionError("path (d) moe_gather differs from the plain "
                             "version")
    print(f"validated path (d): lb_expand and moe_gather bit-equal, "
          f"{len(att)} flash_attention calls within their limits")
    return launches4, variants4


def _fifth_slice_kernels(torch, np, K, P, O, F, G, S, SR, tuner, g, dev,
                         record, ys, lb_seen):
    """K1 and K3 in each column form of the storage plans (delta at the
    grid's shape, int16 at rmat scale 15, int64 on a small explicit-int64
    graph) and K4 / K4m at bf16 against their plain versions, timed beside
    the int32 form on the same frontier. Returns the graphs of path (e)."""
    t0 = time.monotonic()
    graphs = {
        "grid-int32": G.grid2d(GRID_SIDE, weighted=True, seed=0,
                               device=dev),
        "grid-delta": G.grid2d(GRID_SIDE, weighted=True, seed=0,
                               encoding="delta", device=dev),
        "rmat15-int16": G.rmat(INT16_SCALE, EDGE_FACTOR, seed=0,
                               weighted=True, device=dev),
        "rmat15-int32": G.rmat(INT16_SCALE, EDGE_FACTOR, seed=0,
                               weighted=True, index_dtype="int32",
                               device=dev),
        "rmat15-int64": G.rmat(INT16_SCALE, EDGE_FACTOR, seed=0,
                               weighted=True, index_dtype="int64",
                               device=dev),
    }
    # rmat-22 under delta, from the main graph's CSR (the same arrays as
    # rmat(22, ..., encoding="delta"), without generating them again)
    vals = g.edge_values.cpu().numpy()
    graphs["rmat22-delta"] = G.Graph.from_csr(
        g.row_offsets.cpu().numpy(), g.cols_np(), vals, sort_neighbors=False,
        encoding="delta", device=dev)
    torch.cuda.synchronize()
    plans = {k: (v.plan.index_dtype, v.plan.encoding)
             for k, v in graphs.items()}
    want_plans = {"grid-int32": ("int32", "dense"),
                  "grid-delta": ("int32", "delta"),
                  "rmat15-int16": ("int16", "dense"),
                  "rmat15-int32": ("int32", "dense"),
                  "rmat15-int64": ("int64", "dense"),
                  "rmat22-delta": (S.plan_for(g.num_vertices).index_dtype,
                                   "delta")}
    if plans != want_plans:
        raise AssertionError(f"storage plans {plans}, expected {want_plans}")
    grid_esc = graphs["grid-delta"].col_store.num_escapes + graphs[
        "grid-delta"].csc_store.num_escapes
    if grid_esc:
        raise AssertionError(f"the grid's delta stream has {grid_esc} "
                             f"escapes; its kernels would not decode it")
    d22 = graphs["rmat22-delta"]
    if not torch.equal(d22.cols(), g.col_indices) or not torch.equal(
            d22.csc_cols(), g.csc_indices):
        raise AssertionError("rmat-22's delta columns do not decode to its "
                             "dense ones")
    gg = graphs["grid-int32"]
    print(f"storage plans built in {time.monotonic() - t0:.1f} s: grid "
          f"{GRID_SIDE}x{GRID_SIDE} n={gg.num_vertices} m={gg.num_edges} "
          f"(int32 dense, and delta with 0 escapes); rmat scale "
          f"{INT16_SCALE} n={graphs['rmat15-int16'].num_vertices} "
          f"m={graphs['rmat15-int16'].num_edges} (int16, int32, int64); "
          f"rmat scale 22 delta with {d22.col_store.num_escapes} CSR and "
          f"{d22.csc_store.num_escapes} CSC escapes (of {d22.num_edges})")
    for name, gr in graphs.items():
        rb = S.resident_bytes(gr)
        print(f"resident_bytes {name}: {rb['plan']} column_bytes "
              f"{rb['column_bytes']} bytes_per_edge {rb['bytes_per_edge']} "
              f"total_bytes {rb['total_bytes']} total_bytes_per_edge "
              f"{rb['total_bytes_per_edge']}")
    rb = {k: v for k, v in S.resident_bytes(g).items() if k != "arrays"}
    print(f"resident_bytes rmat{int(math.log2(g.num_vertices))}-"
          f"{g.plan.index_dtype}: {rb}")

    # K1 and K3 on one frontier per group of plans: a quarter of the
    # vertices in each of B lanes, at the capacity tier its expansion
    # needs; each plan checked against its plain version, then the plans
    # timed in turns (the median of TIMING_ROUNDS rounds, the order
    # rotated each round), as a comparison within one call must be
    def expand_group(label, plans, front, front_mask, visited):
        """plans: (variant, graph, column bytes a slot, bytes a live input
        lane besides its 16) → {variant: {kernel: (ms, plain ms, bytes,
        operations)}}."""
        runs, out = {}, {}
        blocks = tuner.candidates(tuner.MAX_THREADS)
        for variant, gr, col_bytes, lane_bytes in plans:
            store = gr.col_store
            base, sizes = O._base_and_sizes(gr, front.ids, front.valid_mask,
                                            "vertex")
            bl, cap_in = (int(d) for d in base.shape)
            caps = F.tier_caps(gr.num_edges)
            cap = caps[F.tier_index(int(sizes.sum(dim=1).max()), caps)]
            live = int(front.lengths.sum())
            slots = int(torch.clamp(sizes.sum(dim=1), max=cap).sum())
            cap_v = gr.num_vertices
            fns = {
                "advance_filter_batch": (
                    lambda gr=gr, store=store, base=base, sizes=sizes,
                    cap=cap: K.advance_filter_batch(
                        gr.row_offsets, store, base, sizes, visited, cap,
                        gr.num_vertices, gr.cache),
                    lambda gr=gr, store=store, base=base, sizes=sizes,
                    cap=cap: P.advance_filter_batch(
                        gr.row_offsets, store, base, sizes, visited, cap,
                        gr.num_vertices),
                    bl * cap_in * 4 + live * (8 + lane_bytes)
                    + slots * (col_bytes + 1) + bl * cap_v * 8 + bl * 8,
                    slots * 8),
                "advance_batch": (
                    lambda gr=gr, store=store, base=base, sizes=sizes,
                    cap=cap, t=None: K.advance_batch(
                        gr.row_offsets, store, base, sizes, cap, gr.cache,
                        threads=t),
                    lambda gr=gr, store=store, base=base, sizes=sizes,
                    cap=cap: P.advance_batch(gr.row_offsets, store, base,
                                             sizes, cap),
                    bl * cap_in * 4 + live * (8 + lane_bytes)
                    + slots * col_bytes + bl * cap * 21 + bl * 4,
                    bl * cap * 4),
            }
            K.reset_launches()
            for name, (kf, pf, _, _) in fns.items():
                got = kf()
                want = pf()
                for i, (x, y) in enumerate(zip(got, want)):
                    if not torch.equal(x, y):
                        raise AssertionError(f"{name} ({variant}, {label}): "
                                             f"output {i} differs from the "
                                             f"plain version")
                if K.KERNELS[name].variants != {variant: 1}:
                    raise AssertionError(f"{name} on {label} ran "
                                         f"{K.KERNELS[name].variants}, not "
                                         f"{variant}")
                if name == "advance_filter_batch":
                    if not _first_clean(torch, gr.cache):
                        raise AssertionError(f"K1 ({variant}, {label}) left "
                                             f"its first-slot table dirty")
                    _, kept = _k1_traffic(torch, gr.row_seg, gr.cols(),
                                          front_mask, visited)
                    devops, dev_ms, bare = _device_ops(torch, kf)
                    floor = _k1_floor_ms(ys, fns[name][2], slots, kept,
                                         int(got[3].sum()))
                    print(f"K1 {variant} ({label}): kept={kept} survivors="
                          f"{int(got[3].sum())}, practical floor "
                          f"{floor:.3f} ms; {_ops_text(devops, bare)}, "
                          f"device {dev_ms:.3f} ms; first-slot table all "
                          f"INT32_MAX")
                else:
                    del got
                    _check_blocks(torch, f"K3 ({variant}, {label})", kf,
                                  want, blocks)
                    devops, dev_ms, bare = _device_ops(torch, kf)
                    ops_k3 = _lb_ops(devops, bare, f"K3 {variant}", lb_seen)
                    print(f"K3 {variant} ({label}): bit-equal on every slot "
                          f"at {blocks} threads per block; {ops_k3}, device "
                          f"{dev_ms:.3f} ms")
                del want
            runs[variant] = (fns, bl, cap, slots)
        for name in ("advance_filter_batch", "advance_batch"):
            times = {v: [] for v in runs}
            order = list(runs)
            for r in range(TIMING_ROUNDS):
                for v in order[r % len(order):] + order[:r % len(order)]:
                    times[v].append(_timed(torch, runs[v][0][name][0], 10))
            for v, (fns, bl, cap, slots) in runs.items():
                _, pf, nbytes, ops = fns[name]
                ms = statistics.median(times[v])
                pms = _timed(torch, pf, 2)
                print(f"{'K1' if name == 'advance_filter_batch' else 'K3'} "
                      f"{name} {v} ({label}) B={bl} cap_out={cap} "
                      f"slots={slots}: {ms:.3f} ms (rounds "
                      f"{', '.join(f'{t:.3f}' for t in times[v])}), plain "
                      f"{pms:.3f} ms, bound {_bound_ms(nbytes, ops)[0]:.3f} "
                      f"ms")
                out.setdefault(v, {})[name] = (ms, pms, nbytes, ops)
        return out

    def quarter(gr, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        nn = gr.num_vertices
        mask = torch.rand((BATCH, nn), generator=gen, device=dev) < 0.25
        visited = torch.rand((BATCH, nn), generator=gen, device=dev) < 0.5
        return (F.compact_indices_batch(mask, nn, backend="torch"), mask,
                visited)

    # int32: 4 B a column; delta: 2 B a delta and a 4 B anchor a live lane
    front, fmask, visited = quarter(gg, 11)
    got = expand_group(f"grid {GRID_SIDE}",
                       (("int32", gg, 4, 0),
                        ("delta", graphs["grid-delta"], 2, 4)),
                       front, fmask, visited)
    for name, row in got["delta"].items():
        record(f"{name}:delta", 0, *row)
    front, fmask, visited = quarter(graphs["rmat15-int32"], 12)
    got = expand_group(f"rmat {INT16_SCALE}",
                       (("int32", graphs["rmat15-int32"], 4, 0),
                        ("int16", graphs["rmat15-int16"], 2, 0),
                        ("int64", graphs["rmat15-int64"], 8, 0)),
                       front, fmask, visited)
    for v in ("int16", "int64"):
        for name, row in got[v].items():
            record(f"{name}:{v}", 0, *row)
    # rmat-22's delta stream: escaped, so the dense fallback runs the int32
    # kernels on its decoded view
    front, fmask, visited = quarter(g, 13)
    expand_group("rmat 22 delta", ((
        "dense_fallback" if d22.col_store.num_escapes else "delta", d22, 4,
        0),), front, fmask, visited)
    del front, fmask, visited
    torch.cuda.empty_cache()

    # K4 at bf16: all of the small graph's plus semirings, structural and
    # weighted (float32 and bfloat16 values), bit for bit with the plain
    # version on the CPU; then one bf16 PageRank sweep at rmat-22
    gs = graphs["rmat15-int16"]
    gen = torch.Generator().manual_seed(7)
    xs = (torch.rand(gs.num_vertices, generator=gen) * 3.0).to(dev)
    mask = (torch.rand(gs.num_vertices, generator=gen) < 0.5).to(dev)
    wv = gs.edge_values * 1.37
    for name in ("plus_times", "plus_and"):
        sr = SR.with_precision(name, "bf16")
        for v in (None, wv, wv.to(torch.bfloat16)):
            for mk in (None, mask):
                args = (gs.row_offsets, gs.col_store, v, xs, sr,
                        gs.ell_width, mk, None, gs.over_pos, gs.over_row)
                got = K.spmv(*args, cache=gs.cache)
                want = P.spmv(*(a.cpu() if torch.is_tensor(a) else a
                                for a in args))
                if not torch.equal(got.cpu(), want):
                    raise AssertionError(f"spmv {name} bf16 differs from "
                                         f"the plain version")
    print(f"K4 spmv bf16: plus_times and plus_and x (structural, fp32 "
          f"values, bf16 values) x (masked, unmasked) bit-equal to the "
          f"plain version on rmat scale {INT16_SCALE} (int16 columns)")
    from repro_torch.core.primitives.pagerank import _inv_out_degrees
    n, m = g.num_vertices, g.num_edges
    contrib = torch.full((n,), 1.0 / n, device=dev) * _inv_out_degrees(g)
    sr16 = SR.with_precision(SR.plus_times, "bf16")
    spmv_args = (g.csc_offsets, g.csc_indices, None, contrib, sr16,
                 g.csc_ell_width, None, g.csc_row_seg, g.csc_over_pos,
                 g.csc_over_row)
    y_k = K.spmv(*spmv_args).cpu()
    y_c = P.spmv(*(a.cpu() if torch.is_tensor(a) else a for a in spmv_args))
    if not torch.equal(y_k, y_c):
        raise AssertionError("spmv bf16 differs from its plain version on "
                             "the CPU at rmat-22")
    args32 = spmv_args[:4] + (SR.plus_times,) + spmv_args[5:]
    y32 = K.spmv(*args32).cpu()
    ms, ms32 = _in_turns(torch, (lambda: K.spmv(*spmv_args),
                                 lambda: K.spmv(*args32)), 20)
    pms = _timed(torch, lambda: P.spmv(*spmv_args), 3)
    nbytes = m * 4 + n * 4 + (n + 1) * 4 + n * 4
    print(f"K4 spmv plus_times bf16 n={n} m={m}: {ms:.3f} ms (fp32 "
          f"{ms32:.3f} ms in the same turns), plain {pms:.3f} ms, bound "
          f"{_bound_ms(nbytes, 3 * m)[0]:.3f} ms; bit-equal to the plain "
          f"version on the CPU; max |bf16 - fp32| "
          f"{float((y_k - y32).abs().max()):.3g}")
    record("spmv:bf16", 0, ms, pms, nbytes, 3 * m)
    # K4m at bf16 at label propagation's shape (k = 32) on general floats:
    # bit-equal to the plain version on the CPU on the rows of at most
    # SPMM_SPLIT edges (the same fold order there), rtol 1e-5 elsewhere
    g16 = G.rmat(LP_SCALE, EDGE_FACTOR, seed=0, weighted=True, device=dev)
    x16 = torch.rand((g16.num_vertices, 32), generator=gen).to(dev)
    mm_args = (g16.row_offsets, g16.col_store, None, x16, sr16,
               g16.ell_width, None, g16.row_seg)
    got = K.spmm(*mm_args).cpu()
    want = P.spmm(*(a.cpu() if torch.is_tensor(a) else a for a in mm_args))
    light = (g16.degrees <= K.SPMM_SPLIT).cpu()
    if not torch.equal(got[light], want[light]) or not torch.allclose(
            got, want, rtol=1e-5, atol=1e-5):
        raise AssertionError("spmm bf16 off its plain version")
    err = float((got - want).abs().max())
    mm32 = mm_args[:4] + (SR.plus_times,) + mm_args[5:]
    ms, ms32 = _in_turns(torch, (lambda: K.spmm(*mm_args),
                                 lambda: K.spmm(*mm32)), 20)
    pms = _timed(torch, lambda: P.spmm(*mm_args), 3)
    n16, m16 = g16.num_vertices, g16.num_edges
    nbytes = m16 * 4 + (n16 + 1) * 4 + 2 * n16 * 32 * 4
    print(f"K4m spmm plus_times bf16 k=32 (rmat scale {LP_SCALE}, uniform "
          f"floats): {ms:.3f} ms (fp32 {ms32:.3f} ms in the same turns), "
          f"plain {pms:.3f} ms, bound "
          f"{_bound_ms(nbytes, 3 * m16 * 32)[0]:.4f} ms; bit-equal on the "
          f"rows of at most {K.SPMM_SPLIT} edges, max |difference| "
          f"{err:.3g}")
    record("spmm:bf16", err, ms, pms, nbytes, 3 * m16 * 32)
    del g16, x16, got, want
    torch.cuda.empty_cache()
    return graphs


def _fifth_slice_path(torch, np, K, R, G, S, graphs, g, sources, dev):
    """Path (e): bfs_batch (push, pull, auto) and sssp_batch on grid2d
    GRID_TRAVERSAL_SIDE and pagerank on grid2d GRID_SIDE, each under
    dense int32 and delta, and all of them on rmat scale 15 under
    int16, int32 and int64, each equal bit for bit across its plans, the
    grid's against the oracles; triangle_count on rmat-15 int16 and int32;
    bfs_batch and sssp_batch on rmat-22's escaped delta stream (the dense
    fallback) and bf16 PageRank on rmat-22 against fp32. Returns the
    launch counts, in total and by variant, read where the run ends."""
    from repro_torch.core.primitives import (bfs_batch, pagerank, sssp_batch,
                                             triangle_count)
    # the grid's traversals at GRID_TRAVERSAL_SIDE (levels and steps
    # scale with the side), its PageRank at GRID_SIDE
    walk = {name: G.grid2d(GRID_TRAVERSAL_SIDE, weighted=True, seed=0,
                           encoding=("delta" if name.endswith("delta")
                                     else "dense"),
                           index_dtype="int32", device=dev)
            for name in ("grid-int32", "grid-delta")}
    if walk["grid-delta"].col_store.num_escapes:
        raise AssertionError("the traversal grid's delta stream escapes")
    gg = walk["grid-int32"]
    ng = gg.num_vertices
    gsrc = [0, ng // 2 + GRID_TRAVERSAL_SIDE // 2, 12345, ng - 1]
    runs = {
        "bfs_batch push": lambda gr, s: bfs_batch(gr, s, direction=False,
                                                  backend="cuda"),
        "bfs_batch pull": lambda gr, s: bfs_batch(gr, s, do_a=0.0, do_b=0.0,
                                                  backend="cuda"),
        "bfs_batch auto": lambda gr, s: bfs_batch(gr, s, backend="cuda"),
        "sssp_batch": lambda gr, s: sssp_batch(gr, s, backend="cuda"),
        "pagerank": lambda gr, s: (pagerank(gr, max_iter=20,
                                            backend="cuda").rank,),
    }
    K.reset_launches()
    torch.cuda.synchronize()
    results, times = {}, {}
    for name, gr in graphs.items():
        if name == "rmat22-delta":
            continue
        srcs = (gsrc if name.startswith("grid")
                else [int(torch.argmax(gr.degrees)), 1, 2, 3])
        for label, fn in runs.items():
            on = (walk[name] if name in walk and label != "pagerank"
                  else gr)
            t = time.monotonic()
            results[name, label] = fn(on, srcs)
            torch.cuda.synchronize()
            times[name, label] = time.monotonic() - t
    for name in ("rmat15-int16", "rmat15-int32"):
        t = time.monotonic()
        results[name, "triangle_count"] = (triangle_count(
            graphs[name], backend="cuda").per_edge,)
        torch.cuda.synchronize()
        times[name, "triangle_count"] = time.monotonic() - t
    d22 = graphs["rmat22-delta"]
    for label in ("bfs_batch auto", "sssp_batch"):
        t = time.monotonic()
        results["rmat22-delta", label] = runs[label](d22, sources)
        torch.cuda.synchronize()
        times["rmat22-delta", label] = time.monotonic() - t
    t = time.monotonic()
    pr16 = pagerank(g, max_iter=20, precision="bf16", backend="cuda")
    torch.cuda.synchronize()
    times["rmat22-int32", "pagerank bf16"] = time.monotonic() - t
    launches = {k: v.launches for k, v in K.KERNELS.items()}
    variants = {k: dict(v.variants) for k, v in K.KERNELS.items()}
    print(f"main path (e) launches: {launches}; by variant: "
          f"{ {k: v for k, v in variants.items() if v} }")
    for (name, label), dt in times.items():
        it = results.get((name, label))
        iters = ""
        if it is not None and hasattr(it, "iterations"):
            iters = f", iterations {it.iterations.tolist()}"
        if it is not None and hasattr(it, "pull_iters"):
            iters += f", pull {it.pull_iters.tolist()}"
        print(f"  {name:13s} {label:15s} {dt * 1e3:10.1f} ms{iters}")
    for name in ("advance_filter_batch", "advance_batch"):
        if variants[name].get("delta", 0) == 0:
            raise AssertionError(f"{name} never ran its delta variant on "
                                 f"path (e)")
        need = ["int16", "int64"]
        if graphs["rmat22-delta"].col_store.num_escapes:
            need.append("dense_fallback")
        for v in need:
            if variants[name].get(v, 0) == 0:
                raise AssertionError(f"{name} never ran its {v} variant "
                                     f"on path (e)")
    if variants["spmv"].get("bf16", 0) == 0 or variants[
            "segment_search"].get("int16", 0) == 0:
        raise AssertionError("spmv bf16 or segment_search int16 never ran "
                             "on path (e)")

    # every plan equal to its int32 twin, bit for bit
    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    for label in list(runs) + ["triangle_count"]:
        for twin, base in (("grid-delta", "grid-int32"),
                           ("rmat15-int16", "rmat15-int32"),
                           ("rmat15-int64", "rmat15-int32")):
            if (twin, label) in results and not same(
                    results[twin, label], results[base, label]):
                raise AssertionError(f"{label} on {twin} differs from "
                                     f"{base}")
    for label in ("bfs_batch auto", "sssp_batch"):
        if not same(results["rmat22-delta", label], runs[label](g, sources)):
            raise AssertionError(f"{label} on rmat-22 delta differs from "
                                 f"int32")
    pr32 = pagerank(g, max_iter=20, backend="cuda").rank
    err16 = float((pr16.rank - pr32).abs().max())
    rel16 = float(((pr16.rank - pr32).abs() / pr32).max())
    if err16 >= 1e-2 or pr16.rank.dtype != torch.float32:
        raise AssertionError(f"bf16 PageRank off fp32 by {err16}")
    # the grid's against the oracles
    t0 = time.monotonic()
    depths = [R.bfs_ref(gg, s) for s in gsrc]
    for label in ("bfs_batch push", "bfs_batch pull", "bfs_batch auto"):
        labels = results["grid-int32", label].labels.cpu().numpy()
        for i, want in enumerate(depths):
            if not np.array_equal(labels[i], want):
                raise AssertionError(f"{label} on the grid differs from "
                                     f"the oracle (lane {i})")
    if not np.array_equal(results["grid-int32", "sssp_batch"].dist.cpu()
                          .numpy(), R.sssp_ref(gg, gsrc)):
        raise AssertionError("sssp_batch on the grid differs from Dijkstra")
    pr_rel = R.pagerank_rel_err(
        results["grid-int32", "pagerank"][0].cpu().numpy(),
        R.pagerank_ref(graphs["grid-int32"], iters=20))
    if pr_rel > R.PR_RTOL:
        raise AssertionError(f"pagerank on the grid off the oracle by "
                             f"{pr_rel}")
    print(f"validated path (e): delta = int32 on the grid (bfs_batch and "
          f"sssp_batch at side {GRID_TRAVERSAL_SIDE}, pagerank at "
          f"{GRID_SIDE}), int16 = int64 = "
          f"int32 on rmat scale {INT16_SCALE} (bfs push / pull / auto, "
          f"sssp_batch, pagerank, triangle_count), bit for bit; rmat-22 "
          f"delta's bfs_batch and sssp_batch = int32's through the dense "
          f"fallback; the "
          f"grid against numpy BFS, scipy Dijkstra and numpy PageRank "
          f"(max |rank error| / rank {pr_rel:.3g}); bf16 PageRank at "
          f"rmat-22 within {err16:.3g} of fp32 (limit 1e-2; {rel16:.3g} "
          f"relative), in "
          f"{time.monotonic() - t0:.1f} s")
    return launches, variants


def _profiled(torch, label, fn, top, host_ops=True):
    """``fn`` once under torch.profiler: wall, device busy time, idle
    share, device operations and the ``top`` device operations.
    ``host_ops=False`` traces the device alone (its busy time is all
    this reads), for a run of many thousand steps whose host events the
    profiler cannot summarise within the time limit."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA]
    if host_ops:
        acts.insert(0, ProfilerActivity.CPU)
    with profile(activities=acts) as prof:
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
          f"{busy:.1f} ms, idle share {1 - busy / (wall * 1e3):.3f}, "
          f"{sum(r[1] for r in rows)} device operations")
    for us, count, key in sorted(rows, reverse=True)[:top]:
        print(f"  {us / 1e3:10.3f} ms {count:6d}x  {key[:90]}")


def _count_syncs(torch, fn):
    """(fn's result, the synchronizing CUDA calls it made), counted by
    PyTorch's sync debug mode: one warning a synchronizing call, "called
    a synchronizing CUDA operation"; the mode's one-time notice that it
    is a prototype is not counted."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("called a synchronizing" in str(w.message)
                    for w in caught)


def _sixth_slice_path(torch, np, K, g, g16, sources, hub, oracle, dev,
                      root):
    """Path (f), the serving slice, on the cuda backend: a clean
    ``serve_mixed`` stream at the main scale (64 queries, the four kinds
    interleaved, batch 4, path (a)'s sources among them), every served
    lane bit-equal to a direct call of its primitive on the same sources
    (and to path (a)'s / (c)'s oracle-checked answers on those), every
    query ok, nothing retried or declared, K1-K4m launched; a chaos
    stream on ``g16`` under a seeded fault plan (256 queries, one status
    a query, counters that reconcile, every clause of the plan fired,
    degraded answers from the torch rung on the card); bfs with telemetry on and off (bit-equal, the frontier column
    the level sizes, the same host reads and synchronizing calls a
    step); graph_serve's CLI with ``--trace``. Returns the clean
    stream's launches."""
    from repro_torch import obs
    from repro_torch.core import backend as B
    from repro_torch.core import enactor
    from repro_torch.core.primitives import bfs
    from repro_torch.ft import inject
    from repro_torch.launch import graph_serve as GS
    from repro_torch.obs import telemetry as T
    from repro_torch.obs.metrics import Metrics

    kinds = GS.KINDS
    n = g.num_vertices
    rng = np.random.default_rng(22)
    pool = list(sources) + [int(v) for v in rng.choice(n, 12, replace=False)]
    queries = [(kinds[i % 4], pool[i // 4]) for i in range(64)]
    # warmup, as graph_serve's: one batch a kind
    for kind in kinds:
        GS._host(GS._run_kind(g, kind, np.asarray(sources), "cuda",
                              HOPS)[0])
    served = []

    def runner(kind, srcs, backend, hops):
        out = GS._run_kind(g, kind, srcs, backend, hops)
        served.append((kind, srcs.copy(), out[0]))
        return out

    before = B.declared_fallbacks()
    metrics = Metrics()
    K.reset_launches()
    torch.cuda.synchronize()
    stats = GS.serve_mixed(g, queries, BATCH, "cuda", hops=HOPS,
                           runner=runner, metrics=metrics)
    launches = {k: v.launches for k, v in K.KERNELS.items()}
    variants = {k: dict(v.variants) for k, v in K.KERNELS.items()}
    if (stats["status_counts"]["ok"] != 64 or stats["retried"]
            or B.declared_fallbacks() != before):
        raise AssertionError(f"the clean stream: {stats['status_counts']}, "
                             f"retried {stats['retried']}, fallbacks "
                             f"{B.declared_fallbacks()}")
    missing = [k for k in ("advance_filter_batch", "compact",
                           "advance_batch", "spmv", "spmm")
               if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on path (f): "
                             f"{missing}")
    print(f"path (f) launches: {launches}")
    print(f"path (f) clean stream (rmat scale {int(math.log2(n))}, 64 "
          f"queries, batch {BATCH}): {stats['qps']} q/s over "
          f"{stats['total_s']} s; all lat ms p50 {stats['lat_ms_p50']} "
          f"p95 {stats['lat_ms_p95']} p99 {stats['lat_ms_p99']} (n = "
          f"{stats['samples']}; at n = 16 a kind, p95 and p99 are about "
          f"its worst flush, not a tail)")
    for kind, row in stats["per_kind"].items():
        print(f"  {kind:9s} n = {row['requests']} queries: lat ms mean "
              f"{row['lat_ms_mean']} p50 {row['lat_ms_p50']} p95 "
              f"{row['lat_ms_p95']} p99 {row['lat_ms_p99']}")
    # every served lane against a direct call on the same sources (timed:
    # the primitive alone, fenced), path (a)'s and (c)'s answers on theirs
    direct_ms = {k: [] for k in kinds}
    for i, (kind, srcs, field) in enumerate(served):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        want = GS._run_kind(g, kind, srcs, "cuda", HOPS)[0]
        torch.cuda.synchronize()
        direct_ms[kind].append((time.monotonic() - t0) * 1e3)
        if not torch.equal(field, want):
            raise AssertionError(f"path (f) flush {i} ({kind}) differs from "
                                 f"a direct {kind} call")
        if list(srcs) == list(sources) and not torch.equal(field,
                                                           oracle[kind]):
            raise AssertionError(f"path (f) {kind} on path (a)'s sources "
                                 f"differs from its oracle-checked answer")
    covered = sorted({k for k, s, _ in served if list(s) == list(sources)})
    if covered != sorted(kinds):
        raise AssertionError(f"path (a)'s sources served for {covered}")
    # where a flush's time goes beyond its primitive (medians, ms)
    med = statistics.median
    for kind in kinds:
        fl = [f for f in stats["flushes"] if f["kind"] == kind]
        flush, prim = med(f["flush_ms"] for f in fl), med(direct_ms[kind])
        print(f"  {kind:9s} flush {flush:.3f} ms = primitive call "
              f"{med(f['run_ms'] for f in fl):.3f} + host copy (the fence) "
              f"{med(f['copy_ms'] for f in fl):.3f} + guardrail "
              f"{med(f['guard_ms'] for f in fl):.3f} + rest; the primitive "
              f"fenced alone {prim:.3f} ms; the flush beyond it "
              f"{flush - prim:.3f} ms")
    field = torch.zeros((BATCH, n), dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    copy_ms = _timed(torch, lambda: field.cpu(), 10)
    print(f"  a ready ({BATCH}, {n}) int32 field's host copy: "
          f"{copy_ms:.3f} ms; every served lane bit-equal to its direct "
          f"call, path (a)'s sources equal to the oracle-checked answers; "
          f"all 64 ok, retried 0, no fallback declared")
    del served, field

    # the chaos stream at rmat-16: 256 queries, so that each clause draws
    # often enough to fire (nan draws only on a float answer that got
    # past the misses, about 6 times in 64 queries: 0.8^6 = 26 % odds of
    # no fire; at 256 the odds are under 1 %)
    n16 = g16.num_vertices
    n_chaos = 256
    rng = np.random.default_rng(16)
    chaos_q = [(kinds[i % 4], int(rng.integers(0, n16)))
               for i in range(n_chaos)]
    cm = Metrics()
    spec = "provider_miss@0.3;nan@0.2;straggler@0.1"
    t0 = time.monotonic()
    with inject.faults(spec, seed=0) as plan:
        chaos = GS.serve_mixed(g16, chaos_q, BATCH, "cuda", hops=HOPS,
                               metrics=cm, retry=GS.ft.RetryPolicy(
                                   retries=2, base_ms=1.0))
    counts = chaos["status_counts"]
    recs = chaos["queries"]
    fams = cm._families

    def ctotal(name):
        fam = fams.get(f"graph_serve_{name}")
        return 0 if fam is None else int(sum(fam.series.values()))

    if (sum(counts.values()) != n_chaos or any(r is None for r in recs)
            or counts != {s: sum(r["status"] == s for r in recs)
                          for s in GS.STATUSES}
            or any(ctotal(GS._STATUS_COUNTER[s]) != counts[s]
                   for s in GS.STATUSES)
            or ctotal("queries_retried_total") != chaos["retried"]):
        raise AssertionError(f"the chaos stream does not reconcile: "
                             f"{counts}")
    if not all(plan.fired[k] > 0 for k in plan.clauses):
        raise AssertionError(f"a clause of '{spec}' never fired in the "
                             f"chaos stream: {plan.fired}")
    # every answer from a lower rung: the plain providers on the card
    degraded = [f for f in chaos["flushes"] if f["rung"]
                and f["error"] is None]
    for f in degraded:
        if f["backend"] != "torch" or f["device"] != str(g16.device):
            raise AssertionError(f"a degraded flush ran off the card: {f}")
    n_deg = sum(r["status"] == "degraded" for r in recs)
    rungs = sorted({r.get("degraded_to") for r in recs
                    if r["status"] == "degraded"})
    print(f"path (f) chaos stream (rmat scale {int(math.log2(n16))}, "
          f"'{spec}', seed 0, {n_chaos} queries): {counts}, retried "
          f"{chaos['retried']}, stragglers {chaos['stragglers']}, faults "
          f"fired {plan.fired}; {n_deg} degraded answers, from {rungs}, "
          f"their flushes on backend torch on "
          f"{sorted({f['device'] for f in degraded})}; counters "
          f"reconcile; {time.monotonic() - t0:.1f} s")

    # telemetry at the main scale: bit parity, the level oracle, one host
    # read a step and no synchronizing call added
    # the first call under sync debug mode makes one more (its own
    # set-up): warm it before counting
    _count_syncs(torch, lambda: bfs(g, hub, backend="cuda"))
    runs = {}
    for on in (False, True):
        enactor.reset_host_reads()
        out, syncs = _count_syncs(
            torch, lambda: bfs(g, hub, backend="cuda", telemetry=on))
        runs[on] = (out, syncs, enactor.host_reads())
    plain, (r, buf) = runs[False][0], runs[True][0]
    for f in plain._fields:
        if not torch.equal(getattr(plain, f), getattr(r, f)):
            raise AssertionError(f"bfs {f} differs with telemetry on")
    steps = int(r.iterations)
    trace, trim_syncs = _count_syncs(
        torch, lambda: T.trim(buf, r.iterations[None]))
    lane = trace.lane(0)
    lab = r.labels.cpu().numpy()
    want = np.bincount(lab[lab >= 0], minlength=steps + 1)[1:steps + 1]
    if not np.array_equal(lane["frontier"], want):
        raise AssertionError("the telemetry frontier column is not the "
                             "level sizes")
    if not runs[False][2] == runs[True][2] == steps + 1:
        raise AssertionError(f"host reads: {runs[False][2]} off, "
                             f"{runs[True][2]} on, {steps} steps")
    if runs[True][1] != runs[False][1]:
        raise AssertionError(f"telemetry added synchronizing calls: "
                             f"{runs[False][1]} off, {runs[True][1]} on")
    print(f"path (f) telemetry: bfs from the hub at rmat scale "
          f"{int(math.log2(n))}, {steps} steps, bit-equal on and off; "
          f"frontier column = the level sizes {lane['frontier'].tolist()}; "
          f"enactor host reads {runs[True][2]} on, {runs[False][2]} off "
          f"(one a step and the last); synchronizing calls "
          f"{runs[True][1]} on, {runs[False][1]} off, trim {trim_syncs}; "
          f"tier {lane['tier'].tolist()}, direction "
          f"{lane['direction'].tolist()}")

    # graph_serve's CLI: --trace, --json, --metrics
    out = root / "build" / "chip_smoke_serve"
    out.mkdir(parents=True, exist_ok=True)
    obs.reset()
    cli = GS.main(["--scale", str(int(math.log2(n16))), "--kinds",
                   ",".join(kinds), "--requests", "16", "--batch",
                   str(BATCH), "--validate", "--trace",
                   str(out / "trace.json"), "--json", str(out / "rows.json"),
                   "--metrics", str(out / "metrics.prom")])
    names = {e["name"] for e in json.loads(
        (out / "trace.json").read_text())["traceEvents"]}
    if not {"build_graph", "warmup", "serve"} <= names or cli[
            "validation_failures"] or cli["status_counts"]["ok"] != 16:
        raise AssertionError(f"graph_serve's CLI: spans {names}, "
                             f"{cli['status_counts']}")
    print(f"path (f) graph_serve CLI at rmat scale {int(math.log2(n16))}: "
          f"{cli['qps']} q/s, validated, resident {cli['resident_bytes']} "
          f"B, trace spans {sorted(names)}")
    return launches, variants, stats



STRATEGIES = ("LB", "TWC", "THREAD")
TABLE8_LANES = 256     # table8_utilization.py's hub frontier: 256 neighbours
TABLE8_TILE = 512      # its LB / TWC slot rounding


def _edge_keys(torch, g):
    """row * n + column of every CSR slot, int64, ascending (rows in
    order, each row's columns sorted): an edge (u, v) is a binary search
    away."""
    row = (g.row_seg if g.row_seg is not None
           else torch.repeat_interleave(
               torch.arange(g.num_vertices, device=g.device),
               g.degrees.long()))
    return row.long() * g.num_vertices + g.cols().long()


def _check_tree(torch, g, keys, srcs, preds, labels=None, dist=None):
    """Raise unless ``preds`` (B, n) form a BFS tree of ``labels`` (every
    reached vertex but the source has a predecessor one level up, along
    an edge) or an SSSP tree of ``dist`` (dist[p] + w(p, v) == dist[v],
    the float32 add the relax makes); unreached vertices and the
    sources have none."""
    n = g.num_vertices
    b = preds.shape[0]
    reached = labels >= 0 if dist is None else torch.isfinite(dist)
    root = torch.zeros_like(reached)
    root[torch.arange(b, device=g.device),
         torch.as_tensor(srcs, device=g.device).long()] = True
    if bool((preds[~reached | root] != -1).any()):
        raise AssertionError("a source or an unreached vertex has a "
                             "predecessor")
    lane, v = torch.nonzero(reached & ~root, as_tuple=True)
    p = preds[lane, v].long()
    if bool((p < 0).any()):
        raise AssertionError("a reached vertex has no predecessor")
    key = p * n + v
    pos = torch.searchsorted(keys, key).clamp_(max=keys.numel() - 1)
    if not bool((keys[pos] == key).all()):
        raise AssertionError("a predecessor is no in-neighbour")
    if dist is None:
        ok = labels[lane, p] == labels[lane, v] - 1
    else:
        ok = dist[lane, p] + g.edge_values[pos] == dist[lane, v]
    if not bool(ok.all()):
        raise AssertionError("a predecessor is not one step up the tree")


def _same(torch, a, b, what):
    """Raise unless every tensor field of ``a`` (a named tuple or a
    frontier) equals ``b``'s."""
    names = (a._fields if hasattr(a, "_fields")
             else [f.name for f in dataclasses.fields(a)])
    for f in names:
        x, y = getattr(a, f), getattr(b, f)
        if not torch.equal(x, y):
            raise AssertionError(f"path (g) {what}: {f} differs between "
                                 f"the cuda and torch backends")


def _launch_counts(K):
    return {k: v.launches for k, v in K.KERNELS.items()}


def _launched(K, before):
    return {k: v.launches - before[k] for k, v in K.KERNELS.items()
            if v.launches > before[k]}


def _seventh_slice_path(torch, np, K, P, O, F, G, R, SR, g, sources,
                        depths, dist, dev):
    """Path (g), the load-balancing and idempotence ablations (the
    paper's Fig. 19, Fig. 20 and Table 8) on the cuda backend, at rmat-22
    on path (a)'s four sources and on grid2d(FIG20_GRID_SIDE):
    bfs_batch (push only, exact uniquify) and sssp_batch under LB, TWC
    and THREAD, bfs_batch under TWC with idempotence x direction, each
    labels / distances equal to path (a)'s oracles and its predecessors
    a valid tree wherever nothing overflowed, every TWC and THREAD run
    bit-equal to the same run on the torch backend on the card (TWC
    launching K3 and K2, THREAD K2 and no K3); one advance of
    table8_utilization.py's hub frontier under each strategy (a THREAD
    advance launches no K3), the filter family, partition_frontier,
    neighborhood_reduce and advance_to_edge_frontier on it, cuda equal to
    torch; the reference's oracle names at path (a)'s shapes, each
    equal to the kernel it models. Returns the launches in
    total and by variant, and the ablation's times."""
    from repro_torch.core.primitives import bfs_batch, sssp_batch
    n, m = g.num_vertices, g.num_edges
    b = len(sources)
    gname = f"rmat-{int(math.log2(n))}"
    K.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    keys = _edge_keys(torch, g)
    times = {}

    def timed(label, fn):
        torch.cuda.synchronize()
        t = time.monotonic()
        out = fn()
        torch.cuda.synchronize()
        times[label] = (time.monotonic() - t) * 1e3
        return out

    def run_pair(label, prim, gr, srcs, **kw):
        """The cuda run, its launches, and for TWC / THREAD the same run
        on the torch backend, bit-equal."""
        before = _launch_counts(K)
        got = timed(label, lambda: prim(gr, srcs, backend="cuda", **kw))
        launched = _launched(K, before)
        strategy = kw.get("strategy", "LB")
        if strategy != "LB":
            plain = timed(label + " [torch]",
                          lambda: prim(gr, srcs, backend="torch", **kw))
            _same(torch, got, plain, label)
            if strategy == "TWC" and not {"advance_batch", "compact"} <= set(
                    launched):
                raise AssertionError(f"{label} launched {launched}, not "
                                     f"K3 and K2")
            if strategy == "THREAD" and ("compact" not in launched
                                         or "advance_batch" in launched):
                raise AssertionError(f"{label} launched {launched}: "
                                     f"THREAD launches K2 and no K3")
        return got, launched

    # ---- Fig. 20 (strategies) and Fig. 19 (idempotence x direction) at
    # rmat-22: push-only BFS with exact uniquify, as fig20_strategies.py
    fig20 = {}
    for s in STRATEGIES:
        r, launched = run_pair(f"{gname} bfs_batch {s}", bfs_batch, g,
                               sources, direction=False, idempotence=False,
                               strategy=s)
        for i, want in enumerate(depths):
            if not np.array_equal(r.labels[i].cpu().numpy(), want):
                raise AssertionError(f"path (g) bfs_batch {s} lane {i} "
                                     f"differs from the oracle")
        if int(r.overflow.sum()):
            raise AssertionError(f"bfs_batch {s} overflowed under exact "
                                 f"uniquify")
        _check_tree(torch, g, keys, sources, r.preds, labels=r.labels)
        fig20["bfs", s] = (times[f"{gname} bfs_batch {s}"],
                           int(r.iterations.max()), launched)
        if s == "TWC":
            twc_exact_push = r        # Fig. 19's (exact, push only) cell
        del r
        r, launched = run_pair(f"{gname} sssp_batch {s}", sssp_batch, g,
                               sources, strategy=s)
        if not np.array_equal(r.dist.cpu().numpy(), dist):
            raise AssertionError(f"path (g) sssp_batch {s} differs from "
                                 f"Dijkstra")
        _check_tree(torch, g, keys, sources, r.preds, dist=r.dist)
        fig20["sssp", s] = (times[f"{gname} sssp_batch {s}"],
                            int(r.iterations.max()), launched,
                            int(r.relaxations.sum()))
        del r
        torch.cuda.empty_cache()
    fig19 = {}
    for idem in (False, True):
        for direction in (False, True):
            label = (f"{gname} bfs_batch TWC idempotence={idem} "
                     f"direction={direction}")
            if not (idem or direction):
                # Fig. 20's TWC run, checked there
                times[label] = times[f"{gname} bfs_batch TWC"]
                r = twc_exact_push
            else:
                r, _ = run_pair(label, bfs_batch, g, sources,
                                direction=direction, idempotence=idem,
                                strategy="TWC")
            ovf = r.overflow.tolist()
            for i, want in enumerate(depths):
                if ovf[i] == 0 and not np.array_equal(
                        r.labels[i].cpu().numpy(), want):
                    raise AssertionError(f"path (g) {label} lane {i} "
                                         f"differs from the oracle")
            if not any(ovf):
                _check_tree(torch, g, keys, sources, r.preds,
                            labels=r.labels)
            if idem:
                print(f"path (g) {label}: overflow per lane {ovf}")
            fig19[idem, direction] = (times[label], int(r.iterations.max()),
                                      int(r.pull_iters.max()), ovf)
            del r
            torch.cuda.empty_cache()
    del twc_exact_push
    peak_rmat = torch.cuda.max_memory_allocated()

    # ---- Table 8: one advance of the hub's frontier (its first 256
    # distinct neighbours, capacity m) under each strategy, and the
    # operators on it
    ro, ci = g.row_offsets, g.col_indices
    hub = sources[0]
    ids = torch.unique(ci[int(ro[hub]):int(ro[hub + 1])])[:TABLE8_LANES]
    fr = F.from_ids(ids, m, device=dev)
    work = int(g.degrees[ids.long()].sum())
    wides, utilization = {}, []
    for s in STRATEGIES:
        before = _launch_counts(K)
        res, _ = O.advance(g, fr, m, strategy=s, backend="cuda")
        launched = _launched(K, before)
        res_t, _ = O.advance(g, fr, m, strategy=s, backend="torch")
        _same(torch, res, res_t, f"advance {s}")
        if s == "THREAD" and launched:
            raise AssertionError(f"a THREAD advance launched {launched}")
        if s != "THREAD" and "advance_batch" not in launched:
            raise AssertionError(f"an {s} advance launched {launched}")
        valid = int(res.valid.sum())
        if valid != work:
            raise AssertionError(f"advance {s}: {valid} live slots, the "
                                 f"frontier has {work} edges")
        slots = m if s == "THREAD" else max(-(-valid // TABLE8_TILE)
                                            * TABLE8_TILE, TABLE8_TILE)
        utilization.append((s, work, slots, 100.0 * valid / slots))
        for cap in (None, work):
            _same(torch, O.advance_to_edge_frontier(res, cap, backend="cuda"),
                  O.advance_to_edge_frontier(res_t, cap, backend="torch"),
                  f"advance_to_edge_frontier {s}")
        wides[s] = O.advance_to_vertex_frontier(res, backend="cuda")
        del res, res_t
    for s in STRATEGIES:
        for op in ("add", "max", "min"):
            def edge_map(src, dst, eid, valid, data):
                return g.edge_values[torch.where(valid, eid, 0).long()]
            got = O.neighborhood_reduce(g, fr, m, edge_map, op, init=-1.0,
                                        strategy=s, backend="cuda")
            want = O.neighborhood_reduce(g, fr, m, edge_map, op, init=-1.0,
                                         strategy=s, backend="torch")
            if not torch.equal(got, want):
                raise AssertionError(f"neighborhood_reduce {op} {s} differs "
                                     f"between the backends")
    # the hub frontier's expansion (duplicates and all) through the filter
    # family: one lane, and LB's and TWC's orders as a batch of two
    for uniq in ("exact", "hash"):
        for s in STRATEGIES:
            a, _ = O.filter_frontier(wides[s], n=n, uniquify=uniq, cap=n,
                                     backend="cuda")
            c, _ = O.filter_frontier(wides[s], n=n, uniquify=uniq, cap=n,
                                     backend="torch")
            _same(torch, a, c, f"filter_frontier {uniq} {s}")
        batch = F.BatchedSparseFrontier(
            torch.stack([wides["LB"].ids, wides["TWC"].ids]),
            torch.stack([wides["LB"].length, wides["TWC"].length]))
        a, _, ao = O.filter_frontier_batch(batch, n=n, uniquify=uniq,
                                           cap=n, backend="cuda")
        c, _, co = O.filter_frontier_batch(batch, n=n, uniquify=uniq,
                                           cap=n, backend="torch")
        _same(torch, a, c, f"filter_frontier_batch {uniq}")
        if not torch.equal(ao, co):
            raise AssertionError(f"filter_frontier_batch {uniq} overflow "
                                 f"differs between the backends")
        if uniq == "exact" and not bool((a.lengths == a.lengths[0]).all()):
            raise AssertionError("exact uniquify kept different id sets")
    w = wides["LB"]
    pred = w.ids % 2 == 0
    a = O.partition_frontier(w, pred, n, n, backend="cuda")
    c = O.partition_frontier(w, pred, n, n, backend="torch")
    for x, y in zip(a, c):
        _same(torch, x, y, "partition_frontier")
    del wides, batch, w, pred, a, c, fr
    torch.cuda.empty_cache()

    # ---- the reference's oracle names at path (a)'s shapes, each
    # against the kernel it models
    api = _kernel_api_names(torch, K, P, SR, g, sources, dev)

    # ---- the mesh contrast: grid2d(FIG20_GRID_SIDE)
    gm = G.grid2d(FIG20_GRID_SIDE, weighted=True, seed=0, device=dev)
    nm = gm.num_vertices
    msrc = [0, nm // 2 + FIG20_GRID_SIDE // 2, 12345 % nm, nm - 1]
    mdepths = [R.bfs_ref(gm, s) for s in msrc]
    mdist = R.sssp_ref(gm, msrc)
    mkeys = _edge_keys(torch, gm)
    for s in STRATEGIES:
        r, launched = run_pair(f"grid-{FIG20_GRID_SIDE} bfs_batch {s}",
                               bfs_batch, gm, msrc, direction=False,
                               idempotence=False, strategy=s)
        for i, want in enumerate(mdepths):
            if not np.array_equal(r.labels[i].cpu().numpy(), want):
                raise AssertionError(f"path (g) grid bfs_batch {s} lane {i} "
                                     f"differs from the oracle")
        _check_tree(torch, gm, mkeys, msrc, r.preds, labels=r.labels)
        fig20["grid bfs", s] = (times[f"grid-{FIG20_GRID_SIDE} bfs_batch "
                                      f"{s}"], int(r.iterations.max()),
                                launched)
        r, launched = run_pair(f"grid-{FIG20_GRID_SIDE} sssp_batch {s}",
                               sssp_batch, gm, msrc, strategy=s)
        if not np.array_equal(r.dist.cpu().numpy(), mdist):
            raise AssertionError(f"path (g) grid sssp_batch {s} differs "
                                 f"from Dijkstra")
        _check_tree(torch, gm, mkeys, msrc, r.preds, dist=r.dist)
        fig20["grid sssp", s] = (times[f"grid-{FIG20_GRID_SIDE} "
                                       f"sssp_batch {s}"],
                                 int(r.iterations.max()), launched,
                                 int(r.relaxations.sum()))
    del gm, mkeys, keys
    torch.cuda.empty_cache()
    launches = {k: v.launches for k, v in K.KERNELS.items()}
    variants = {k: dict(v.variants) for k, v in K.KERNELS.items()}
    missing = [k for k in ("advance_filter_batch", "compact",
                           "advance_batch") if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on path (g): "
                             f"{missing}")

    print(f"path (g) launches: {launches}; peak device memory at rmat "
          f"scale {int(math.log2(n))} {peak_rmat / 2 ** 30:.2f} GiB")
    print("path (g) Fig. 20 (ms a run on the cuda backend, B = "
          f"{b}; iterations; launches; [torch backend ms]):")
    for (what, s), row in fig20.items():
        graph = "grid" if what.startswith("grid") else gname
        prim = what.split()[-1]
        key = (f"grid-{FIG20_GRID_SIDE} {prim}_batch {s}"
               if graph == "grid" else f"{gname} {prim}_batch {s}")
        plain = times.get(key + " [torch]")
        extra = (f", relaxations {row[3]}" if len(row) > 3 else "")
        print(f"  {graph:8s} {prim:5s} {s:6s} {row[0]:10.2f} ms  iterations "
              f"{row[1]}{extra}; {row[2]}"
              + (f"; torch {plain:.2f} ms" if plain is not None else ""))
    print(f"path (g) Fig. 19 ({gname} bfs_batch TWC, ms on the cuda backend; "
          "iterations; pull iterations; overflow per lane):")
    for (idem, direction), (ms, iters, pulls, ovf) in fig19.items():
        print(f"  idempotence={idem!s:5s} direction={direction!s:5s} "
              f"{ms:10.2f} ms  {iters} {pulls} {ovf}")
    print(f"path (g) Table 8 (the hub's first {TABLE8_LANES} neighbours, "
          f"capacity m): " + "; ".join(
              f"{s} work {wk} slots {sl} utilization {u:.2f} %"
              for s, wk, sl, u in utilization))
    print(f"path (g) oracle names equal to their kernels: "
          f"{api}")
    return launches, variants, times


def _eighth_slice_path(torch, np, K, G, g, g16, hub, sources, single,
                       tri16, dev):
    """Path (h): the sharded (1-D, MESH_PARTS parts) and 2-D (MESH_SHAPE
    vertex cut) placements with every part on the one card. On the main
    graph: distributed bfs and sssp from the hub, cc, pagerank (20
    sweeps) and reach (path (c)'s sources, HOPS hops), each bit-equal to
    paths (a)-(c)'s single-placement run on the card (``single``:
    {name: (result, ms)}); at scale 16: label propagation
    (LP_MESH_ITERS sweeps) and triangle counting's masked product (its
    count = ``tri16``), each equal to a single-placement run made here.
    No kernel may launch under a placement (the cuda backend runs the
    torch provider of a placement, as the reference runs xla under its
    own). Then graph_serve ``--parts`` / ``--mesh`` at scale 16 with
    ``--validate``, and a chaos stream on the mesh under
    ``shard_loss@0.2``. Prints ms single / 1-D / 2-D (host clock ending
    in a synchronize), exchange_bytes_per_step, each placement's
    balance and peak device memory. Returns the launch counts under the
    placements (all 0)."""
    from repro_torch import ft
    from repro_torch import linalg as L
    from repro_torch.core import backend as B
    from repro_torch.core import distributed as D
    from repro_torch.core.partition import Mesh, partition_1d, partition_2d
    from repro_torch.core.primitives import label_propagation
    from repro_torch.core.primitives import tc as TC
    from repro_torch.launch import graph_serve as GS

    t_path = time.monotonic()
    rows, cols = MESH_SHAPE
    meshes = {"1-D": Mesh.on(dev, (MESH_PARTS,), ("graph",)),
              "2-D": Mesh.on(dev, MESH_SHAPE, ("row", "col"))}

    def partitions(gr):
        t = time.monotonic()
        out = {"1-D": partition_1d(gr, MESH_PARTS),
               "2-D": partition_2d(gr, rows, cols)}
        host_s = time.monotonic() - t
        t = time.monotonic()
        for name, pg in out.items():
            D._shard_any(pg, meshes[name], meshes[name].axis_names[0]
                         if name == "1-D" else ("row", "col"))
        torch.cuda.synchronize()
        return out, host_s, time.monotonic() - t

    def timed(fn):
        torch.cuda.synchronize()
        t = time.monotonic()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.monotonic() - t) * 1e3

    def same(a, b, what):
        if not torch.equal(a, b):
            raise AssertionError(f"path (h) {what} differs from its "
                                 f"single-placement run")

    # the scale-16 single-placement runs, made before the counters reset
    lp1, lp_ms = timed(lambda: label_propagation(
        g16, max_iter=LP_MESH_ITERS, backend="cuda"))
    sub, ssrc, sdst = TC._orient(g16)
    tc_args = ((ssrc, sdst),)
    tc_kw = dict(semiring=L.plus_and, b_transpose=True, structural=True)
    tc1, tc_ms = timed(lambda: L.mxm(sub, sub, *tc_args, backend="cuda",
                                     **tc_kw))
    single = dict(single, lp=(lp1.labels, lp_ms), tc=(tc1, tc_ms))

    parts, part_s, shard_s = partitions(g)
    parts16, part16_s, shard16_s = partitions(g16)
    subparts, _, _ = partitions(sub)
    print(f"path (h) partitions: rmat scale {int(math.log2(g.num_vertices))}"
          f" 1-D ({MESH_PARTS} parts) and 2-D ({rows}x{cols}) on the host "
          f"in {part_s:.1f} s, put on the card in {shard_s:.1f} s; rmat "
          f"scale {int(math.log2(g16.num_vertices))} in {part16_s:.1f} + "
          f"{shard16_s:.1f} s")
    for name, pg in parts.items():
        print(f"path (h) {name} balance: {json.dumps(pg.balance())}")

    K.reset_launches()
    rows_out = {}
    peaks = {}
    for name, pg in parts.items():
        mesh = meshes[name]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        runs = {
            "bfs": lambda: D.distributed_bfs(pg, hub, mesh).labels,
            "sssp": lambda: D.distributed_sssp(pg, hub, mesh).dist,
            "cc": lambda: D.distributed_cc(pg, mesh).labels,
            "pagerank": lambda: D.distributed_pagerank(pg, mesh, iters=20),
            "reach": lambda: D.distributed_reach(
                pg, sources, HOPS, mesh=mesh).reached,
            "lp": lambda: D.distributed_label_propagation(
                parts16[name], mesh, max_iter=LP_MESH_ITERS).labels,
            "tc": lambda: L.mxm(D._shard_any(subparts[name], mesh,
                                             mesh.axis_names[0]
                                             if name == "1-D"
                                             else ("row", "col")),
                                sub, *tc_args, **tc_kw),
        }
        for prim, fn in runs.items():
            got, ms = timed(fn)
            same(got, single[prim][0], f"{name} {prim}")
            rows_out.setdefault(prim, {})[name] = ms
        if int(single["tc"][0].sum()) != tri16:
            raise AssertionError(f"path (h) {name} triangles "
                                 f"{int(single['tc'][0].sum())} != {tri16}")
        peaks[name] = torch.cuda.max_memory_allocated()
    launches = {k: v.launches for k, v in K.KERNELS.items()}
    if any(launches.values()):
        raise AssertionError(f"path (h) launched kernels under a "
                             f"placement: {launches}")
    print(f"path (h) launches under the placements: {launches} (the cuda "
          f"backend runs each placement's torch provider)")
    scale = int(math.log2(g.num_vertices))
    scale16 = int(math.log2(g16.num_vertices))
    print(f"path (h) ms a run on {_smi()} (host clock ending in a "
          f"synchronize; single = the cuda backend's run; rmat scale "
          f"{scale} unless marked; every placement result bit-equal to "
          f"single):")
    print(f"  {'primitive':22s} {'single':>10s} {'1-D':>10s} {'2-D':>10s}"
          f"   exchange B/step 1-D / 2-D")
    labels = {"bfs": "bfs (hub)", "sssp": "sssp (hub)", "cc": "cc",
              "pagerank": "pagerank (20 sweeps)",
              "reach": f"reach ({len(sources)} srcs, {HOPS} hops)",
              "lp": f"label_prop {scale16} ({LP_MESH_ITERS} it)",
              "tc": f"tc mxm {scale16}"}
    for prim, per in rows_out.items():
        xb = ""
        if prim in ("bfs", "sssp", "cc", "pagerank"):
            xb = " / ".join(str(D.exchange_bytes_per_step(parts[k], prim))
                            for k in ("1-D", "2-D"))
        print(f"  {labels[prim]:22s} {single[prim][1]:10.2f} "
              f"{per['1-D']:10.2f} {per['2-D']:10.2f}   {xb}")
    print(f"path (h) peak device memory: "
          + ", ".join(f"{k} {v / 2 ** 30:.2f} GiB" for k, v in peaks.items())
          + f"; triangles at scale {scale16} {tri16} on every placement")
    del parts, parts16, subparts, single
    torch.cuda.empty_cache()

    # graph_serve from the mesh, clean and under shard loss
    base = ["--graph", "rmat", "--scale", str(scale16), "--kinds",
            "bfs,sssp,pagerank,reach", "--batch", "4", "--log-level",
            "warning"]
    K.reset_launches()
    for flag, value in (("--parts", str(MESH_PARTS)),
                        ("--mesh", f"{rows}x{cols}")):
        stats = GS.main(base + ["--requests", "16", "--validate", flag,
                                value])
        if (stats["validation_failures"] != 0 or stats["parts"]
                != MESH_PARTS or stats["status_counts"]["ok"] != 16):
            raise AssertionError(f"path (h) graph_serve {flag} {value}: "
                                 f"{stats['status_counts']}, validation "
                                 f"failures {stats['validation_failures']}")
        print(f"path (h) graph_serve {flag} {value} (rmat scale {scale16}, "
              f"16 queries, batch 4): {stats['qps']} q/s, p50 / p95 "
              f"{stats['lat_ms_p50']} / {stats['lat_ms_p95']} ms, 0 "
              f"validation failures; exchange B/step "
              f"{stats['exchange_bytes_per_step']}; edge imbalance "
              f"{stats['balance']['edge_imbalance']}")
    launches_serve = {k: v.launches for k, v in K.KERNELS.items()}
    if any(launches_serve.values()):
        raise AssertionError(f"path (h) graph_serve from a mesh launched "
                             f"kernels: {launches_serve}")
    for kind in GS.KINDS:             # declared anew by this stream
        B._DECLARED_FALLBACKS.pop((kind, B.SINGLE), None)
        B._DECLARED_FALLBACKS.pop((kind, B.TORCH), None)
    stats = GS.main(base + ["--requests", "32", "--mesh", f"{rows}x{cols}",
                            "--faults", "shard_loss@0.2", "--faults-seed",
                            "0"])
    counts = stats["status_counts"]
    if sum(counts.values()) != 32 or len(stats["queries"]) != 32 or any(
            q is None for q in stats["queries"]):
        raise AssertionError(f"path (h) chaos stream: statuses {counts}")
    for q in stats["queries"]:
        if q["status"] != "degraded":
            continue
        # a lost shard degrades to single-device serving: on the mesh the
        # cuda→torch rung is skipped (it would rerun rung 0's provider)
        rungs = {r.reason: r for r in ft.ladder(
            q["kind"], "cuda", B.TWOD,
            hops=HOPS if q["kind"] == "reach" else None)
            if r.placement == B.SINGLE}
        r = rungs.get(q["degraded_to"])
        target = None if r is None else (
            r.placement if r.reason.startswith("placement") else r.backend)
        if r is None or not B.declared_fallback(q["kind"], target):
            raise AssertionError(f"path (h) chaos: query {q['id']} "
                                 f"degraded to an undeclared rung "
                                 f"{q['degraded_to']!r}")
    if counts["degraded"] == 0:
        raise AssertionError("path (h) chaos: shard_loss never fired")
    to_single = sorted({q["degraded_to"] for q in stats["queries"]
                        if q["status"] == "degraded"})
    flush_placements = sorted({f["placement"] for f in stats["flushes"]})
    if not any(r.startswith("placement") and r.endswith("→single")
               for r in to_single) or flush_placements != [B.TWOD,
                                                           B.SINGLE]:
        raise AssertionError(f"path (h) chaos: no flush ran the placement "
                             f"→single rung (degraded to {to_single}, "
                             f"flush placements {flush_placements})")
    print(f"path (h) chaos stream ({rows}x{cols} mesh, rmat scale "
          f"{scale16}, shard_loss@0.2 seed 0, 32 queries): {counts}; "
          f"degraded to {to_single}, flushes on {flush_placements}; every "
          f"degraded answer from a declared single-device rung, no "
          f"exception out of the stream")
    print(f"path (h) run and validated in {time.monotonic() - t_path:.1f} s")
    return launches


def _ninth_slice_path(torch, np, K, g18, g16, sm_cap, dev, root):
    """Path (i): the analysis layer on the card. The static checks on
    this machine (the registry's contracts and the lint over the port,
    tools/ and this script); every primitive under ``sanitizing()`` on
    the cuda backend — bfs_batch, sssp_batch, pagerank, cc, bc_batch,
    triangle_count and reach_batch on ``g18`` (rmat scale 18), label
    propagation (one sweep) and the triangle query of subgraph_match on
    ``g16`` (scale 16: LP costs m·n products a sweep, and the query's
    join passes int32 from scale 17 on) — then the kernel API's
    lb_expand, flash_attention (the split form, its partials and its
    combine) and moe_gather: every launch audited (the audits by C
    function equal the launch counters, all 11 sites among them), no
    fault, each result bit-equal to the same call unsanitized, each
    primitive's ms sanitized and not (host clock ending in a
    synchronize, after a warm call; a call whose two plain runs differ,
    bc_batch's float atomics, held to BC_RTOL). Then a seeded fault of
    each class
    (a K3 column id equal to n, a K2 output aliasing its input, a K2
    float mask) raises MemoryFault before its launch, and a clean K1
    call after them matches its plain version; ``retrace_guard`` holds
    a warm ``serve_mixed`` stream on ``g16`` (bfs / sssp / pagerank /
    reach, batch 4) to the budgets, and a query on a freshly built
    graph each time raises RetraceError. Returns the sanitized run's
    launches."""
    from repro_torch.analysis import sanitize
    from repro_torch.analysis.contracts import check_registry
    from repro_torch.analysis.lint import lint_paths
    from repro_torch.core import graph as G
    from repro_torch.core import operators as O
    from repro_torch.core.primitives import (bc_batch, bfs_batch,
                                             connected_components,
                                             label_propagation, pagerank,
                                             reach_batch, sssp_batch,
                                             subgraph_match, triangle_count)
    from repro_torch.kernels import ref as P
    from repro_torch.kernels import runtime
    from repro_torch.launch import graph_serve as GS

    t_path = time.monotonic()
    findings = check_registry()
    lint = lint_paths([str(root / "src" / "repro_torch"), str(root / "tools"),
                       str(root / "chip_smoke.py")])
    if findings or lint:
        raise AssertionError(f"path (i) static checks: {findings} "
                             f"{[f.render() for f in lint][:10]}")
    print(f"path (i) static checks: check_registry() = [], lint_paths "
          f"over src/repro_torch, tools and chip_smoke.py = [] "
          f"({time.monotonic() - t_path:.1f} s)")

    rng = np.random.default_rng(9)
    deg = g18.degrees.cpu().numpy()
    srcs = [int(np.argmax(deg))] + [int(v) for v in rng.choice(
        np.flatnonzero(deg > 0), BATCH - 1, replace=False)]
    q, k, v = (torch.randn((n, 128), dtype=torch.bfloat16, device=dev)
               for n in (128, 8192, 8192))
    xt = torch.randn((1024, 7168), dtype=torch.bfloat16, device=dev)
    slot = torch.randint(-1, 1025, (4096,), dtype=torch.int32, device=dev)

    def fields(r):
        return tuple(t for t in (r if isinstance(r, tuple) else (r,))
                     if isinstance(t, torch.Tensor))

    calls = {
        "bfs_batch": lambda: bfs_batch(g18, srcs, backend="cuda"),
        "sssp_batch": lambda: sssp_batch(g18, srcs, backend="cuda"),
        "pagerank": lambda: pagerank(g18, max_iter=20, backend="cuda"),
        "cc": lambda: connected_components(g18, backend="cuda"),
        "bc_batch": lambda: bc_batch(g18, srcs, backend="cuda"),
        "triangle_count": lambda: triangle_count(g18, backend="cuda"),
        "reach_batch": lambda: reach_batch(g18, srcs, HOPS, backend="cuda"),
        "label_propagation": lambda: label_propagation(
            g16, max_iter=1, backend="cuda"),
        "subgraph_match": lambda: subgraph_match(
            g16, 3, TRIANGLE, cap=sm_cap, backend="cuda"),
        "lb_expand": lambda: tuple(K.lb_expand(g18.degrees, g18.num_edges)),
        "flash_attention": lambda: (K.flash_attention(q, k, v),),
        "attention_parts": lambda: K.attention_partials(q, k, v, True, 16),
        "attention_combine": lambda: (K.attention_combine(
            *K.attention_partials(q, k, v, True, 16), torch.bfloat16),),
        "moe_gather": lambda: (K.moe_gather(xt, slot),),
    }

    def run(fn):
        torch.cuda.synchronize()
        t = time.monotonic()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.monotonic() - t) * 1e3

    # a call whose two plain runs differ (bc's dependency sums: float
    # atomics, in no order) is held to BC_RTOL instead of bit equality
    plain, ms_off, exact = {}, {}, {}
    for name, fn in calls.items():
        warm = fields(fn())                    # the set-up built
        out, ms_off[name] = run(fn)
        plain[name] = fields(out)
        exact[name] = all(torch.equal(a, b)
                          for a, b in zip(warm, plain[name]))
    K.reset_launches()
    sanitize.reset_audits()
    ms_on = {}
    with sanitize.sanitizing():
        for name, fn in calls.items():
            out, ms_on[name] = run(fn)
            for a, b in zip(plain[name], fields(out)):
                same = (torch.equal(a, b) if exact[name] else
                        torch.allclose(a, b, rtol=BC_RTOL, atol=BC_RTOL))
                if not same:
                    raise AssertionError(f"path (i) {name}: the sanitized "
                                         f"run differs from the plain one")
    launches = {n: kk.launches for n, kk in K.KERNELS.items()}
    variants = {n: dict(kk.variants) for n, kk in K.KERNELS.items()}
    audited = {n: 0 for n in K.KERNELS}
    for (_, fn_name), c in sanitize.audits().items():
        for kern in K.FUNCTION_KERNELS[fn_name]:
            audited[kern] += c
    sites = {s for s, _ in sanitize.audits()}
    if audited != launches or sites != set(K.SITES):
        raise AssertionError(f"path (i) audits {audited} (sites "
                             f"{sorted(sites)}) vs launches {launches}")
    missing = [n for n, c in launches.items() if c == 0]
    if missing:
        raise AssertionError(f"kernels never launched on path (i): "
                             f"{missing}")
    print(f"path (i) launches (each audited, {len(sites)} sites): "
          f"{launches}")
    print(f"path (i) ms on {_smi()}, unsanitized / sanitized (the audit's "
          f"cost; host clock ending in a synchronize, after a warm call; "
          f"rmat scale {int(math.log2(g18.num_vertices))}, LP and the "
          f"triangle query at {int(math.log2(g16.num_vertices))}):")
    for name in calls:
        print(f"  {name:18s} {ms_off[name]:10.3f} {ms_on[name]:10.3f}"
              + ("" if exact[name] else
                 f"  (two plain runs differ: held to rtol {BC_RTOL})"))

    # a seeded fault of each class, raised before the launch
    front = torch.tensor(srcs, dtype=torch.int32, device=dev)[None]
    base, sizes = O._base_and_sizes(g18, front, front >= 0, "vertex")
    cap = int(sizes.sum(dtype=torch.int64))
    cols = g18.col_indices.clone()
    cols[-1] = g18.num_vertices
    vals = torch.arange(6000, dtype=torch.int32, device=dev).reshape(2, 3000)
    mask = vals % 3 == 0
    lb, epoch = K._lookback_state(dev, 2, 2, 1)
    totals = torch.empty((2,), dtype=torch.int32, device=dev)
    seeded = {
        "out-of-bounds": lambda: K.advance_batch(g18.row_offsets, cols,
                                                 base, sizes, cap),
        "write-write race": lambda: K._launch(
            "compact", "compact", "compact_batch", vals, 3000, mask, 2,
            3000, lb.counters, lb.status, lb.status.numel(), epoch, vals,
            totals, 256, runtime.stream_ptr(dev)),
        "dtype mismatch": lambda: K._launch(
            "compact", "compact", "compact_batch", vals, 3000, mask.float(),
            2, 3000, lb.counters, lb.status, lb.status.numel(), epoch,
            vals.clone(), totals, 256, runtime.stream_ptr(dev)),
    }
    K.reset_launches()
    caught = []
    with sanitize.sanitizing():
        for what, fn in seeded.items():
            try:
                fn()
            except sanitize.MemoryFault as exc:
                if what not in str(exc):
                    raise
                caught.append(str(exc))
            else:
                raise AssertionError(f"path (i): the seeded {what} fault "
                                     f"was not caught")
    if any(kk.launches for kk in K.KERNELS.values()):
        raise AssertionError("path (i): a faulty launch reached the card")
    visited = torch.zeros((1, g18.num_vertices), dtype=torch.bool,
                          device=dev)
    got = K.advance_filter_batch(g18.row_offsets, g18.col_indices, base,
                                 sizes, visited, cap, g18.num_vertices,
                                 g18.cache)
    want = P.advance_filter_batch(g18.row_offsets, g18.col_indices, base,
                                  sizes, visited, cap, g18.num_vertices)
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("path (i): K1 after the seeded faults differs "
                             "from its plain version")
    print("path (i) seeded faults caught before the launch, the card "
          "usable after them (K1 equal to its plain version):")
    for msg in caught:
        print(f"  {msg}")

    # the set-up budgets over a warm serving stream, and a churn
    kinds = ("bfs", "sssp", "pagerank", "reach")
    deg16 = g16.degrees.cpu().numpy()
    pool = [int(v) for v in rng.choice(np.flatnonzero(deg16 > 0), 16,
                                       replace=False)]
    queries = [(kinds[i % 4], pool[i // 4]) for i in range(64)]
    GS.serve_mixed(g16, queries[:8], BATCH, "cuda", hops=HOPS)
    reports = {}
    with sanitize.retrace_guard("bfs") as reports["bfs"], \
            sanitize.retrace_guard("sssp") as reports["sssp"], \
            sanitize.retrace_guard("pagerank") as reports["pagerank"]:
        stats = GS.serve_mixed(g16, queries, BATCH, "cuda", hops=HOPS)
    if stats["status_counts"]["ok"] != len(queries):
        raise AssertionError(f"path (i) warm stream: "
                             f"{stats['status_counts']}")
    try:
        with sanitize.retrace_guard("bfs"):
            for seed in (1, 2):
                gf = G.rmat(int(math.log2(g16.num_vertices)), EDGE_FACTOR,
                            seed=seed, weighted=True, device=dev)
                GS.serve_mixed(gf, [("bfs", 0)], BATCH, "cuda", hops=HOPS)
    except sanitize.RetraceError as exc:
        churn = str(exc)
    else:
        raise AssertionError("path (i): the churning stream did not raise "
                             "RetraceError")
    print(f"path (i) warm serve_mixed stream (rmat scale "
          f"{int(math.log2(g16.num_vertices))}, {len(queries)} queries, "
          f"bfs / sssp / pagerank / reach, batch {BATCH}): traces "
          f"{ {kk: r['traces'] for kk, r in reports.items()} } within the "
          f"budgets { {kk: r['budget'] for kk, r in reports.items()} } "
          f"(reach has no budget: no set-up of its own); a fresh graph a "
          f"query: RetraceError ({churn[:70]}...)")
    print(f"path (i) run and validated in {time.monotonic() - t_path:.1f} s")
    return launches, variants


# path (j): the LM serving path. The seven archs of the dense / moe / vlm
# families, the reference's bounds: decode against direct at the SMOKE
# configs (tests/test_models_smoke.py), a lossy path's relative L2
# (tests/test_perf_flags.py), MoE against a dense computation
# (tests/test_moe.py)
LM_ARCHS = ("kimi-k2-1t-a32b", "qwen3-moe-235b-a22b", "yi-6b", "llama3-405b",
            "starcoder2-15b", "minicpm-2b", "qwen2-vl-2b")
LM_SMOKE_ATOL = 2e-3
LM_LOSSY_REL = 5e-2
MOE_REL = 1e-4
MOE_LAYERS = 2         # Qwen3-MoE at full width, 2 of its 94 layers
MOE_CHECK_TOKENS = 2048


def _rel_l2(torch, a, b) -> float:
    a, b = a.float(), b.float()
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def _decode_syncs(torch, model, params, batch, path="j") -> int:
    """The host syncs of one decode step after a prefill of ``batch``
    (a decode step reads nothing back to the host)."""
    lg, cache = model.prefill(params, batch,
                              cache_len=batch["tokens"].shape[1] + 2)
    tok = torch.argmax(lg[:, -1], -1).to(torch.int32)[:, None]
    syncs = _count_syncs(torch, lambda: model.decode_step(
        params, cache, {"tokens": tok}))[1]
    if syncs:
        raise AssertionError(f"path ({path}) {model.cfg.name}: a decode "
                             f"step made {syncs} host syncs")
    return syncs


def _lm_smoke(torch, np, dev, arch, path):
    """One arch at its SMOKE config (fp32): the serve CLI on the card (4
    requests), then ``generate`` on params drawn once on the CPU, card
    against CPU over 16 greedy tokens at batch 4 (logits within
    LM_SMOKE_ATOL, ids equal), and a decode step's host syncs (0)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import serve as SV
    from repro_torch.models import build_model
    from repro_torch.models.api import tree_map

    def to_dev(tree):
        return tree_map(lambda t: t.to(dev), tree)

    report = SV.main(["--arch", arch, "--smoke", "--requests", "4",
                      "--batch", "2", "--prompt-len", "16",
                      "--gen-len", "8"])
    if report["tokens"] != 32 or report["requests"] != 4:
        raise AssertionError(f"path ({path}) serve {arch}: {report}")
    model = build_model(get_smoke_config(arch))
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    batch = SV.prompt_batch(model.cfg, np.random.default_rng(1), 4, 32,
                            "cpu")
    ids, logits = SV.generate(model, params, batch, 16, cache_len=48)
    ids_c, logits_c = SV.generate(model, to_dev(params), to_dev(batch),
                                  16, cache_len=48)
    err = float((logits_c.cpu() - logits).abs().max())
    if err >= LM_SMOKE_ATOL or not torch.equal(ids_c.cpu(), ids):
        raise AssertionError(f"path ({path}) {arch} SMOKE card vs CPU: max "
                             f"|logit diff| {err:.3e}, ids equal "
                             f"{torch.equal(ids_c.cpu(), ids)}")
    syncs = _decode_syncs(torch, model, to_dev(params), to_dev(batch), path)
    print(f"path ({path}) {arch} SMOKE: serve CLI {report['tokens']} tokens "
          f"({report['tok_per_s']:.1f} tok/s); card vs CPU over 16 "
          f"greedy tokens at batch 4: max |logit diff| {err:.2e} "
          f"(< {LM_SMOKE_ATOL:g}), ids equal; a decode step made "
          f"{syncs} host syncs")


def _prefill_bound(cfg, b: int, s: int, smax: int, nbytes: int) -> tuple:
    """(bound ms, bf16 ms, fp32 ms) of a dense prefill of B × S tokens
    into a cache of Smax rows: the larger of ``nbytes`` over HBM and the
    operations over their peak rates — the layers' bf16 matmuls at B·S
    tokens and the unembed at the B last positions, plus the attention
    einsums (q·kᵀ and p·v over all Smax cache rows, fp32 without TF32).
    The two kinds are added: each layer's attention waits on its
    projections and they on it. The embedding lookup is a gather."""
    d, hd = cfg.d_model, cfg.hd
    per_layer = (2 * cfg.n_heads + 2 * cfg.n_kv_heads) * d * hd \
        + 3 * d * cfg.d_ff
    vp = -(-cfg.vocab // 256) * 256
    bf16_ms = (2 * cfg.n_layers * per_layer * b * s + 2 * d * vp * b) \
        / BF16_OPS_PER_S * 1e3
    fp32_ms = 4 * b * cfg.n_heads * s * smax * hd * cfg.n_layers \
        / FP32_OPS_PER_S * 1e3
    return (max(nbytes / HBM_BYTES_PER_S * 1e3, bf16_ms + fp32_ms),
            bf16_ms, fp32_ms)


def _tenth_slice_path(torch, np, K, dev):
    """Path (j): the LM serving path on the card, plain PyTorch (the
    reference's LM path reaches no Pallas kernel: ``_sdpa`` is plain
    jnp, ``moe_ffn``'s ``use_kernel`` is read nowhere). ``launch.serve``
    at the SMOKE configs of the seven dense / moe / vlm archs, its CLI
    on the card and ``generate`` on params drawn once on the CPU (fp32)
    against the same run on the CPU: logits within LM_SMOKE_ATOL, greedy
    ids equal, a decode step with no host sync (the sync debug mode).
    MiniCPM-2B whole (bf16): 8 requests at batch 4, prompt
    512, gen 32 (tok/s), prefill ms and decode ms a step beside their
    bounds, peak memory, decode against direct and the int8 KV cache
    against the plain one (relative L2 < LM_LOSSY_REL). Qwen3-MoE at
    full width cut to MOE_LAYERS layers: 4 requests at batch 4, prompt
    512, gen 16, its drop fraction at the default capacity, and one
    fp32 ``moe_ffn`` layer over MOE_CHECK_TOKENS tokens drop-free
    against a per-expert dense computation (MOE_REL of max|y|), its
    experts equal to a host top-k, two runs bit-equal. Qwen2-VL-2B whole
    (bf16): prefill from input embeddings with 3-D positions, decode,
    and positions × 3 changing the logits. No kernel launches. Returns
    16 of MiniCPM-2B's decode steps, for the profile."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as SV
    from repro_torch.models import build_model
    from repro_torch.models import moe as M
    from repro_torch.models.api import count_params
    from repro_torch.models.transformer import forward

    t_path = time.monotonic()
    K.reset_launches()

    # ---- the SMOKE configs: the CLI on the card, the card against the CPU
    for arch in LM_ARCHS:
        _lm_smoke(torch, np, dev, arch, "j")

    # ---- MiniCPM-2B, whole, bf16
    cfg = get_config("minicpm-2b")
    model = build_model(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2**30      # earlier paths' graphs
    t0 = time.monotonic()
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    torch.cuda.synchronize()
    n = count_params(params)
    pbytes = _nbytes(params)
    print(f"path (j) minicpm-2b: {n:,} params ({pbytes / 1e9:.2f} GB bf16) "
          f"drawn on the card in {time.monotonic() - t0:.2f} s")
    b, s, gen = 4, 512, 32
    smax = s + gen
    warm = SV.prompt_batch(cfg, np.random.default_rng(9), b, s, dev)
    SV.generate(model, params, warm, 2, cache_len=smax)       # warm-up
    report = SV.serve(model, params, requests=8, batch=b, prompt_len=s,
                      gen_len=gen, seed=0, device=dev)
    batch = SV.prompt_batch(cfg, np.random.default_rng(2), b, s, dev)
    prefill_ms = _timed(torch, lambda: model.prefill(params, batch,
                                                     cache_len=smax), 3)
    lg, cache = model.prefill(params, batch, cache_len=smax)
    tok = torch.argmax(lg[:, -1], -1).to(torch.int32)[:, None]
    decode_ms = _timed(torch, lambda: model.decode_step(params, cache,
                                                        {"tokens": tok}), 10)
    peak = torch.cuda.max_memory_allocated() / 2**30
    kv_bytes = _nbytes({k: cache[k] for k in ("k", "v")})
    dec_bound = (pbytes + kv_bytes) / HBM_BYTES_PER_S * 1e3
    pre_bound, pre_bf16_ms, pre_fp32_ms = _prefill_bound(cfg, b, s, smax,
                                                         pbytes + kv_bytes)
    dec_syncs = _count_syncs(torch, lambda: model.decode_step(
        params, cache, {"tokens": tok}))[1]
    if dec_syncs:
        raise AssertionError(f"path (j) minicpm-2b: a decode step made "
                             f"{dec_syncs} host syncs")
    # decode against direct: prefill S, decode one token, vs prefill S + 1
    nxt = torch.randint(0, cfg.vocab, (b, 1), dtype=torch.int32, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(3))
    lg_dec, _ = model.decode_step(params, cache, {"tokens": nxt})
    lg_dir, _ = model.prefill(params, {"tokens": torch.cat(
        [batch["tokens"], nxt], 1)})
    rel_dd = _rel_l2(torch, lg_dec, lg_dir)
    # the int8 KV cache against the plain one, the same decode step
    model_q = build_model(cfg.replace(kv_quant=True))
    _, cache_q = model_q.prefill(params, batch, cache_len=smax)
    lg_q, _ = model_q.decode_step(params, cache_q, {"tokens": nxt})
    rel_q = _rel_l2(torch, lg_q, lg_dec)
    del cache_q, lg_q, lg_dir
    for what, rel in (("decode vs direct", rel_dd), ("kv_quant", rel_q)):
        if not rel < LM_LOSSY_REL:
            raise AssertionError(f"path (j) minicpm-2b {what}: relative L2 "
                                 f"{rel:.3e} >= {LM_LOSSY_REL}")
    print(f"path (j) minicpm-2b serve: {report['requests']} requests at "
          f"batch {b}, prompt {s}, gen {gen}: {report['tokens']} tokens in "
          f"{report['seconds']:.2f} s ({report['tok_per_s']:.1f} tok/s); "
          f"prefill (B={b}, S={s}) {prefill_ms:.2f} ms (bound "
          f"{pre_bound:.2f} ms: the layers' bf16 matmuls at B·S tokens and "
          f"the unembed at B over 989 TFLOP/s, {pre_bf16_ms:.2f} ms, plus "
          f"the fp32 attention einsums, 4·B·H·S·Smax·hd a layer, over 67 "
          f"TFLOP/s, {pre_fp32_ms:.2f} ms); decode "
          f"{decode_ms:.2f} ms a step, 0 host syncs (bound "
          f"{dec_bound:.3f} ms: "
          f"{pbytes / 1e9:.2f} GB weights + {kv_bytes / 1e9:.3f} GB KV at "
          f"Smax {smax} over 3.35 TB/s); peak {peak:.2f} GiB, of which "
          f"{held:.2f} held by earlier paths; decode vs "
          f"direct rel L2 {rel_dd:.2e}, kv_quant vs plain {rel_q:.2e} "
          f"(< {LM_LOSSY_REL:g})")

    def minicpm_decode():
        c, t = cache, tok
        for _ in range(16):
            lgd, c = model.decode_step(params, c, {"tokens": t})
            t = torch.argmax(lgd[:, -1], -1).to(torch.int32)[:, None]
        return t

    # ---- Qwen3-MoE, full width, MOE_LAYERS layers, bf16
    full = build_model(get_config("qwen3-moe-235b-a22b"))
    n_full = full.param_count(full.init(device="meta"))
    cfg_m = full.cfg.replace(n_layers=MOE_LAYERS)
    model_m = build_model(cfg_m)
    t0 = time.monotonic()
    params_m = model_m.init(torch.Generator(device=dev).manual_seed(1),
                            device=dev)
    torch.cuda.synchronize()
    nm = count_params(params_m)
    print(f"path (j) qwen3-moe-235b-a22b cut to {MOE_LAYERS} of "
          f"{full.cfg.n_layers} layers at full width (d {cfg_m.d_model}, "
          f"{cfg_m.n_heads}/{cfg_m.n_kv_heads} heads of {cfg_m.hd}, "
          f"{cfg_m.n_experts} experts top-{cfg_m.top_k} of width "
          f"{cfg_m.d_expert}): {nm:,} params drawn in "
          f"{time.monotonic() - t0:.2f} s (the whole model, {n_full:,} "
          f"params, does not fit one card)")
    warm = SV.prompt_batch(cfg_m, np.random.default_rng(9), 4, 512, dev)
    SV.generate(model_m, params_m, warm, 2, cache_len=528)
    report_m = SV.serve(model_m, params_m, requests=4, batch=4,
                        prompt_len=512, gen_len=16, seed=0, device=dev)
    _, aux = forward(cfg_m, params_m, warm["tokens"])
    drop = float(aux["moe_drop_frac"])
    print(f"path (j) qwen3-moe ({MOE_LAYERS} layers) serve: 4 requests at "
          f"batch 4, prompt 512, gen 16: {report_m['tokens']} tokens in "
          f"{report_m['seconds']:.2f} s ({report_m['tok_per_s']:.1f} "
          f"tok/s); moe_drop_frac at capacity factor "
          f"{cfg_m.capacity_factor} over 2048 tokens {drop:.4f}")
    del params_m, model_m, warm
    torch.cuda.empty_cache()

    # one fp32 moe_ffn layer at full width, drop-free, against a dense
    # per-expert computation
    cfg32 = cfg_m.replace(capacity_factor=8.0)
    g32 = torch.Generator(device=dev).manual_seed(2)
    p32 = M.moe_init(g32, cfg32, torch.float32, device=dev)
    x = torch.randn((1, MOE_CHECK_TOKENS, cfg32.d_model), device=dev,
                    generator=g32)
    y1, aux1 = M.moe_ffn(p32, x, cfg32)
    y2, _ = M.moe_ffn(p32, x, cfg32)
    if not torch.equal(y1, y2):
        raise AssertionError("path (j) moe_ffn: two runs differ")
    if float(aux1["moe_drop_frac"]) != 0.0:
        raise AssertionError(f"path (j) moe_ffn at capacity factor 8: drop "
                             f"{float(aux1['moe_drop_frac'])}")
    t = MOE_CHECK_TOKENS
    x2 = x.reshape(t, -1)
    cap = M._capacity(t, cfg32)
    probs, flat_e, _, _, _, _ = M.route(p32, x2[None], cfg32, cap)
    host = probs[0].cpu().numpy()
    want_e = np.argsort(-host, axis=-1, kind="stable")[:, :cfg32.top_k]
    if not np.array_equal(flat_e.reshape(t, -1).cpu().numpy(), want_e):
        raise AssertionError("path (j) moe_ffn: experts differ from a host "
                             "top-k of the same probs")
    gate = torch.gather(probs[0], -1, torch.from_numpy(want_e).to(dev))
    gate = gate / gate.sum(-1, keepdim=True)
    eid = torch.from_numpy(want_e).to(dev)
    yref = torch.zeros_like(x2)
    for e in range(cfg32.n_experts):
        tok_i, j = torch.nonzero(eid == e, as_tuple=True)
        xe = x2[tok_i]
        h = torch.nn.functional.silu(xe @ p32["w1"][e]) * (xe @ p32["w3"][e])
        yref.index_add_(0, tok_i, (h @ p32["w2"][e]) * gate[tok_i, j, None])
    rel_m = float((y1.reshape(t, -1) - yref).abs().max() / yref.abs().max())
    if not rel_m < MOE_REL:
        raise AssertionError(f"path (j) moe_ffn vs dense: {rel_m:.3e} of "
                             f"max|y|")
    print(f"path (j) moe_ffn fp32 at full width ({t} tokens, capacity "
          f"factor 8, cap {cap}): max|y - dense| {rel_m:.2e} of max|y| "
          f"(< {MOE_REL:g}), experts = host top-k, two runs bit-equal")
    del p32, x, y1, y2, yref
    torch.cuda.empty_cache()

    # ---- Qwen2-VL-2B, whole, bf16: input embeddings, 3-D positions
    cfg_v = get_config("qwen2-vl-2b")
    model_v = build_model(cfg_v)
    params_v = model_v.init(torch.Generator(device=dev).manual_seed(4),
                            device=dev)
    bv, sv, side = 4, 256, 16
    gv = torch.Generator(device=dev).manual_seed(5)
    emb = (torch.randn((bv, sv, cfg_v.d_model), device=dev, generator=gv)
           * 0.02).to(torch.bfloat16)
    ar = torch.arange(sv, dtype=torch.int32, device=dev)
    pos = torch.stack([ar, ar // side, ar % side])[:, None].expand(
        3, bv, sv).contiguous()                     # frame, row, column
    lg_v, cache_v = model_v.prefill(
        params_v, {"input_embeds": emb, "positions": pos},
        cache_len=sv + 8)
    ids_v, lgs_v = [], []
    tok_v = torch.argmax(lg_v[:, -1], -1).to(torch.int32)[:, None]
    syncs_v = _count_syncs(torch, lambda: model_v.decode_step(
        params_v, cache_v, {"tokens": tok_v}))[1]
    if syncs_v:
        raise AssertionError(f"path (j) qwen2-vl-2b: a decode step made "
                             f"{syncs_v} host syncs")
    for _ in range(8):
        lgd, cache_v = model_v.decode_step(params_v, cache_v,
                                           {"tokens": tok_v})
        tok_v = torch.argmax(lgd[:, -1], -1).to(torch.int32)[:, None]
        lgs_v.append(lgd)
    lg_v3, _ = model_v.prefill(params_v, {"input_embeds": emb,
                                          "positions": pos * 3})
    moved = float((lg_v3.float() - lg_v.float()).abs().max())
    finite = all(bool(torch.isfinite(t).all()) for t in [lg_v, *lgs_v])
    vp = -(-cfg_v.vocab // 256) * 256
    if not finite or lg_v.shape != (bv, 1, vp) or not moved > 0:
        raise AssertionError(f"path (j) qwen2-vl-2b: finite {finite}, "
                             f"shape {tuple(lg_v.shape)}, positions x 3 "
                             f"moved the logits by {moved}")
    print(f"path (j) qwen2-vl-2b: {count_params(params_v):,} params; "
          f"prefill from input embeddings (B={bv}, S={sv}) with 3-D "
          f"positions (frame, row, column of a {side}-wide grid), 8 decode "
          f"steps (0 host syncs a step): finite logits (B, 1, {vp}); "
          f"positions x 3 moved them by up to {moved:.3f}")
    del params_v, cache_v, model_v
    torch.cuda.empty_cache()

    launched = {k: c for k, c in _launch_counts(K).items() if c}
    if launched:
        raise AssertionError(f"path (j) launched kernels: {launched}")
    print("path (j) launches: 0 for every kernel — the reference's LM path "
          "reaches no Pallas kernel (_sdpa is plain jnp, moe_ffn's "
          "use_kernel is read nowhere), so K7 and K8 have no caller here")
    print(f"path (j) run and validated in {time.monotonic() - t_path:.1f} s")
    return minicpm_decode


# path (k): the ssm, hybrid and encdec families (Mamba2-780m, Zamba2-2.7B,
# Whisper-large-v3), plain PyTorch as the reference's LM path is plain jnp
LM_SSM_ARCHS = ("mamba2-780m", "zamba2-2.7b", "whisper-large-v3")
SSD_CHECK_TOKENS = 256
# the chunked SSD's final state against its token-by-token recurrence:
# the reference's tolerance for the two forms (tests/test_mamba2.py, 1e-4
# on O(1) values), as a relative L2
SSD_STATE_REL = 1e-4
WHISPER_FRAMES = 1500  # max_source_len: 30 s of audio


def _ssd_flops(cfg, b: int, s: int) -> tuple:
    """(bf16, fp32) operations of one layer's chunked SSD over B × S
    tokens: the C·Bᵀ scores in the compute dtype; the intra-chunk
    product, the chunk states and the inter-chunk output in fp32 (each
    2·B·nc·Q·H·P·(Q or N)). Elementwise work is left out."""
    d_inner = cfg.ssm_expand * cfg.d_model
    h, p, n = d_inner // cfg.ssm_head_dim, cfg.ssm_head_dim, cfg.ssm_state
    q = min(cfg.ssm_chunk, s)
    nc = -(-s // q)
    return (2 * b * nc * q * q * n,
            2 * b * nc * q * h * p * (q + 2 * n))


def _ssm_prefill_bound(cfg, b: int, s: int, smax: int, nbytes: int) -> tuple:
    """(bound ms, bf16 ms, fp32 ms) of an ssm or hybrid prefill of B × S
    tokens, as ``_prefill_bound`` counts a dense one: every Mamba2
    layer's in_proj and out_proj at B·S tokens and the unembed at the B
    last positions in bf16 over 989 TFLOP/s, plus the SSD's fp32 einsums
    (``_ssd_flops``) over 67 TFLOP/s; for the hybrid each of the G
    applications of the shared block adds its projections and SwiGLU in
    bf16 and its attention einsums (4·B·H·S·Smax·hd) in fp32."""
    d = cfg.d_model
    d_inner = cfg.ssm_expand * d
    nh = d_inner // cfg.ssm_head_dim
    in_dim = 2 * d_inner + 2 * cfg.ssm_state + nh
    vp = -(-cfg.vocab // 256) * 256
    ssd16, ssd32 = _ssd_flops(cfg, b, s)
    bf16 = cfg.n_layers * (2 * b * s * (d * in_dim + d_inner * d) + ssd16) \
        + 2 * d * vp * b
    fp32 = cfg.n_layers * ssd32
    if cfg.family == "hybrid":
        g = cfg.n_layers // cfg.attn_every
        shared = (2 * cfg.n_heads + 2 * cfg.n_kv_heads) * d * cfg.hd \
            + 3 * d * cfg.d_ff
        bf16 += g * 2 * b * s * shared
        fp32 += g * 4 * b * cfg.n_heads * s * smax * cfg.hd
    bf16_ms = bf16 / BF16_OPS_PER_S * 1e3
    fp32_ms = fp32 / FP32_OPS_PER_S * 1e3
    return (max(nbytes / HBM_BYTES_PER_S * 1e3, bf16_ms + fp32_ms),
            bf16_ms, fp32_ms)


def _encoder_bound(cfg, b: int, s: int, nbytes: int) -> tuple:
    """(bound ms, bf16 ms, fp32 ms) of Whisper's encoder over B × S
    frames: each layer's q/k/v/o projections and GELU MLP in bf16 over
    989 TFLOP/s, its bidirectional attention einsums (4·B·H·S²·hd) in
    fp32 over 67 TFLOP/s, against ``nbytes`` over HBM."""
    d = cfg.d_model
    per_layer = 4 * cfg.n_heads * cfg.hd * d + 2 * d * cfg.d_ff
    n = cfg.n_enc_layers or cfg.n_layers
    bf16_ms = 2 * n * per_layer * b * s / BF16_OPS_PER_S * 1e3
    fp32_ms = 4 * b * cfg.n_heads * s * s * cfg.hd * n \
        / FP32_OPS_PER_S * 1e3
    return (max(nbytes / HBM_BYTES_PER_S * 1e3, bf16_ms + fp32_ms),
            bf16_ms, fp32_ms)


def _nbytes(tree) -> int:
    from repro_torch.models.api import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _draw(torch, model, seed, dev, label):
    """A full config's params drawn on the card (bf16), with the peak
    memory counter reset; prints the count, the time and the memory that
    earlier paths hold."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2**30
    t0 = time.monotonic()
    params = model.init(torch.Generator(device=dev).manual_seed(seed),
                        device=dev)
    torch.cuda.synchronize()
    n = model.param_count(params)
    print(f"path (k) {label}: {n:,} params ({_nbytes(params) / 1e9:.2f} GB "
          f"bf16) drawn on the card in {time.monotonic() - t0:.2f} s; "
          f"{held:.2f} GiB held by earlier paths")
    return params


def _lm_timings(torch, model, params, batch, smax, label):
    """(prefill ms, decode ms a step, the prefill's cache, the decode
    step's token) of ``batch``, the decode step checked for host syncs
    (0) and against a direct prefill of the prompt plus its token
    (relative L2 < LM_LOSSY_REL). Returns the relative L2 too."""
    prefill_ms = _timed(torch, lambda: model.prefill(params, batch,
                                                     cache_len=smax), 3)
    lg, cache = model.prefill(params, batch, cache_len=smax)
    tok = torch.argmax(lg[:, -1], -1).to(torch.int32)[:, None]
    decode_ms = _timed(torch, lambda: model.decode_step(params, cache,
                                                        {"tokens": tok}), 10)
    syncs = _count_syncs(torch, lambda: model.decode_step(
        params, cache, {"tokens": tok}))[1]
    if syncs:
        raise AssertionError(f"path (k) {label}: a decode step made {syncs} "
                             f"host syncs")
    nxt = torch.randint(0, model.cfg.vocab, tok.shape, dtype=torch.int32,
                        device=tok.device,
                        generator=torch.Generator(device=tok.device)
                        .manual_seed(3))
    lg_dec, _ = model.decode_step(params, cache, {"tokens": nxt})
    lg_dir, _ = model.prefill(params, {**batch, "tokens": torch.cat(
        [batch["tokens"], nxt], 1)})
    rel = _rel_l2(torch, lg_dec, lg_dir)
    if not rel < LM_LOSSY_REL:
        raise AssertionError(f"path (k) {label} decode vs direct: relative "
                             f"L2 {rel:.3e} >= {LM_LOSSY_REL}")
    return prefill_ms, decode_ms, cache, tok, rel


def _eleventh_slice_path(torch, np, K, dev):
    """Path (k): the ssm, hybrid and encdec families on the card, plain
    PyTorch (the reference's Mamba2 has no kernel of its own: its SSD is
    einsums and a scan). The three archs at SMOKE as path (j) runs its
    seven (``_lm_smoke``). Mamba2-780m whole (bf16, 48 layers): 8
    requests at batch 4, prompt 512, gen 32 (tok/s), prefill and decode
    ms beside their bounds, peak memory, decode against direct, and at
    its full width the chunked SSD's final state against a token-by-token
    ``ssd_decode`` over SSD_CHECK_TOKENS tokens (relative L2 <
    SSD_STATE_REL). Zamba2-2.7B whole (54 Mamba2 layers, the shared
    block applied 9 times): 4 requests at batch 4, prompt 512, gen 16,
    prefill and decode ms beside bounds, decode against direct.
    Whisper-large-v3 whole (32 + 32 layers): a prefill of batch 4 over
    WHISPER_FRAMES frames and a 4-token decoder prompt, 32 greedy decode
    steps, the encoder's ms and a decode step's beside their bounds,
    decode against direct. Each decode step makes 0 host syncs; no kernel
    launches. Each model is freed before the next. Returns 16 of
    Mamba2-780m's decode steps, for the profile."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as SV
    from repro_torch.models import build_model
    from repro_torch.models import encdec as E
    from repro_torch.models import mamba2 as M2

    t_path = time.monotonic()
    K.reset_launches()
    for arch in LM_SSM_ARCHS:
        _lm_smoke(torch, np, dev, arch, "k")

    # ---- Mamba2-780m, whole, bf16
    cfg = get_config("mamba2-780m")
    model = build_model(cfg)
    params = _draw(torch, model, 0, dev, "mamba2-780m")
    pbytes = _nbytes(params)
    b, s, gen = 4, 512, 32
    smax = s + gen
    warm = SV.prompt_batch(cfg, np.random.default_rng(9), b, s, dev)
    SV.generate(model, params, warm, 2, cache_len=smax)       # warm-up
    report = SV.serve(model, params, requests=8, batch=b, prompt_len=s,
                      gen_len=gen, seed=0, device=dev)
    batch = SV.prompt_batch(cfg, np.random.default_rng(2), b, s, dev)
    prefill_ms, decode_ms, cache, tok, rel = _lm_timings(
        torch, model, params, batch, smax, "mamba2-780m")
    peak = torch.cuda.max_memory_allocated() / 2**30
    state = _nbytes({k: cache[k] for k in ("ssm", "conv")})
    dec_bound = (pbytes + 2 * state) / HBM_BYTES_PER_S * 1e3
    pre_bound, pre16, pre32 = _ssm_prefill_bound(cfg, b, s, smax,
                                                 pbytes + state)
    print(f"path (k) mamba2-780m serve: {report['requests']} requests at "
          f"batch {b}, prompt {s}, gen {gen}: {report['tokens']} tokens in "
          f"{report['seconds']:.2f} s ({report['tok_per_s']:.1f} tok/s); "
          f"prefill (B={b}, S={s}) {prefill_ms:.2f} ms (bound "
          f"{pre_bound:.2f} ms: in_proj / out_proj at B·S tokens, the C·Bᵀ "
          f"scores and the unembed in bf16 over 989 TFLOP/s, "
          f"{pre16:.2f} ms, plus the SSD's fp32 einsums over 67 TFLOP/s, "
          f"{pre32:.2f} ms); decode {decode_ms:.2f} ms a step, 0 host syncs "
          f"(bound {dec_bound:.3f} ms: {pbytes / 1e9:.2f} GB weights + the "
          f"{state / 1e9:.3f} GB SSM and conv state read and written, over "
          f"3.35 TB/s); peak {peak:.2f} GiB; decode vs direct rel L2 "
          f"{rel:.2e} (< {LM_LOSSY_REL:g})")
    # the chunked form against the recurrence at full width: the first
    # layer's head count and state size, bf16 streams, f32 dt and state
    d_inner, nh, ds, _ = M2._dims(cfg)
    g = torch.Generator(device=dev).manual_seed(5)
    t = SSD_CHECK_TOKENS
    x = torch.randn((b, t, nh, cfg.ssm_head_dim), generator=g,
                    device=dev).to(torch.bfloat16)
    bm, cm = (torch.randn((b, t, ds), generator=g, device=dev)
              .to(torch.bfloat16) for _ in range(2))
    dt = torch.nn.functional.softplus(
        torch.randn((b, t, nh), generator=g, device=dev)
        + params["layers"]["dt_bias"][0])
    a = -torch.exp(params["layers"]["A_log"][0])
    _, h_chunk = M2.ssd_chunked(x, dt, a, bm, cm, cfg.ssm_chunk)
    h_rec = torch.zeros_like(h_chunk)
    for i in range(t):
        _, h_rec = M2.ssd_decode(x[:, i:i + 1], dt[:, i:i + 1], a,
                                 bm[:, i:i + 1], cm[:, i:i + 1], h_rec)
    rel_ssd = _rel_l2(torch, h_chunk, h_rec)
    if not rel_ssd < SSD_STATE_REL:
        raise AssertionError(f"path (k) ssd_chunked vs the recurrence: "
                             f"relative L2 {rel_ssd:.3e}")
    print(f"path (k) mamba2-780m SSD at full width (B={b}, {nh} heads of "
          f"{cfg.ssm_head_dim}, state {ds}, chunk {cfg.ssm_chunk}): the "
          f"chunked final state over {t} tokens vs {t} ssd_decode steps, "
          f"rel L2 {rel_ssd:.2e} (< {SSD_STATE_REL:g})")
    del x, bm, cm, dt, h_chunk, h_rec, warm

    def mamba2_decode():
        c, tk = cache, tok
        for _ in range(16):
            lgd, c = model.decode_step(params, c, {"tokens": tk})
            tk = torch.argmax(lgd[:, -1], -1).to(torch.int32)[:, None]
        return tk

    # ---- Zamba2-2.7B, whole, bf16
    cfg_z = get_config("zamba2-2.7b")
    model_z = build_model(cfg_z)
    params_z = _draw(torch, model_z, 1, dev, "zamba2-2.7b")
    pbytes_z = _nbytes(params_z)
    gen_z = 16
    smax_z = s + gen_z
    warm = SV.prompt_batch(cfg_z, np.random.default_rng(9), b, s, dev)
    SV.generate(model_z, params_z, warm, 2, cache_len=smax_z)
    report_z = SV.serve(model_z, params_z, requests=4, batch=b,
                        prompt_len=s, gen_len=gen_z, seed=0, device=dev)
    batch = SV.prompt_batch(cfg_z, np.random.default_rng(2), b, s, dev)
    prefill_z, decode_z, cache_z, _, rel_z = _lm_timings(
        torch, model_z, params_z, batch, smax_z, "zamba2-2.7b")
    peak_z = torch.cuda.max_memory_allocated() / 2**30
    state_z = _nbytes({k: cache_z[k] for k in ("ssm", "conv")})
    kv_z = _nbytes({k: cache_z[k] for k in ("kv_k", "kv_v")})
    dec_bound_z = (pbytes_z + 2 * state_z + kv_z) / HBM_BYTES_PER_S * 1e3
    pre_bound_z, pre16_z, pre32_z = _ssm_prefill_bound(
        cfg_z, b, s, smax_z, pbytes_z + state_z + kv_z)
    print(f"path (k) zamba2-2.7b serve: {report_z['requests']} requests at "
          f"batch {b}, prompt {s}, gen {gen_z}: {report_z['tokens']} tokens "
          f"in {report_z['seconds']:.2f} s ({report_z['tok_per_s']:.1f} "
          f"tok/s); prefill {prefill_z:.2f} ms (bound {pre_bound_z:.2f} ms: "
          f"bf16 {pre16_z:.2f} ms, the SSD's and the shared attention's "
          f"fp32 einsums {pre32_z:.2f} ms); decode {decode_z:.2f} ms a step, "
          f"0 host syncs (bound {dec_bound_z:.3f} ms: {pbytes_z / 1e9:.2f} "
          f"GB weights, {state_z / 1e9:.3f} GB state read and written, "
          f"{kv_z / 1e9:.3f} GB KV at Smax {smax_z} read); peak "
          f"{peak_z:.2f} GiB; decode vs direct rel L2 {rel_z:.2e} "
          f"(< {LM_LOSSY_REL:g})")
    del params_z, model_z, cache_z, warm, batch
    torch.cuda.empty_cache()

    # ---- Whisper-large-v3, whole, bf16: 30 s of audio
    cfg_w = get_config("whisper-large-v3")
    model_w = build_model(cfg_w)
    params_w = _draw(torch, model_w, 2, dev, "whisper-large-v3")
    gw = torch.Generator(device=dev).manual_seed(6)
    frames = (torch.randn((b, WHISPER_FRAMES, cfg_w.d_model), generator=gw,
                          device=dev) * 0.02).to(torch.bfloat16)
    prompt_w = torch.randint(0, cfg_w.vocab, (b, 4), dtype=torch.int32,
                             generator=gw, device=dev)
    batch_w = {"frames": frames, "tokens": prompt_w}
    steps = 32
    smax_w = 4 + steps + 1
    t0 = time.monotonic()
    ids_w, lgs_w = SV.generate(model_w, params_w, batch_w, steps + 1,
                               cache_len=smax_w)
    torch.cuda.synchronize()
    gen_s = time.monotonic() - t0
    enc_ms = _timed(torch, lambda: E.encode(cfg_w, params_w, frames), 3)
    _, decode_w, cache_w, _, rel_w = _lm_timings(
        torch, model_w, params_w, batch_w, smax_w, "whisper-large-v3")
    peak_w = torch.cuda.max_memory_allocated() / 2**30
    enc_bytes = _nbytes({k: params_w[k] for k in ("enc_layers",
                                                   "enc_final_norm")})
    dec_bytes = _nbytes({k: params_w[k] for k in ("dec_embed", "dec_layers",
                                                   "dec_final_norm")})
    kv_w = _nbytes({k: cache_w[k] for k in ("k", "v", "cross_k",
                                            "cross_v")})
    enc_bound, enc16, enc32 = _encoder_bound(
        cfg_w, b, WHISPER_FRAMES, enc_bytes + _nbytes(frames))
    dec_bound_w = (dec_bytes + kv_w) / HBM_BYTES_PER_S * 1e3
    vp = -(-cfg_w.vocab // 256) * 256
    finite = bool(torch.isfinite(lgs_w.float()).all())
    if not finite or tuple(lgs_w.shape) != (b, steps + 1, vp):
        raise AssertionError(f"path (k) whisper-large-v3: finite {finite}, "
                             f"logits {tuple(lgs_w.shape)}")
    print(f"path (k) whisper-large-v3: prefill of B={b} x {WHISPER_FRAMES} "
          f"frames and a 4-token prompt, then {steps} greedy steps, in "
          f"{gen_s:.2f} s ({b * (steps + 1) / gen_s:.1f} tok/s); encoder "
          f"{enc_ms:.2f} ms (bound {enc_bound:.2f} ms: projections and MLP "
          f"in bf16 {enc16:.2f} ms, attention einsums in fp32 {enc32:.2f} "
          f"ms); decode {decode_w:.2f} ms a step, 0 host syncs (bound "
          f"{dec_bound_w:.3f} ms: {dec_bytes / 1e9:.2f} GB decoder weights "
          f"and table + {kv_w / 1e9:.3f} GB self and cross KV read); peak "
          f"{peak_w:.2f} GiB; decode vs direct rel L2 {rel_w:.2e} "
          f"(< {LM_LOSSY_REL:g})")
    del params_w, model_w, cache_w, frames, batch_w, lgs_w
    torch.cuda.empty_cache()

    launched = {k: c for k, c in _launch_counts(K).items() if c}
    if launched:
        raise AssertionError(f"path (k) launched kernels: {launched}")
    print("path (k) launches: 0 for every kernel — the reference's Mamba2, "
          "hybrid and encdec models reach no Pallas kernel (the SSD is "
          "einsums and a lax.scan, _sdpa plain jnp)")
    print(f"path (k) run and validated in {time.monotonic() - t_path:.1f} s")
    return mamba2_decode


# path (l): LM training, plain PyTorch as the reference's training path is
# plain jnp (no Pallas kernel has a backward in the reference)
TRAIN_TOL = 2e-3       # card vs CPU: path (j)'s bound on the loss, × the
                       # global norm on each gradient leaf, rel L2 on params
TRAIN_B, TRAIN_S = 4, 512
TRAIN_STEPS = 8        # MiniCPM-2B, fp32 moments, remat "none"
REMAT_STEPS = 2        # ... under "dots" and under "full"
QUANT_STEPS = 4        # ... with int8 moments, at lr 1e-3 and QUANT_LR
QUANT_LR = 1e-5        # a peak lr where the int8 moments' loss falls
QUANT_DROP = 0.5       # ... by at least this share of fp32 moments' drop
REMAT_PEAK_LAYERS = 8  # MiniCPM-2B's width: the backward's peak per remat
REMAT_LOSS_RTOL = 1e-3
CKPT_LAYERS = 2        # the checkpoint's MiniCPM-2B cut, at full width
PIPE_ATOL = 1e-6       # the reference's pipeline test


def _train_smoke(torch, arch, dev):
    """One arch at its SMOKE config (fp32): ``value_and_grad`` and one
    ``make_train_step`` step from params drawn once on the CPU, on the
    CPU and on ``dev``. Returns (|loss diff|, the worst gradient leaf's
    max |diff| over the global norm, the params' relative L2 after the
    step)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import make_batch_for
    from repro_torch.models import build_model
    from repro_torch.models.api import tree_map
    from repro_torch.pytree import leaves
    from repro_torch.train import adamw, make_schedule, make_train_step
    from repro_torch.train.trainstep import value_and_grad

    model = build_model(get_smoke_config(arch))
    host = model.init(torch.Generator().manual_seed(0), device="cpu")
    batch = make_batch_for(model.cfg, {"global_batch": 2, "seq_len": 32},
                           "train", seed=3, device="cpu")
    out = []
    for where in ("cpu", dev):
        params = tree_map(lambda t: t.to(where, copy=True), host)
        b = {k: v.to(where) for k, v in batch.items()}
        _, _, grads = value_and_grad(model, params, b)
        opt_init, opt_update = adamw(make_schedule("cosine", 1e-3, 10,
                                                   warmup_steps=2))
        params, _, metrics = make_train_step(model, opt_update)(
            params, opt_init(params), b)
        out.append((float(metrics["loss"]),
                    [g.double().cpu() for g in leaves(grads)],
                    torch.cat([p.double().cpu().ravel()
                               for p in leaves(params)])))
    (loss, grads, params), (loss_c, grads_c, params_c) = out
    norm = float(torch.sqrt(sum(torch.sum(g * g) for g in grads)))
    grad_err = max(float((a - b).abs().max()) for a, b in zip(grads_c, grads))
    rel = float(torch.linalg.norm(params_c - params)
                / torch.linalg.norm(params))
    return abs(loss_c - loss), grad_err / norm, rel


def _cref15_codes(torch, opt) -> tuple:
    """(entries of the int8 moments whose v code is 0 while their m code
    is not, entries of the int8 moments): an update reads such an
    entry's v as 0 and moves its param by lr·m̂ / eps (C-ref-15)."""
    from repro_torch.pytree import leaves
    from repro_torch.train.optimizer import QTensor

    def is_q(x):
        return isinstance(x, QTensor)

    pairs = [(m.codes, v.codes) for m, v in zip(leaves(opt.m, is_q),
                                                leaves(opt.v, is_q))
             if is_q(v)]
    hit = sum(int(((v == 0) & (m != 0)).sum(dtype=torch.int64))
              for m, v in pairs)
    return hit, sum(v.numel() for _, v in pairs)


def _moved(torch, params, old, lr) -> int:
    """Params that moved from ``old`` (their leaves, on the host) by more
    than 10 lr plus one bf16 quantum of their old value in a step
    (AdamW's own move is lr·|m̂| / (√v̂ + eps) plus the decay, under 2
    lr)."""
    from repro_torch.pytree import leaves
    n = 0
    for p, o in zip(leaves(params), old):
        o = o.to(p.device).float()
        n += int(((p.float() - o).abs() > 10 * lr + o.abs() * 2.0 ** -7)
                 .sum(dtype=torch.int64))
    return n


def _train_run(torch, cfg, batch, dev, *, remat, quant, steps,
               lr=1e-3, diagnose=0, profiled=None):
    """``steps`` train steps of ``cfg`` under ``remat``, with int8
    moments or fp32 ones, from the init drawn from seed 0 on the card,
    on one repeated batch, AdamW under the WSD schedule of TRAIN_STEPS
    steps to ``lr``. Returns (rows of (loss, grad_norm, seconds), the
    step's peak GiB above what was held before, the GiB a forward then
    holds for its backward, the moments' bytes, the params' bytes); each
    of the first ``diagnose`` rows also holds, before its step,
    ``_cref15_codes`` and, after it, ``_moved`` (untimed, the old params
    on the host); with ``profiled``, one more step runs under the
    profiler."""
    from repro_torch.models import build_model
    from repro_torch.pytree import flatten, leaves, unflatten
    from repro_torch.train import adamw, make_schedule, make_train_step

    model = build_model(cfg.replace(remat=remat))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    opt_init, opt_update = adamw(
        make_schedule("wsd", lr, TRAIN_STEPS, warmup_steps=2),
        quantize_moments=quant)
    opt = opt_init(params)
    step = make_train_step(model, opt_update)
    rows = []
    for i in range(steps):
        if i < diagnose:
            codes = _cref15_codes(torch, opt)
            old = [p.to("cpu") for p in leaves(params)]
        torch.cuda.synchronize()
        t0 = time.monotonic()
        params, opt, metrics = step(params, opt, batch)
        torch.cuda.synchronize()
        rows.append((float(metrics["loss"]), float(metrics["grad_norm"]),
                     time.monotonic() - t0))
        if i < diagnose:
            rows[-1] += (codes, _moved(torch, params, old,
                                       float(metrics["lr"])))
            del old
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    moment_bytes = _nbytes((opt.m, opt.v))
    pbytes = _nbytes(params)
    # what remat acts on: the activations a forward keeps for its
    # backward (the step's peak comes later, at the end of the backward,
    # with every gradient and the embedding's backward beside the state)
    flat, tdef = flatten(params)
    live = [p.detach().requires_grad_(True) for p in flat]
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    loss, _ = model.loss(unflatten(tdef, live), batch)
    torch.cuda.synchronize()
    saved = (torch.cuda.memory_allocated() - before) / 2**30
    del loss, live, flat
    if profiled is not None:
        profiled(f"{cfg.name} train step (B = {TRAIN_B}, S = {TRAIN_S}, "
                 f"remat {remat}, {'int8' if quant else 'fp32'} moments)",
                 lambda: step(params, opt, batch), 12)
    del params, opt, step
    torch.cuda.empty_cache()
    return rows, peak, saved, moment_bytes, pbytes


def _remat_backward_peaks(torch, cfg, batch, dev) -> tuple:
    """({remat: a backward's peak GiB above the params}, {remat: loss}):
    ``value_and_grad`` of ``cfg`` cut to REMAT_PEAK_LAYERS layers, from
    the init drawn from seed 0 on the card, under each remat."""
    from repro_torch.models import build_model
    from repro_torch.train.trainstep import value_and_grad

    peaks, losses = {}, {}
    for remat in ("none", "dots", "full"):
        model = build_model(cfg.replace(n_layers=REMAT_PEAK_LAYERS,
                                        remat=remat))
        params = model.init(torch.Generator(device=dev).manual_seed(0),
                            device=dev)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        loss, _, grads = value_and_grad(model, params, batch)
        torch.cuda.synchronize()
        peaks[remat] = (torch.cuda.max_memory_allocated() - base) / 2**30
        losses[remat] = float(loss)
        del params, grads, loss
        torch.cuda.empty_cache()
    return peaks, losses


def _train_bound(cfg, n_params, tokens, pbytes, moment_bytes) -> tuple:
    """(bound ms, its FLOP term, its byte term, the fp32 attention
    term): 6·N·T over the bf16 peak, plus the optimizer's bytes (params
    read and written, grads read, moments read and written) over HBM.
    The model's attention einsums run in fp32 without TF32, outside
    6·N·T: 3 × 4·T·H·S·hd a layer for the forward and backward, over the
    fp32 peak, printed beside the bound."""
    flop_ms = 6 * n_params * tokens / BF16_OPS_PER_S * 1e3
    byte_ms = (3 * pbytes + 2 * moment_bytes) / HBM_BYTES_PER_S * 1e3
    attn_ms = 3 * 4 * tokens * cfg.n_heads * TRAIN_S * cfg.hd \
        * cfg.n_layers / FP32_OPS_PER_S * 1e3
    return flop_ms + byte_ms, flop_ms, byte_ms, attn_ms


def _twelfth_slice_path(torch, np, K, dev, profiled):
    """Path (l): LM training on the card, plain PyTorch (the reference's
    training path reaches no Pallas kernel: ``_sdpa`` is plain jnp, the
    MoE dispatch a jnp gather, the Mamba2 SSD einsums and a scan, and no
    kernel of the reference has a backward). The ten archs at SMOKE
    (fp32): one ``make_train_step`` step on the card against the CPU
    from the same params (loss within TRAIN_TOL, every gradient leaf
    within TRAIN_TOL × the global norm, params within TRAIN_TOL relative
    L2). MiniCPM-2B whole (bf16, B = TRAIN_B, S = TRAIN_S, one repeated
    batch, AdamW under WSD to lr 1e-3): TRAIN_STEPS steps with fp32
    moments (finite, the last loss below the first, no param moved past
    10 lr in a step), then one step under torch.profiler; REMAT_STEPS
    under "dots" and under "full" from the same init (step-1 loss within
    REMAT_LOSS_RTOL of "none"'s; the step's peak and the activations a
    forward keeps printed), and a backward at REMAT_PEAK_LAYERS layers
    under each (its peak lower under "dots" and again under "full", the
    loss equal); QUANT_STEPS with int8 moments (finite, the same step-1
    loss, the peak lower by the moments' saved bytes; per step the
    entries read with v code 0 under an m code and the params moved past
    10 lr, printed: the reference's linear int8 v turns such updates into
    m / eps, C-ref-15), and QUANT_STEPS more at lr QUANT_LR, with int8
    moments and with fp32 ones (finite; int8's loss below the last at
    each step, and falling by QUANT_DROP of fp32's drop or more); ms a
    step, tok/s and peak of each beside the bound. A checkpoint of MiniCPM-2B's width at CKPT_LAYERS
    layers with int8 moments, saved and restored bit-equal.
    ``launch.train`` with an injected fault (1 restart). The GPipe
    pipeline over a 4-part mesh on the card against the sequential
    product. No kernel launches."""
    import shutil
    import tempfile

    from repro_torch.ckpt import restore_checkpoint, save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.core.partition import Mesh
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.launch import train as TR
    from repro_torch.models import build_model
    from repro_torch.parallel.pipeline import pipeline_apply
    from repro_torch.pytree import leaves
    from repro_torch.train import adamw, make_schedule, make_train_step

    t_path = time.monotonic()
    K.reset_launches()

    # ---- the SMOKE configs: a train step on the card against the CPU
    for arch in LM_ARCHS + LM_SSM_ARCHS:
        d_loss, d_grad, rel = _train_smoke(torch, arch, dev)
        if not (d_loss < TRAIN_TOL and d_grad <= TRAIN_TOL
                and rel < TRAIN_TOL):
            raise AssertionError(
                f"path (l) {arch} SMOKE train step, card vs CPU: loss "
                f"{d_loss:.2e}, gradient {d_grad:.2e} of the global norm, "
                f"params rel L2 {rel:.2e} (each < {TRAIN_TOL:g})")
        print(f"path (l) {arch} SMOKE train step, card vs CPU: |loss diff| "
              f"{d_loss:.2e}, max |grad diff| {d_grad:.2e} of the global "
              f"norm, params after the step rel L2 {rel:.2e} "
              f"(each < {TRAIN_TOL:g})")

    # ---- MiniCPM-2B, whole, bf16
    cfg = get_config("minicpm-2b")
    n = build_model(cfg).param_count(build_model(cfg).init(device="meta"))
    batch = SyntheticLMDataset(cfg.vocab, TRAIN_S, TRAIN_B, seed=0,
                               device=dev).next_batch()
    tokens = TRAIN_B * TRAIN_S
    stable, stable32 = f"int8, lr {QUANT_LR:g}", f"fp32, lr {QUANT_LR:g}"
    runs = {"none": _train_run(torch, cfg, batch, dev, remat="none",
                               quant=False, steps=TRAIN_STEPS,
                               diagnose=QUANT_STEPS, profiled=profiled)}
    for remat in ("dots", "full"):
        runs[remat] = _train_run(torch, cfg, batch, dev, remat=remat,
                                 quant=False, steps=REMAT_STEPS)
    runs["int8"] = _train_run(torch, cfg, batch, dev, remat="none",
                              quant=True, steps=QUANT_STEPS,
                              diagnose=QUANT_STEPS)
    for label, quant in ((stable, True), (stable32, False)):
        runs[label] = _train_run(torch, cfg, batch, dev, remat="none",
                                 quant=quant, steps=QUANT_STEPS, lr=QUANT_LR)
    held = torch.cuda.memory_allocated() / 2**30
    for label, (rows, peak, saved, mbytes, pbytes) in runs.items():
        ms = statistics.median(r[2] for r in rows[1:]) * 1e3
        bound, flop_ms, byte_ms, attn_ms = _train_bound(cfg, n, tokens,
                                                        pbytes, mbytes)
        print(f"path (l) minicpm-2b train, {label} ({n:,} params, B="
              f"{TRAIN_B}, S={TRAIN_S}): loss "
              f"{', '.join(f'{r[0]:.4f}' for r in rows)}; grad_norm "
              f"{', '.join(f'{r[1]:.3f}' for r in rows)}; {ms:.2f} ms a "
              f"step (median of steps 2-{len(rows)}; step 1 "
              f"{rows[0][2] * 1e3:.1f} ms), {tokens / ms * 1e3:.0f} tok/s; "
              f"bound {bound:.1f} ms (6·N·T = {6 * n * tokens:.3e} FLOP "
              f"over 989 TFLOP/s, {flop_ms:.1f} ms, + the optimizer's "
              f"{(3 * pbytes + 2 * mbytes) / 1e9:.1f} GB over 3.35 TB/s, "
              f"{byte_ms:.1f} ms; the fp32 attention einsums outside 6·N·T "
              f"add {attn_ms:.1f} ms over 67 TFLOP/s); peak {peak:.2f} GiB "
              f"above the {held:.2f} GiB held, a forward keeps "
              f"{saved:.2f} GiB for its backward; moments "
              f"{mbytes / 1e9:.2f} GB")
        diag = [r for r in rows if len(r) > 3]
        if diag:
            print(f"path (l) minicpm-2b train, {label}, steps 1-{len(diag)}: "
                  f"read v code 0 under an m code != 0 at "
                  f"{', '.join(f'{r[3][0]:,}' for r in diag)} of "
                  f"{diag[0][3][1]:,} int8 entries; params moved past 10 lr "
                  f"{', '.join(f'{r[4]:,}' for r in diag)}")
        if not all(math.isfinite(r[0]) and math.isfinite(r[1])
                   for r in rows):
            raise AssertionError(f"path (l) minicpm-2b {label}: a loss or "
                                 f"grad_norm is not finite: {rows}")
    losses = [r[0] for r in runs["none"][0]]
    if not losses[-1] < losses[0]:
        raise AssertionError(f"path (l) minicpm-2b none: the loss did not "
                             f"fall: {losses}")
    if any(r[4] for r in runs["none"][0] if len(r) > 3):
        raise AssertionError(f"path (l) minicpm-2b none: fp32 moments moved "
                             f"params past 10 lr: {runs['none'][0]}")
    # every run starts from the same init on the same batch, so the step-1
    # loss is the same; the int8 moments follow the reference's linear v,
    # whose small entries round to code 0 and turn updates into m / eps
    # (ROADMAP C-ref-15): at lr 1e-3 that is printed, at QUANT_LR the loss
    # must fall
    first = runs["none"][0][0][0]
    for label in ("dots", "full", "int8", stable, stable32):
        got = runs[label][0][0][0]
        if not abs(got - first) <= REMAT_LOSS_RTOL * abs(first):
            raise AssertionError(f"path (l) minicpm-2b {label}: step-1 loss "
                                 f"{got} against none's {first}")
    int8_losses = [r[0] for r in runs["int8"][0]]
    stable_losses = [r[0] for r in runs[stable][0]]
    fp32_losses = [r[0] for r in runs[stable32][0]]
    drop = stable_losses[0] - stable_losses[-1]
    drop32 = fp32_losses[0] - fp32_losses[-1]
    if not (all(b < a for a, b in zip(stable_losses, stable_losses[1:]))
            and drop >= QUANT_DROP * drop32):
        raise AssertionError(f"path (l) minicpm-2b {stable}: the loss "
                             f"{stable_losses} does not fall at every step "
                             f"or by {QUANT_DROP:g} of fp32's {fp32_losses}")
    bwd, bwd_losses = _remat_backward_peaks(torch, cfg, batch, dev)
    if not (bwd["none"] > bwd["dots"] > bwd["full"]
            and bwd_losses["none"] == bwd_losses["dots"]
            == bwd_losses["full"]):
        raise AssertionError(f"path (l) minicpm-2b at {REMAT_PEAK_LAYERS} "
                             f"layers: a backward's peak {bwd} (GiB) does "
                             f"not fall from none to dots to full, or the "
                             f"loss differs: {bwd_losses}")
    peaks = {k: v[1] for k, v in runs.items()}
    kept = {k: v[2] for k, v in runs.items()}
    saved = (runs["none"][3] - runs["int8"][3]) / 2**30
    # the allocator rounds each block up, so the drop is held to 99 % of
    # the moments' bytes
    if not peaks["none"] - peaks["int8"] >= 0.99 * saved:
        raise AssertionError(f"path (l) minicpm-2b int8 moments: peak "
                             f"{peaks['int8']:.2f} GiB against none's "
                             f"{peaks['none']:.2f}, less than the moments' "
                             f"{saved:.2f} GiB saved")
    print(f"path (l) minicpm-2b: step-1 loss under dots / full / int8 "
          f"within {REMAT_LOSS_RTOL:g} of none's; at lr 1e-3 int8's loss "
          f"{'falls' if int8_losses[-1] < int8_losses[0] else 'does not fall'}"
          f" over its {QUANT_STEPS} steps ({int8_losses[0]:.4f} -> "
          f"{int8_losses[-1]:.4f}; C-ref-15), at lr {QUANT_LR:g} it falls "
          f"at every step, by {drop:.4f} against fp32 moments' "
          f"{drop32:.4f}; a backward's peak at "
          f"{REMAT_PEAK_LAYERS} layers, GiB: none {bwd['none']:.2f} > dots "
          f"{bwd['dots']:.2f} > full {bwd['full']:.2f} (the same loss); at "
          f"{cfg.n_layers} layers a forward keeps none {kept['none']:.2f}, "
          f"dots {kept['dots']:.2f}, full {kept['full']:.2f} for its "
          f"backward, and the step's peak is none {peaks['none']:.2f}, "
          f"dots {peaks['dots']:.2f}, full {peaks['full']:.2f}, int8 "
          f"moments {peaks['int8']:.2f} ({peaks['none'] - peaks['int8']:.2f}"
          f" below none; the moments save {saved:.2f})")

    # ---- a checkpoint at full width: MiniCPM-2B cut to CKPT_LAYERS layers
    cfg_c = cfg.replace(n_layers=CKPT_LAYERS)
    model_c = build_model(cfg_c)
    params = model_c.init(torch.Generator(device=dev).manual_seed(1),
                          device=dev)
    opt_init, opt_update = adamw(make_schedule("wsd", 1e-3, TRAIN_STEPS,
                                               warmup_steps=2),
                                 quantize_moments=True)
    state = make_train_step(model_c, opt_update)(params, opt_init(params),
                                                 batch)[:2]
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        torch.cuda.synchronize()
        t0 = time.monotonic()
        path = save_checkpoint(ckpt_dir, 1, state)
        save_s = time.monotonic() - t0
        on_disk = sum(p.stat().st_size for p in Path(path).iterdir())
        t0 = time.monotonic()
        got, _ = restore_checkpoint(ckpt_dir, 1, state, device=dev)
        torch.cuda.synchronize()
        restore_s = time.monotonic() - t0
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    pairs = list(zip(leaves(state), leaves(got)))
    if not all(a.dtype == b.dtype and torch.equal(a, b) for a, b in pairs):
        raise AssertionError("path (l) checkpoint: the restored tree "
                             "differs from the saved one")
    print(f"path (l) checkpoint of {cfg_c.name} at full width, "
          f"{CKPT_LAYERS} layers ({model_c.param_count(state[0]):,} params "
          f"in bf16, int8 moments after one step): {len(pairs)} leaves, "
          f"{on_disk / 1e9:.2f} GB on disk; save {save_s:.2f} s, restore "
          f"{restore_s:.2f} s; bit-equal")
    del params, state, got, pairs
    torch.cuda.empty_cache()

    # ---- the launcher with an injected fault
    launch_dir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        report = TR.main(["--arch", "minicpm-2b", "--smoke", "--steps", "12",
                          "--batch", "4", "--seq", "64",
                          "--ckpt-dir", launch_dir, "--ckpt-every", "5",
                          "--simulate-failure", "7"])
    finally:
        shutil.rmtree(launch_dir, ignore_errors=True)
    losses = [h["loss"] for h in report["history"]]
    if not (report["completed"] and report["restarts"] == 1
            and losses[-1] < losses[0]):
        raise AssertionError(f"path (l) launch.train: completed "
                             f"{report['completed']}, restarts "
                             f"{report['restarts']}, losses {losses}")
    print(f"path (l) launch.train minicpm-2b --smoke, 12 steps, a fault at "
          f"step 7: completed, 1 restart (resumed from step 5), loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}")

    # ---- the GPipe pipeline over a 4-part mesh on the one card
    rng = np.random.default_rng(0)
    ws = torch.from_numpy((rng.standard_normal((4, 16, 16)) * 0.3)
                          .astype(np.float32)).to(dev)
    x = torch.from_numpy(rng.standard_normal((16, 16)).astype(np.float32)
                         ).to(dev)
    y = pipeline_apply(lambda w, h: torch.tanh(h @ w), ws, x,
                       Mesh.on(dev, (4,), ("stage",)), n_microbatches=8)
    want = x
    for i in range(4):
        want = torch.tanh(want @ ws[i])
    pipe_err = float((y - want).abs().max())
    if not pipe_err < PIPE_ATOL:
        raise AssertionError(f"path (l) pipeline: {pipe_err:.2e} from the "
                             f"sequential product")
    print(f"path (l) pipeline_apply, 4 stages x 8 microbatches (11 ticks) "
          f"on the card: max |y - sequential| {pipe_err:.2e} "
          f"(< {PIPE_ATOL:g})")

    launched = {k: c for k, c in _launch_counts(K).items() if c}
    if launched:
        raise AssertionError(f"path (l) launched kernels: {launched}")
    print("path (l) launches: 0 for every kernel — the reference's training "
          "path reaches no Pallas kernel, and none of its kernels has a "
          "backward")
    print(f"path (l) run and validated in {time.monotonic() - t_path:.1f} s")


def _kernel_api_names(torch, K, P, SR, g, sources, dev):
    """The reference's oracle names (kernels.ref) at path (a)'s shapes,
    each against the kernel it models, called through the reference's
    kernel-API names (kernels.ops; that each of those reaches its
    registry-named wrapper is a CPU test): every integer output equal,
    the ELL oracles on integer-valued operands (exact sums) equal, the
    attention oracle within ATTENTION_TOL. Returns the names checked."""
    n, m = g.num_vertices, g.num_edges
    b = len(sources)
    ro, ci = g.row_offsets, g.col_indices
    checked = []

    def equal(name, got, want):
        for i, (x, y) in enumerate(zip(got, want)):
            if not torch.equal(x, y):
                raise AssertionError(f"{name}: output {i} differs from the "
                                     f"kernel")
        checked.append(name)

    # K2 on the first source's level-1 frontier, a (n,) keep mask
    keep = torch.zeros((n,), dtype=torch.int32, device=dev)
    s0 = sources[0]
    keep[ci[int(ro[s0]):int(ro[s0 + 1])].long()] = 1
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    equal("filter_compact_ref", P.filter_compact_ref(ids, keep),
          K.filter_compact(ids, keep))
    del keep, ids
    gen = torch.Generator(device=dev).manual_seed(7)
    if K.oracle is not P:
        raise AssertionError("kernels.ops.oracle is not kernels.ref")
    checked.append("oracle")
    # K6 over the out-degrees: the oracle's geometry from the offsets
    deg = g.degrees.to(torch.int32).contiguous()
    cap6 = 1 << max(m - 1, 1).bit_length()
    exp = K.lb_expand(deg, cap6)
    equal("lb_expand_ref", P.lb_expand_ref(P.lb_offsets(deg), cap6),
          (exp.in_pos, exp.rank, exp.valid.to(torch.int32)))
    del exp, deg
    # K5 (found) on 2^22 probes: random rows' neighbour lists, needles
    # half drawn from the list, half at random
    rows = torch.randint(0, n, (1 << 22,), generator=gen, device=dev,
                         dtype=torch.int32)
    lo, hi = ro[rows.long()], ro[rows.long() + 1]
    span = (hi - lo).clamp(min=1)
    at = lo + (torch.rand(rows.shape, generator=gen, device=dev)
               * span).to(torch.int32)
    needles = torch.where(torch.rand(rows.shape, generator=gen, device=dev)
                          < 0.5, ci[at.clamp(max=m - 1).long()],
                          torch.randint(0, n, rows.shape, generator=gen,
                                        device=dev, dtype=torch.int32))
    found = K.segment_search(ci, lo, hi, needles)
    equal("segment_search_ref",
          [P.segment_search_ref(ci, lo, hi, needles)],
          [found.to(torch.int32)])
    del rows, lo, hi, span, at, needles, found
    # the ELL oracles over rmat-22's first ell_width neighbours a row,
    # against K4 / K4m on the CSR cut to those neighbours; integer-valued
    # weights and x, so every sum is exact in any order
    width = int(g.ell_width)
    lanes = torch.arange(width, device=dev)
    deg = (ro[1:] - ro[:-1]).long()
    ok = lanes[None, :] < deg[:, None]
    idx = (ro[:-1].long()[:, None] + lanes[None, :]).clamp(max=m - 1)
    nbrs = torch.where(ok, ci[idx], -1)
    vals = torch.where(ok, g.edge_values[idx], 0.0)
    del idx
    ro_t = torch.cat([ro.new_zeros(1), torch.cumsum(
        deg.clamp(max=width), 0).to(torch.int32)])
    ci_t, v_t = nbrs[ok].contiguous(), vals[ok].contiguous()
    xi = torch.randint(0, 8, (n,), generator=gen, device=dev).to(
        torch.float32)
    none = ro.new_zeros(0)             # no row passes the width: no overflow
    equal("spmv_ell_ref", [P.spmv_ell_ref(nbrs, vals, xi)],
          [K.semiring_spmv(ro_t, ci_t, v_t, xi, SR.plus_times, width, None,
                           None, none, none)])
    xk = torch.randint(0, 8, (n, b), generator=gen, device=dev).to(
        torch.float32)
    mask = torch.rand((n,), generator=gen, device=dev) < 0.7
    equal("semiring_ell_ref",
          [P.semiring_ell_ref(nbrs, vals, xk, mask.to(torch.int32),
                              SR.min_plus)],
          [K.semiring_spmm(ro_t, ci_t, v_t, xk, SR.min_plus, width, mask)])
    del nbrs, vals, ok, ro_t, ci_t, v_t, xi, xk, mask
    # K7 at the 128-query chunk against 8192 keys (D = 128, bf16), K8 at
    # Kimi K2's dispatch
    q, k, v = (torch.randn((sq, QWEN2_VL_HEAD), generator=gen,
                           device=dev).to(torch.bfloat16)
               for sq in (128, 8192, 8192))
    rtol, atol = ATTENTION_TOL["bfloat16"]
    got = K.flash_attention(q, k, v, causal=True).float()
    want = P.flash_attention_ref(q, k, v, causal=True).float()
    if not torch.allclose(got, want, rtol=rtol, atol=atol):
        raise AssertionError("flash_attention_ref differs from K7 beyond "
                             "ATTENTION_TOL")
    checked.append("flash_attention_ref")
    cap_e = max(8 * math.ceil(math.ceil(
        MOE_TOKENS * KIMI_TOP_K / KIMI_EXPERTS * MOE_CAPACITY_FACTOR) / 8), 8)
    slot = _moe_slots(torch, MOE_TOKENS, KIMI_EXPERTS, KIMI_TOP_K, cap_e,
                      dev)
    xm = torch.randn((MOE_TOKENS, KIMI_D_MODEL), generator=gen,
                     device=dev).to(torch.bfloat16)
    equal("moe_gather_ref", [P.moe_gather_ref(xm, slot)],
          [K.moe_gather(xm, slot)])
    del q, k, v, got, want, xm, slot
    torch.cuda.empty_cache()
    return checked


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
    sys.path.insert(0, str(root / "tools"))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device is available", file=sys.stderr)
        return 2

    from repro_torch.core import backend as B
    from repro_torch.core import frontier as F
    from repro_torch.core import graph as G
    from repro_torch.core import operators as O
    from repro_torch.core import ref as R
    from repro_torch.core import storage as S
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
    from repro_torch.kernels import runtime, tuner
    from repro_torch.linalg import ops as L
    from repro_torch.linalg import semiring as SR
    from search_steps import join_probe

    t_start = time.monotonic()
    dev = runtime.resolve_device(None)
    # fp32 products in full fp32 (the defaults, stated): the plain
    # attention's matmuls are the yardstick of K7's fp32 sums
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
    # K7 runs on the tensor cores in every input type and head width
    hmma = {}
    for name, c in _hmma_counts(runtime).items():
        if "attn_kernel" in name:
            short = re.search(r"attn_kernel<[^>]*>", name)
            hmma[short.group(0) if short else name] = c
    if len(hmma) != 12 or min(hmma.values()) == 0:
        raise AssertionError(f"attention kernels without tensor-core "
                             f"instructions in their SASS: {hmma}")
    print("K7 SASS (cuobjdump): HMMA instructions per instantiation: "
          + ", ".join(f"{k} {c}" for k, c in sorted(hmma.items())))
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

    def record(name, err, ms, plain_ms, nbytes, ops, library_ms=None,
               rate=FP32_OPS_PER_S):
        bound, by = _bound_ms(nbytes, ops, rate)
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

    ys = _yardsticks(torch, dev)
    blocks = tuner.candidates(tuner.MAX_THREADS)
    lb_seen = []                 # the K3 / K6 calls shown as two kernels
    k5_seen = []                 # the K5 calls shown as its one kernel
    # K6's device operations at rmat-22's expansion (phase 2 (d) checks
    # and times it), taken with the run's first profiler sessions: later
    # one-call sessions lose records (PERF.md §7)
    deg32 = g.degrees.to(torch.int32).contiguous()
    devops, dev_ms, bare = _device_ops(
        torch, lambda: K.lb_expand(deg32, tuner.pow2_ceil(m)))
    k6_ops = (f"{_lb_ops(devops, bare, 'K6', lb_seen)}, device "
              f"{dev_ms:.3f} ms")
    del deg32
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

            # K1: fused advance + filter
            def k1():
                return K.advance_filter_batch(ro, ci, base, sizes, visited,
                                              cap_out, cap_v, g.cache)

            def p1():
                return P.advance_filter_batch(ro, ci, base, sizes, visited,
                                              cap_out, cap_v)

            got1 = k1()
            equal_ints("advance_filter_batch", got1, p1())
            if not _first_clean(torch, g.cache):
                raise AssertionError("K1 left its first-slot table "
                                     "dirty")
            reps = 3 if cap_out == m else 20
            ms = _timed(torch, k1, reps)
            pms = _timed(torch, p1, 2 if cap_out == m else 5)
            # every input lane's size, a live lane's base and row offset,
            # a live slot's column and bitmap byte, the ids / srcs rows
            nbytes = (bl * cap_v * 4 + live * 8 + slots * 5 + bl * cap_v * 8
                      + bl * 8)
            ops = slots * 8
            devops, dev_ms, bare = _device_ops(torch, k1)
            _, kept = _k1_traffic(torch, g.row_seg, ci, front_mask, visited)
            floor = _k1_floor_ms(ys, nbytes, slots, kept,
                                 int(got1[3].sum()))
            print(f"K1 advance_filter_batch B={bl} cap_out={cap_out} "
                  f"slots={slots} kept={kept} survivors="
                  f"{int(got1[3].sum())}: {ms:.3f} ms, plain {pms:.3f} ms, "
                  f"bound {_bound_ms(nbytes, ops)[0]:.3f} ms, practical "
                  f"floor {floor:.3f} ms; {_ops_text(devops, bare)}, "
                  f"device {dev_ms:.3f} ms; first-slot table all INT32_MAX")
            if bl == b and cap_out == m:
                record("advance_filter_batch", 0, ms, pms, nbytes, ops)
            del front

            # K3: advance over an SSSP near pile (frontier capacity n)
            near = F.compact_indices_batch(front_mask, n, backend="torch")
            base3, sizes3 = O._base_and_sizes(g, near.ids, near.valid_mask,
                                              "vertex")

            def k3(t=None):
                return K.advance_batch(ro, ci, base3, sizes3, cap_out,
                                       threads=t)

            def p3():
                return P.advance_batch(ro, ci, base3, sizes3, cap_out)

            want3 = p3()
            equal_ints("advance_batch", k3(), want3)
            _check_blocks(torch, f"K3 B={bl} cap_out={cap_out}", k3, want3,
                          blocks)
            del want3
            ms = _timed(torch, k3, reps)
            pms = _timed(torch, p3, 2 if cap_out == m else 5)
            # every input lane's size (cap_in = n), a live lane's base and
            # row offset, a live slot's column, 21 bytes an output slot
            nbytes = (bl * n * 4 + live * 8 + slots * 4 + bl * cap_out * 21
                      + bl * 4)
            ops = bl * cap_out * 4
            devops, dev_ms, bare = _device_ops(torch, k3)
            ops_k3 = _lb_ops(devops, bare, f"K3 B={bl} cap_out={cap_out}",
                             lb_seen)
            print(f"K3 advance_batch B={bl} cap_out={cap_out} cap_in={n} "
                  f"slots={slots}: {ms:.3f} ms, plain {pms:.3f} ms, "
                  f"bound {_bound_ms(nbytes, ops)[0]:.3f} ms; bit-equal on "
                  f"every slot at {blocks} threads per block; "
                  f"{ops_k3}, device {dev_ms:.3f} ms")
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
            devops, dev_ms, bare = _device_ops(torch, k2)
            print(f"K2 compact B={bl} cap={n} kept={kept}: {ms:.3f} ms, "
                  f"plain {pms:.3f} ms, masked_select {lms:.3f} ms, "
                  f"bound {_bound_ms(nbytes, bl * n * 4)[0]:.3f} ms, "
                  f"practical floor {nbytes / ys['copy'] * 1e3:.3f} ms "
                  f"(its bytes at the copy rate); "
                  f"{_ops_text(devops, bare)}, "
                  f"device {dev_ms:.3f} ms")
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
    # where its time goes: the light rows (degree <= width, the tree
    # alone) and the heavy rows (the tree and the ordered overflow) as
    # masks of the same sweep, and the floor the fixed order sets: the
    # longest overflow's dependent adds at the card's maximum SM clock
    cdeg = (g.csc_offsets[1:] - g.csc_offsets[:-1]).long()
    cw = g.csc_ell_width
    heavy_rows = cdeg > cw
    split_ms = {}
    for label, rows in (("light", ~heavy_rows), ("heavy", heavy_rows)):
        args_m = spmv_args[:6] + (rows,) + spmv_args[7:]
        split_ms[label] = _timed(torch, lambda: K.spmv(*args_m), 20)
    longest = int((cdeg - cw).clamp(min=0).max())
    mhz = _sm_clock_mhz()
    floor_ms = longest * FADD_CYCLES / (mhz * 1e6) * 1e3
    nheavy = int(heavy_rows.sum(dtype=torch.int64))
    print(f"K4 spmv split: light rows ({heavy_rows.numel() - nheavy}, degree "
          f"<= {cw}) {split_ms['light']:.3f} ms, heavy rows "
          f"({nheavy}) {split_ms['heavy']:.3f} ms; byte "
          f"bound {_bound_ms(nbytes, 0)[0]:.3f} ms, serial-chain floor "
          f"{floor_ms:.3f} ms (the longest overflow, {longest} ordered adds "
          f"x {FADD_CYCLES} cycles at {mhz:.0f} MHz)")
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

    def k3t(t=None):
        return K.advance(a_off, a_idx, base, sizes, cap, threads=t)

    def p3t():
        return O._advance_torch(a_off, a_idx, base, sizes, cap)

    want3 = p3t()
    equal_ints("advance (B=1, TC shape)", k3t(), want3)
    _check_blocks(torch, "K3 (B=1, TC shape)", k3t, want3, blocks)
    del want3
    torch.cuda.empty_cache()
    ms, pms = _timed(torch, k3t, 3), _timed(torch, p3t, 1)
    cap_in = int(base.shape[0])
    live = int((sizes != 0).sum(dtype=torch.int64))
    nbytes = cap_in * 4 + live * 8 + cap * 4 + cap * 21 + 4
    devops, dev_ms, bare = _device_ops(torch, k3t)
    print(f"K3 advance B=1 cap_out={cap} cap_in={cap_in} (TC shape): "
          f"{ms:.3f} ms, plain {pms:.3f} ms, bound "
          f"{_bound_ms(nbytes, cap * 4)[0]:.3f} ms; bit-equal on every "
          f"slot at {blocks} threads per block; "
          f"{_lb_ops(devops, bare, 'K3 TC shape', lb_seen)}, device "
          f"{dev_ms:.3f} ms")
    torch.cuda.empty_cache()
    _, needles, _, pair, _, _, _ = k3t()
    rows = torch.index_select(probe, 0, pair)
    del pair
    lo = torch.index_select(bt_off, 0, rows)
    hi = torch.index_select(bt_off, 0, rows + 1)
    torch.cuda.empty_cache()

    def k5l(t=None):
        return K.segment_locate(bt_idx, lo, hi, needles, threads=t)

    def p5l():
        return P.segment_locate(bt_idx, lo, hi, needles)

    pos = p5l()
    _check_blocks(torch, "K5 locate (TC shape)", lambda t: [k5l(t)], [pos],
                  blocks)
    equal_ints("segment_search (locate)", [k5l()], [pos])
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
    n_hit = int(hit.sum(dtype=torch.int64))
    del lpos, hit, pos
    ms, pms, lms = (_timed(torch, k5l, 10), _timed(torch, p5l, 1),
                    _timed(torch, lib5, 3))
    devops, dev_ms, bare = _device_ops(torch, k5l)
    # each lane reads needle, lo, hi and writes one int32; the haystack
    # once. Operations: at most floor(log2 len) + 1 steps of ~5 per lane
    seg = (hi - lo).clamp(min=1).to(torch.float32)
    steps = float(torch.where(hi > lo, torch.floor(torch.log2(seg)) + 1,
                              0.0).sum(dtype=torch.float64))
    nbytes, ops = cap * 16 + m_sub * 4, steps * 5 + cap * 4
    print(f"K5 segment_search locate cap={cap} hits={n_hit} (TC shape): "
          f"{ms:.3f} ms, plain {pms:.3f} ms, torch.searchsorted {lms:.3f} "
          f"ms, bound {_bound_ms(nbytes, ops)[0]:.3f} ms; "
          f"{_k5_ops(devops, bare, 'K5 TC locate', k5_seen)}, device "
          f"{dev_ms:.3f} ms; bit-equal at {blocks} threads per block")
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
    npairs = int((torch.cumsum(mins.long(), 0, dtype=torch.int64)
                  <= 3 * 10 ** 8).sum(dtype=torch.int64))
    need = int(mins[:npairs].sum())
    length = torch.tensor(npairs, dtype=torch.int32, device=dev)
    fa = F.SparseFrontier(ids=pu[:npairs].contiguous(), length=length)
    fb = F.SparseFrontier(ids=pv[:npairs].contiguous(), length=length)
    needles, lo, hi, _, _ = O._intersect_probes(g, fa, fb, need, "cuda")

    def k5f(t=None):
        return K.segment_search(ci, lo, hi, needles, threads=t)

    def p5f():
        return P.segment_search(ci, lo, hi, needles)

    found = p5f()
    _check_blocks(torch, "K5 found (rmat-22 probes)", lambda t: [k5f(t)],
                  [found], blocks)
    equal_ints("segment_search (found)", [k5f()], [found])
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
    devops, dev_ms, bare = _device_ops(torch, k5f)
    # 13 B per lane (needle, lo, hi, one bool); no haystack term: each
    # probe reads ~log2(deg) entries of one row, a small part of the
    # 513 MB of columns, and which entries it reads is not counted
    print(f"K5 segment_search found pairs={npairs} cap={need} hits="
          f"{int(found.sum())} (scale {args.scale}): {ms:.3f} ms, plain "
          f"{pms:.3f} ms, torch.searchsorted {lms:.3f} ms, bound "
          f"{_bound_ms(need * 13, 0)[0]:.3f} ms; "
          f"{_k5_ops(devops, bare, 'K5 found', k5_seen)}, device "
          f"{dev_ms:.3f} ms; bit-equal at {blocks} threads per block")
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

    # K5 (found) at subgraph_match's join on rmat-16: the triangle query's
    # one probe launch (path (c)'s), its inputs kept from a run. The plain
    # version runs in pieces of 2^27 lanes (lanes are independent)
    g16 = G.rmat(min(args.scale, LP_SCALE), EDGE_FACTOR, seed=0,
                 weighted=True, device=dev)
    cap16 = max(6 * int(triangle_count(g16, backend="cuda").total),
                g16.num_edges)
    j_hay, j_lo, j_hi, j_nd = join_probe(B, subgraph_match, g16, cap16)
    nj = int(j_nd.shape[0])
    piece = 1 << 27

    def k5j(t=None):
        return K.segment_search(j_hay, j_lo, j_hi, j_nd, threads=t)

    def p5j():
        return [P.segment_search(j_hay, j_lo[a:a + piece], j_hi[a:a + piece],
                                 j_nd[a:a + piece])
                for a in range(0, nj, piece)]

    for t in (None, *blocks):
        got = k5j(t)
        for a in range(0, nj, piece):
            if not torch.equal(got[a:a + piece], P.segment_search(
                    j_hay, j_lo[a:a + piece], j_hi[a:a + piece],
                    j_nd[a:a + piece])):
                raise AssertionError(f"K5 at subgraph_match's join differs "
                                     f"from the plain version at {t} "
                                     f"threads per block")
        del got
    torch.cuda.empty_cache()
    ms, pms = _timed(torch, k5j, 10), _timed(torch, p5j, 1)
    devops, dev_ms, bare = _device_ops(torch, k5j)
    # the library call: every [lo, hi) of the join is one whole CSR row,
    # so torch.searchsorted over (row, column) keys finds the needle where
    # the row holds it (an empty row finds nothing); in pieces of 2^27
    # lanes, whose int64 keys and positions do not fit whole beside the
    # rest of the run
    n16 = g16.num_vertices
    keys = g16.row_seg.long() * n16 + j_hay.long()
    queries = [((torch.searchsorted(g16.row_offsets, j_lo[a:a + piece],
                                    right=True) - 1) * n16
                + j_nd[a:a + piece].long()) for a in range(0, nj, piece)]
    got = k5j()
    for i, a in enumerate(range(0, nj, piece)):
        pos = torch.searchsorted(keys, queries[i]).clamp_(
            max=keys.numel() - 1)
        lfound = (keys[pos] == queries[i]) & (j_hi[a:a + piece]
                                              > j_lo[a:a + piece])
        if not torch.equal(lfound, got[a:a + piece]):
            raise AssertionError("segment_search (subgraph join) differs "
                                 "from torch.searchsorted")
        del pos, lfound
    del got
    def lib5j():
        for x in queries:
            torch.searchsorted(keys, x)

    lms = _timed(torch, lib5j, 2)
    del keys, queries
    print(f"K5 segment_search found at subgraph_match's join (rmat scale "
          f"{min(args.scale, LP_SCALE)}, cap {cap16}): {nj} lanes, "
          f"{ms:.3f} ms, plain {pms:.3f} ms (in pieces of 2^27 lanes), "
          f"torch.searchsorted {lms:.3f} ms (in the same pieces), bound "
          f"{_bound_ms(nj * 13, 0)[0]:.3f} ms (13 B a lane); "
          f"{_k5_ops(devops, bare, 'K5 subgraph join', k5_seen)}, device "
          f"{dev_ms:.3f} ms; bit-equal at {blocks} threads per block")
    del j_hay, j_lo, j_hi, j_nd, g16
    torch.cuda.empty_cache()

    # K5 (locate) at TC's probes on rmat scale 15 over the int16, int32
    # and int64 columns of one graph (path (e)'s storage plans)
    g15 = G.rmat(min(args.scale, INT16_SCALE), EDGE_FACTOR, seed=0,
                 weighted=True, device=dev)
    sub15, s15, d15 = TC._orient(g15)
    (a15, ai15, _), (b15, bi15, _), base15, probe15, cap15 = L.mxm_plan(
        sub15, sub15, (s15, d15), b_transpose=True)
    sz15 = (torch.index_select(a15, 0, base15 + 1)
            - torch.index_select(a15, 0, base15)).to(torch.int32)
    _, nd15, _, pair15, _, _, _ = K.advance(a15, ai15, base15, sz15, cap15)
    rows15 = torch.index_select(probe15, 0, pair15)
    lo15 = torch.index_select(b15, 0, rows15)
    hi15 = torch.index_select(b15, 0, rows15 + 1)
    want15 = P.segment_locate(bi15.to(torch.int32), lo15, hi15, nd15)
    # bound as at TC's shape: 16 B a lane, the haystack once at its
    # width, ~5 operations a search step and 4 a lane
    seg15 = (hi15 - lo15).clamp(min=1).to(torch.float32)
    steps15 = float(torch.where(hi15 > lo15, torch.floor(torch.log2(seg15))
                                + 1, 0.0).sum(dtype=torch.float64))
    # the library call, as at TC's shape: torch.searchsorted over (row,
    # column) keys made from each haystack (int64 keys whatever its width)
    n15 = g15.num_vertices
    query15 = rows15.long() * n15 + nd15.long()
    hit15 = want15 >= 0
    times15 = {}
    for dt in (torch.int16, torch.int32, torch.int64):
        hay15 = bi15.to(dt)
        _check_blocks(torch, f"K5 locate {dt} (rmat-15 TC)",
                      lambda t: [K.segment_locate(hay15, lo15, hi15, nd15,
                                                  threads=t)],
                      [want15], blocks)
        keys15 = sub15.row_seg.long() * n15 + hay15.long()

        def lib15():
            return torch.searchsorted(keys15, query15)

        if not torch.equal(lib15()[hit15], want15[hit15].long()):
            raise AssertionError(f"K5 locate {dt} (rmat-15) differs from "
                                 f"torch.searchsorted")
        bound = _bound_ms(cap15 * 16 + hay15.numel() * hay15.element_size(),
                          steps15 * 5 + cap15 * 4)
        def k15():
            return K.segment_locate(hay15, lo15, hi15, nd15)

        k_ms, l_ms = _in_turns(torch, [k15, lib15], 20)
        times15[str(dt).replace("torch.", "")] = (k_ms, bound, l_ms)
        del keys15
    print(f"K5 segment_search locate at rmat-15's TC probes ({cap15} "
          f"lanes): " + ", ".join(f"{k} {v:.4f} ms (bound {b:.4f} ms by "
                                  f"{by}; torch.searchsorted on (row, "
                                  f"column) keys {lm:.4f} ms)"
                                  for k, (v, (b, by), lm)
                                  in times15.items())
          + f"; each bit-equal to the plain version at {blocks} threads "
          f"per block, the searchsorted positions equal on every hit")
    del query15, hit15
    del g15, sub15, a15, ai15, b15, bi15, base15, probe15, sz15, nd15
    del pair15, rows15, lo15, hi15, want15, seg15
    torch.cuda.empty_cache()
    print(f"K5 calls recorded as exactly {K5_OP}: {k5_seen}")

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
    # general floats, plus_times: a row of at most SPMM_SPLIT edges is
    # folded by one group, each column in ascending edge order, as the
    # plain version on the CPU does (bit for bit, at every k); a longer
    # row's shares regroup its sums (rtol 1e-5, the reference's own limit
    # between its two providers)
    unsplit = (gs.degrees <= K.SPMM_SPLIT).cpu()
    float_err = 0.0
    for k in (1, 4, 5, 32, 33):
        xf = torch.rand((gs.num_vertices, k), generator=gen, device=dev)
        args_k = (gs.row_offsets, gs.col_indices, gs.edge_values, xf,
                  SR.plus_times, gs.ell_width, None, gs.row_seg)
        got = K.spmm(*args_k).cpu()
        want = P.spmm(*(a.cpu() if torch.is_tensor(a) else a
                        for a in args_k))
        rel = float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())
        if not torch.equal(got[unsplit], want[unsplit]) or rel > 1e-5:
            raise AssertionError(f"spmm plus_times k={k} on floats off its "
                                 f"plain version by {rel:.3g} (relative)")
        float_err = max(float_err, rel)
    print(f"K4m spmm: five semirings x (structural, weighted) x (masked, "
          f"unmasked) x k in (1, 4, 5, 32, 33) bit-equal to the plain "
          f"version on integer-valued blocks (rmat scale 14); float "
          f"plus_times bit-equal at every k on the "
          f"{int(unsplit.sum())} rows of at most {K.SPMM_SPLIT} edges, max "
          f"relative error {float_err:.3g} on the "
          f"{int((~unsplit).sum(dtype=torch.int64))} split rows")

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
    nneed = int(need.sum(dtype=torch.int64))
    print(f"K4m spmm or_and k={b} (reach's 2nd hop, {nneed} rows "
          f"live, {m_live} edges): {ms_r:.3f} ms, plain {pms_r:.3f} ms, "
          f"torch.sparse.mm {lms_r:.3f} ms, bound {bound_r:.3f} ms")
    del a_csc, y_k, r_hop, need, reach_args
    torch.cuda.empty_cache()

    # K4m at label propagation's shape: rmat scale 16, k = 32, the
    # one-hot block of the first 32 labels of the first iteration
    # (labels0 = arange(n)); plus_times, the vote counts. Timed again on
    # uniform floats of the same shape (a kernel that gained only on zero
    # rows of X would show there), beside cuSPARSE's product and the
    # gathers alone: index_select of the m rows of X the kernel gathers
    lp_scale = min(args.scale, LP_SCALE)
    g16 = G.rmat(lp_scale, EDGE_FACTOR, seed=0, weighted=True, device=dev)
    n16, m16 = g16.num_vertices, g16.num_edges
    lanes32 = torch.arange(32, dtype=torch.int32, device=dev)
    onehot = (torch.arange(n16, dtype=torch.int32, device=dev)[:, None]
              == lanes32[None, :]).to(torch.float32)
    uniform = torch.rand((n16, 32), generator=gen, device=dev)
    lp_args = (g16.row_offsets, g16.col_indices, None, onehot,
               SR.plus_times, g16.ell_width, None, g16.row_seg)
    lpu_args = lp_args[:3] + (uniform,) + lp_args[4:]
    cols16 = g16.col_indices.long()

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
    unsplit16 = g16.degrees <= K.SPMM_SPLIT
    y_u = K.spmm(*lpu_args)
    want_u = P.spmm(*(a.cpu() if torch.is_tensor(a) else a
                      for a in lpu_args)).to(dev)
    if not torch.equal(y_u[unsplit16], want_u[unsplit16]) or not (
            torch.allclose(y_u, want_u, rtol=1e-5, atol=1e-5)):
        raise AssertionError("spmm (label propagation shape, uniform "
                             "floats) off its plain version")
    ms, ms_u = _in_turns(torch, (k4l, lambda: K.spmm(*lpu_args)), 50)
    pms = _timed(torch, p4l, 5)
    lms, lms_u, gms = (_timed(torch, lib4l, 50),
                       _timed(torch, lambda: torch.sparse.mm(a16, uniform),
                              50),
                       _timed(torch, lambda: torch.index_select(
                           uniform, 0, cols16), 20))
    nbytes = (n16 + 1) * 4 + m16 * 4 + 2 * n16 * 32 * 4
    print(f"K4m spmm plus_times k=32 (label propagation, rmat scale "
          f"{lp_scale}: n={n16} m={m16}): one-hot block {ms:.4f} ms, uniform "
          f"floats {ms_u:.4f} ms (in turns), plain {pms:.3f} ms, "
          f"torch.sparse.mm {lms:.4f} / {lms_u:.4f} ms (max |difference| "
          f"{lib_err:g}), index_select of the {m16} gathered rows of X "
          f"{gms:.4f} ms ({m16 * 128 / 1e6:.1f} MB of 128-byte rows), bound "
          f"{_bound_ms(nbytes, 2 * m16 * 32)[0]:.4f} ms; uniform floats "
          f"bit-equal to the plain version on the CPU on the "
          f"{int(unsplit16.sum(dtype=torch.int64))} rows of at most "
          f"{K.SPMM_SPLIT} edges")
    record("spmm", 0, ms, pms, nbytes, 2 * m16 * 32, lms)
    del a16, y_k, y_u, want_u, onehot, uniform, lp_args, lpu_args, cols16
    torch.cuda.empty_cache()

    # ---- phase 2 (d): the fourth slice's kernels, K6-K8, at full width,
    # and every tuned kernel at every block size ----
    t0 = time.monotonic()
    fourth = _fourth_slice_kernels(torch, np, K, P, tuner, SR, g, gs, dev,
                                   record, k6_ops)
    torch.cuda.empty_cache()
    print(f"K6-K8 and the block sizes checked and timed in "
          f"{time.monotonic() - t0:.1f} s")

    # ---- phase 3: the main path on the cuda backend ----
    # launches by kernel and variant, summed over the main path's runs
    variant_totals = {k: {} for k in K.KERNELS}

    def tally(variants=None):
        """Add one run's launches by variant (the live counters, or a
        snapshot taken where the run ended) to the totals."""
        if variants is None:
            variants = {k: v.variants for k, v in K.KERNELS.items()}
        for name, per in variants.items():
            for var, c in per.items():
                variant_totals[name][var] = (
                    variant_totals[name].get(var, 0) + c)

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
    tally()
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

    # validation against the host oracles, computed side by side (numpy
    # and scipy release the interpreter lock in their large loops)
    t0 = time.monotonic()
    with ThreadPoolExecutor(ORACLE_THREADS) as pool:
        f_depths = [pool.submit(R.bfs_ref, g, s) for s in sources]
        f_dist = pool.submit(R.sssp_ref, g, sources)
        f_pr = pool.submit(R.pagerank_ref, g, iters=20)
        depths = [f.result() for f in f_depths]   # reach reuses them
        dist, pr_want = f_dist.result(), f_pr.result()
    for i, want in enumerate(depths):
        if not np.array_equal(r_bfsb.labels[i].cpu().numpy(), want):
            raise AssertionError(f"bfs_batch lane {i} differs from the "
                                 f"oracle")
    for f in r_bfs._fields:
        if not torch.equal(getattr(r_bfs, f), getattr(r_bfsb, f)[0]):
            raise AssertionError(f"bfs {f} differs from bfs_batch lane 0")
    if not np.array_equal(r_ssspb.dist.cpu().numpy(), dist):
        raise AssertionError("sssp_batch differs from Dijkstra")
    for f in r_sssp._fields:
        if not torch.equal(getattr(r_sssp, f), getattr(r_ssspb, f)[0]):
            raise AssertionError(f"sssp {f} differs from sssp_batch lane 0")
    pr_rel = R.pagerank_rel_err(r_pr.rank.cpu().numpy(), pr_want)
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
    tally()
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
    with ThreadPoolExecutor(ORACLE_THREADS) as pool:
        f_cc = pool.submit(R.cc_ref, g)
        f_bc = [pool.submit(R.bc_ref, g, s) for s in sources]
        f_tc = pool.submit(R.tc_ref, g_tc)
        f_tcs = pool.submit(R.tc_ref, g_full)
        cc_want, bc_want = f_cc.result(), [f.result() for f in f_bc]
        tc_want, tcs_want = f_tc.result(), f_tcs.result()
    if not np.array_equal(r_cc.labels.cpu().numpy(), cc_want):
        raise AssertionError("cc labels differ from scipy's components")
    bc_err = 0.0
    for i, s in enumerate(sources):
        got, want = r_bc.bc[i].cpu().numpy(), bc_want[i]
        if not np.allclose(got, want, rtol=1e-3, atol=1e-3):
            raise AssertionError(f"bc_batch lane {i} differs from Brandes")
        bc_err = max(bc_err, float((np.abs(got - want) / np.maximum(
            np.abs(want), 1.0)).max()))
    total = int(r_tc.total)
    if (total != tc_want or total != int(r_tc.per_edge.sum(dtype=torch.int64))
            or total != TRIANGLES.get(tc_scale, total)):
        raise AssertionError(f"triangle_count {total} differs from the "
                             f"oracle")
    small = int(r_tcs.total)
    if (small != int(r_tcf) or small != tcs_want
            or small != TRIANGLES.get(tc_scale - 2, small)):
        raise AssertionError(f"triangle_count_full {int(r_tcf)} / "
                             f"triangle_count {small} differ")
    print(f"validated cc against scipy, bc_batch against numpy Brandes "
          f"(max |error| / max(|bc|, 1) {bc_err:.3g}; limit rtol 1e-3, "
          f"atol 1e-3) and the triangles against scipy in "
          f"{time.monotonic() - t0:.1f} s")
    # path (h)'s single-placement runs: path (a)'s and (b)'s, kept
    single_h = {"bfs": (r_bfs.labels, timings["bfs"] * 1e3),
                "sssp": (r_sssp.dist, timings["sssp"] * 1e3),
                "pagerank": (r_pr.rank, timings["pagerank"] * 1e3),
                "cc": (r_cc.labels, timings2["cc"] * 1e3)}
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
    tally()
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
    # path (a)'s and (c)'s oracle-checked answers on its sources, for
    # path (f)'s served lanes
    oracle_f = {"bfs": r_bfsb.labels, "sssp": r_ssspb.dist,
                "pagerank": r_pr.rank, "reach": r_reach.reached}
    single_h["reach"] = (r_reach.reached, timings3["reach_batch"] * 1e3)
    del r_reach, r_lp, r_wtf, r_sm, r_smt
    torch.cuda.empty_cache()

    # ---- phase 3 (d): the fourth slice's path: the kernel layer's entry
    # points, the tuner (its five probes over the default ladder, into a
    # cache of its own) and the kernel API's lb_expand, flash_attention
    # and moe_gather at the shapes of phase 2 ----
    t0 = time.monotonic()
    launches4, variants4 = _fourth_slice_path(torch, K, P, tuner, runtime,
                                              root, dev, fourth)
    tally(variants4)
    del fourth
    torch.cuda.empty_cache()
    print(f"path (d) run and validated in {time.monotonic() - t0:.1f} s")

    # ---- phase 2 (e): the fifth slice's kernels: K1 and K3 in each column
    # form of the storage plans, K4 and K4m at bf16 ----
    t0 = time.monotonic()
    graphs5 = _fifth_slice_kernels(torch, np, K, P, O, F, G, S, SR, tuner,
                                   g, dev, record, ys, lb_seen)
    if "K6" not in lb_seen or len(lb_seen) < 2:
        raise AssertionError(f"the profiler recorded no K3 call, or not "
                             f"the K6 call, as exactly {LB_OPS}: {lb_seen}")
    print(f"K3 and K6 calls recorded as exactly {LB_OPS}: {lb_seen}")
    print(f"storage-plan kernels checked and timed in "
          f"{time.monotonic() - t0:.1f} s")

    # ---- phase 3 (e): the fifth slice's path: the storage plans on the
    # cuda backend (the grid dense and delta, rmat-15 int16 / int32 /
    # int64, rmat-22 delta, bf16 PageRank) ----
    t0 = time.monotonic()
    torch.cuda.reset_peak_memory_stats()
    launches5, variants5 = _fifth_slice_path(torch, np, K, R, G, S,
                                             graphs5, g, sources, dev)
    tally(variants5)
    print(f"path (e) run and validated in {time.monotonic() - t0:.1f} s; "
          f"peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")

    # ---- phase 3 (f): the sixth slice's path: serving (a clean mixed
    # stream, a chaos stream), telemetry and graph_serve's CLI ----
    t0 = time.monotonic()
    launches6, variants6, _ = _sixth_slice_path(torch, np, K, g, g16,
                                                sources, hub, oracle_f, dev,
                                                root)
    tally(variants6)
    del oracle_f
    torch.cuda.empty_cache()
    print(f"path (f) run and validated in {time.monotonic() - t0:.1f} s")

    # ---- phase 3 (g): the seventh slice's path: the load-balancing and
    # idempotence ablations (Fig. 19, Fig. 20, Table 8), the operators
    # they need and the reference's oracle names ----
    t0 = time.monotonic()
    launches7, variants7, _ = _seventh_slice_path(
        torch, np, K, P, O, F, G, R, SR, g, sources, depths, dist, dev)
    tally(variants7)
    torch.cuda.empty_cache()
    print(f"path (g) run and validated in {time.monotonic() - t0:.1f} s")

    # ---- phase 3 (h): the eighth slice's path: the sharded and 2-D
    # placements, every part on the one card ----
    launches8 = _eighth_slice_path(torch, np, K, G, g, g16, hub, sources,
                                   single_h, tri, dev)
    del single_h
    torch.cuda.empty_cache()

    # ---- phase 3 (i): the ninth slice's path: the analysis layer on the
    # card (the static checks, every primitive and the kernel API under
    # the launch audit, seeded faults, the set-up budgets) ----
    launches9, variants9 = _ninth_slice_path(torch, np, K, g_tc, g16,
                                             sm_cap, dev, root)
    tally(variants9)
    torch.cuda.empty_cache()

    # ---- phase 3 (j): the tenth slice's path: LM serving (plain PyTorch
    # on the card; no kernel launches) ----
    minicpm_decode = _tenth_slice_path(torch, np, K, dev)

    # ---- phase 3 (k): the eleventh slice's path: the ssm, hybrid and
    # encdec families (plain PyTorch on the card; no kernel launches) ----
    mamba2_decode = _eleventh_slice_path(torch, np, K, dev)

    # ---- where the time goes: each slice's path once more under
    # torch.profiler (its overhead inflates the wall time; the device
    # time per kernel is what it is for) ----
    def profiled(label, fn, top, host_ops=True):
        _profiled(torch, label, fn, top, host_ops)

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

    # path (e) takes ~14,000 BSP steps at side 2048; its breakdown is
    # taken on the delta grid of side PROFILE_GRID_SIDE (~1,700 steps),
    # PageRank at full size
    g_prof = G.grid2d(PROFILE_GRID_SIDE, weighted=True, seed=0,
                      encoding="delta", device=dev)

    def path_e():
        nn = g_prof.num_vertices
        srcs = [0, nn // 2 + PROFILE_GRID_SIDE // 2, 12345 % nn, nn - 1]
        bfs_batch(g_prof, srcs, backend="cuda")
        sssp_batch(g_prof, srcs, backend="cuda")
        pagerank(graphs5["grid-delta"], max_iter=20, backend="cuda")

    profiled("bfs_batch+sssp_batch+pagerank", path_a, 12)
    profiled("cc+bc_batch+triangle_count", path_b, 12)
    profiled("reach_batch+label_propagation (2 iterations)+wtf+"
             "subgraph_match", path_c, 12)
    profiled(f"grid {PROFILE_GRID_SIDE} delta: bfs_batch+sssp_batch, "
             f"grid {GRID_SIDE} delta: pagerank", path_e, 12, host_ops=False)
    # path (g)'s unfused push: where a TWC level's time goes
    profiled("bfs_batch TWC (push only, exact uniquify)",
             lambda: bfs_batch(g, sources, direction=False,
                               idempotence=False, strategy="TWC",
                               backend="cuda"), 12)
    # path (j): MiniCPM-2B's decode (B = 4, Smax 544), 16 steps
    profiled("minicpm-2b decode, 16 steps", minicpm_decode, 12)
    # path (k): Mamba2-780m's decode (B = 4, after a 512-token prompt)
    profiled("mamba2-780m decode, 16 steps", mamba2_decode, 12)
    del g_tc, g16, graphs5, g_prof, minicpm_decode, mamba2_decode
    torch.cuda.empty_cache()

    # ---- phase 3 (l): the twelfth slice's path: LM training (plain
    # PyTorch on the card; no kernel launches), last, once the earlier
    # paths' graphs and models are freed: MiniCPM-2B's step holds ~60 GB.
    # Its profile is taken inside it, with its state ----
    _twelfth_slice_path(torch, np, K, dev, profiled)

    # each kernel, then the column or precision variants this slice timed
    # as rows of their own, launches those of the main path's run
    kernels = []
    for name, k in K.KERNELS.items():
        kernels.append({"name": name, "route": "cuda", "source": k.source,
                        "replaces": k.replaces,
                        "launches": (launches[name] + launches2[name]
                                     + launches3[name] + launches4[name]
                                     + launches5[name] + launches6[name]
                                     + launches7[name] + launches8[name]
                                     + launches9[name]),
                        "variants": variant_totals[name],
                        **results[name]})
    for row in sorted(r for r in results if ":" in r):
        name, variant = row.split(":")
        k = K.KERNELS[name]
        kernels.append({"name": row, "route": "cuda", "source": k.source,
                        "replaces": k.replaces,
                        "launches": variant_totals[name].get(variant, 0),
                        **results[row]})
    print(f"total {time.monotonic() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
