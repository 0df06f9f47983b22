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
     overflow; K3 (B = 1) and K5 (locate) at triangle
     counting's shape, the mxm expansion of the oriented rmat scale-18
     graph (6.6e8 slots); K5 (found) on segmented_intersect's probes of
     edge pairs of the scale-22 graph, and on an empty haystack; K4m
     (spmm) bit-equal to its plain version on integer-valued blocks over
     five semirings x (structural, weighted) x (masked, unmasked) x
     k in {1, 4, 5, 32, 33}, on uniform floats (plus_times) bit-equal
     on every row it does not split at each of those k, and at reach's
     and label propagation's shapes (the latter on the one-hot block and
     on uniform floats, beside the index_select of the rows it gathers);
     K6 (lb_expand) bit-equal on every slot at rmat-22's
     whole-graph expansion (2^27 slots), at a capacity that is no power
     of two, on zero-size segments and at cap_in = 0; K7
     (flash_attention) at Qwen2-VL-2B's and Kimi K2's head widths (128,
     112) in bf16 and fp32 — prefill 8192 x 8192 causal, a 128-query
     chunk against 8192 keys, more queries than keys, non-causal —
     within one rounding of its output (bf16: rtol 8e-3, atol 1e-4) and
     3e-5 (fp32) of its plain version, rows that see no key exactly 0,
     its SASS holding tensor-core (HMMA) instructions in every
     instantiation, and at the chunk its split form (kv parts) and its
     combine kernel each against their plain versions; K8 (moe_gather)
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
     auto), sssp_batch (B = 4) and 20 PageRank sweeps on grid2d 2048
     (n = 4,194,304, the road-network stand-in at rmat-22's vertex
     count) under dense int32 and under the escape-free delta encoding,
     and on rmat scale 15 (n = 32,768, the int16 ladder's top) under
     int16, int32 and int64, with triangle_count under int16 and int32,
     each plan bit-equal to its int32 twin; bfs_batch and sssp_batch on
     rmat-22's delta stream (escaped: the dense fallback) equal to int32;
     bf16 PageRank at rmat-22 within 1e-2 of fp32; resident_bytes of
     every plan —
     all on the cuda backend, validated
     against host oracles (numpy BFS hop counts, scipy Dijkstra, a numpy
     power iteration, scipy components, numpy Brandes, scipy products
     for the triangles, a sort-based LP, float64 PPR and SALSA, 6 x the
     triangle count); each path runs with the launch counters set to 0
     and every kernel of it must have launched;
  4. where the time goes — path (a)'s batched primitives, then paths
     (b) and (c), and path (e) on the delta grid (its BFS and SSSP at
     side 512, device events only; PageRank at 2048), once more under
     torch.profiler: device busy time, idle share, top kernels.

Prints one JSON line of kernel numbers (each kernel with its launches by
variant — column storage or precision — and a row of its own for each
variant phase 2 (e) timed), then the card's name and power limit, then
``{"ok": true, "device": ...}`` as the last line. Any failure raises and
exits nonzero. Without a CUDA device, or outside a checkout
of the repository, it exits 2 and prints no result.
"""
from __future__ import annotations

import argparse
import json
import math
import re
import statistics
import subprocess
import sys
import threading
import time
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
INT32_MAX = 2 ** 31 - 1
GRID_SIDE = 2048       # grid2d: n = 4,194,304, rmat-22's vertex count
TIMING_ROUNDS = 5      # interleaved rounds when plans are compared
PROFILE_GRID_SIDE = 512  # path (e)'s profiled BFS and SSSP
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
    """K7's split form and the combine kernel, each against its plain
    version on the same inputs: every part's m within 1e-5 and its acc /
    l within (rtol, atol) (the parts are fp32; rtol is the output
    type's), and the combine within (rtol, atol) of the plain combine of
    the kernel's parts. With ``record``, time the combine."""
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
    if record is not None:
        ms = _timed(torch, lambda: K.attention_combine(acc, ml, q.dtype), 20)
        pms = _timed(torch, lambda: P.attention_combine(acc, ml, q.dtype), 5)
        nbytes = nsplit * sq * (d + 2) * 4 + sq * d * q.element_size()
        print(f"K7 attention_combine {nsplit} x ({sq}, {d}) -> {q.dtype}: "
              f"{ms:.4f} ms, plain {pms:.4f} ms, bound "
              f"{_bound_ms(nbytes, 0)[0]:.4f} ms")
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


def _fourth_slice_kernels(torch, np, K, P, tuner, SR, g, gs, dev, record):
    """K6, K7 and K8 against their plain versions at full width, timed
    beside one PyTorch library call and their bounds; every tuned kernel
    at every candidate block size. Returns the entry points' inputs for
    path (d)."""
    import torch.nn.functional as TF
    n, m = g.num_vertices, g.num_edges

    # K6 at rmat-22's whole-graph expansion: every vertex's out-degree
    sizes = g.degrees.to(torch.int32).contiguous()
    cap = tuner.pow2_ceil(m)
    slots = torch.arange(cap, dtype=torch.int32, device=dev)
    offsets = K.lb_offsets(sizes)
    prefix = offsets[:-1].contiguous()

    def k6():
        return K.lb_expand(sizes, cap)

    def p6():
        return P.lb_expand(K.lb_offsets(sizes), cap)

    def lib6():
        return torch.searchsorted(prefix, slots, right=True)

    got = k6()
    want = p6()
    for i, name in enumerate(("in_pos", "rank", "valid")):
        if not torch.equal(got[i], want[i]):
            raise AssertionError(f"lb_expand {name} differs from the plain "
                                 f"version")
    if int(got.total) != m or int(got.valid.sum()) != m or not torch.equal(
            lib6()[:m] - 1, got.in_pos[:m].long()):
        raise AssertionError("lb_expand differs from torch.searchsorted")
    del got, want
    ms, pms, lms = (_timed(torch, k6, 20), _timed(torch, p6, 5),
                    _timed(torch, lib6, 5))
    nbytes, ops = cap * 9 + (n + 1) * 4, cap * K._iters(n) * 4
    print(f"K6 lb_expand cap_in={n} cap_out={cap} total={m}: {ms:.3f} ms, "
          f"plain {pms:.3f} ms, torch.searchsorted {lms:.3f} ms, bound "
          f"{_bound_ms(nbytes, ops)[0]:.3f} ms; bit-equal on every slot")
    record("lb_expand", 0, ms, pms, nbytes, ops, lms)
    del slots, prefix, offsets
    torch.cuda.empty_cache()
    # a capacity that is no power of two, zero-size segments, cap_in = 0
    rng = np.random.default_rng(4)
    zs = torch.from_numpy(rng.integers(0, 9, 300_000).astype(np.int32))
    zs[torch.from_numpy(rng.random(300_000) < 0.4)] = 0
    for sz, c in ((sizes, m + 777_777), (zs.to(dev), 1_000_003),
                  (zs.to(dev), 999), (sizes[:0], 4097)):
        got = K.lb_expand(sz, c)
        want = P.lb_expand(K.lb_offsets(sz), c)
        if not all(torch.equal(a, b) for a, b in zip(got[:3], want)):
            raise AssertionError(f"lb_expand cap_in={sz.numel()} cap_out={c} "
                                 f"differs from the plain version")
    print("K6 lb_expand at cap_out = m + 777,777, on 40 % zero-size "
          "segments (cap_out 1,000,003 and 999) and at cap_in = 0: "
          "bit-equal to the plain version on every slot")

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
    nslots, filled = slot.numel(), int((slot >= 0).sum())
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
                      lambda: P.lb_expand(K.lb_offsets(
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
    want = P.lb_expand(K.lb_offsets(fourth["sizes"]), fourth["cap"])
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


def _fifth_slice_kernels(torch, np, K, P, O, F, G, S, SR, g, dev, record):
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
    def expand_group(label, plans, front, visited):
        """plans: (variant, graph, column bytes a slot, bytes a live input
        lane besides its 16) → {variant: {kernel: (ms, plain ms, bytes,
        operations)}}."""
        runs, out = {}, {}
        for variant, gr, col_bytes, lane_bytes in plans:
            store = gr.col_store
            base, sizes = O._base_and_sizes(gr, front.ids, front.valid_mask,
                                            "vertex")
            bl = int(base.shape[0])
            caps = F.tier_caps(gr.num_edges)
            cap = caps[F.tier_index(int(sizes.sum(dim=1).max()), caps)]
            live = int(front.lengths.sum())
            slots = int(torch.clamp(sizes.sum(dim=1), max=cap).sum())
            cap_v = gr.num_vertices
            iters = K._iters(cap_v)
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
                    live * (16 + lane_bytes) + slots * (col_bytes + 1)
                    + bl * cap_v * 8 + bl * 8,
                    slots * (iters * 4 + 8)),
                "advance_batch": (
                    lambda gr=gr, store=store, base=base, sizes=sizes,
                    cap=cap: K.advance_batch(gr.row_offsets, store, base,
                                             sizes, cap, gr.cache),
                    lambda gr=gr, store=store, base=base, sizes=sizes,
                    cap=cap: P.advance_batch(gr.row_offsets, store, base,
                                             sizes, cap),
                    live * (16 + lane_bytes) + slots * col_bytes
                    + bl * cap * 21 + bl * 4,
                    bl * cap * (iters * 4 + 8)),
            }
            K.reset_launches()
            for name, (kf, pf, _, _) in fns.items():
                for i, (x, y) in enumerate(zip(kf(), pf())):
                    if not torch.equal(x, y):
                        raise AssertionError(f"{name} ({variant}, {label}): "
                                             f"output {i} differs from the "
                                             f"plain version")
                if K.KERNELS[name].variants != {variant: 1}:
                    raise AssertionError(f"{name} on {label} ran "
                                         f"{K.KERNELS[name].variants}, not "
                                         f"{variant}")
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
        return F.compact_indices_batch(mask, nn, backend="torch"), visited

    # int32: 4 B a column; delta: 2 B a delta and a 4 B anchor a live lane
    front, visited = quarter(gg, 11)
    got = expand_group(f"grid {GRID_SIDE}",
                       (("int32", gg, 4, 0),
                        ("delta", graphs["grid-delta"], 2, 4)),
                       front, visited)
    for name, row in got["delta"].items():
        record(f"{name}:delta", 0, *row)
    front, visited = quarter(graphs["rmat15-int32"], 12)
    got = expand_group(f"rmat {INT16_SCALE}",
                       (("int32", graphs["rmat15-int32"], 4, 0),
                        ("int16", graphs["rmat15-int16"], 2, 0),
                        ("int64", graphs["rmat15-int64"], 8, 0)),
                       front, visited)
    for v in ("int16", "int64"):
        for name, row in got[v].items():
            record(f"{name}:{v}", 0, *row)
    # rmat-22's delta stream: escaped, so the dense fallback runs the int32
    # kernels on its decoded view
    front, visited = quarter(g, 13)
    expand_group("rmat 22 delta", ((
        "dense_fallback" if d22.col_store.num_escapes else "delta", d22, 4,
        0),), front, visited)
    del front, visited
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
    """Path (e): bfs_batch (push, pull, auto), sssp_batch and pagerank on
    the grid under dense int32 and delta and on rmat scale 15 under
    int16, int32 and int64, each equal bit for bit across its plans, the
    grid's against the oracles; triangle_count on rmat-15 int16 and int32;
    bfs_batch and sssp_batch on rmat-22's escaped delta stream (the dense
    fallback) and bf16 PageRank on rmat-22 against fp32. Returns the
    launch counts, in total and by variant, read where the run ends."""
    from repro_torch.core.primitives import (bfs_batch, pagerank, sssp_batch,
                                             triangle_count)
    gg = graphs["grid-int32"]
    ng = gg.num_vertices
    gsrc = [0, ng // 2 + GRID_SIDE // 2, 12345, ng - 1]
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
            t = time.monotonic()
            results[name, label] = fn(gr, srcs)
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
        R.pagerank_ref(gg, iters=20))
    if pr_rel > R.PR_RTOL:
        raise AssertionError(f"pagerank on the grid off the oracle by "
                             f"{pr_rel}")
    print(f"validated path (e): delta = int32 on the grid, int16 = int64 = "
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
    print(f"K4 spmv split: light rows ({int((~heavy_rows).sum())}, degree "
          f"<= {cw}) {split_ms['light']:.3f} ms, heavy rows "
          f"({int(heavy_rows.sum())}) {split_ms['heavy']:.3f} ms; byte "
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
          f"{int((~unsplit).sum())} split rows")

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
          f"{int(unsplit16.sum())} rows of at most {K.SPMM_SPLIT} edges")
    record("spmm", 0, ms, pms, nbytes, 2 * m16 * 32, lms)
    del a16, y_k, y_u, want_u, onehot, uniform, lp_args, lpu_args, cols16
    torch.cuda.empty_cache()

    # ---- phase 2 (d): the fourth slice's kernels, K6-K8, at full width,
    # and every tuned kernel at every block size ----
    t0 = time.monotonic()
    fourth = _fourth_slice_kernels(torch, np, K, P, tuner, SR, g, gs, dev,
                                   record)
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
    graphs5 = _fifth_slice_kernels(torch, np, K, P, O, F, G, S, SR, g, dev,
                                   record)
    print(f"storage-plan kernels checked and timed in "
          f"{time.monotonic() - t0:.1f} s")

    # ---- phase 3 (e): the fifth slice's path: the storage plans on the
    # cuda backend (the grid dense and delta, rmat-15 int16 / int32 /
    # int64, rmat-22 delta, bf16 PageRank) ----
    t0 = time.monotonic()
    launches5, variants5 = _fifth_slice_path(torch, np, K, R, G, S,
                                             graphs5, g, sources, dev)
    tally(variants5)
    print(f"path (e) run and validated in {time.monotonic() - t0:.1f} s")

    # ---- where the time goes: each slice's path once more under
    # torch.profiler (its overhead inflates the wall time; the device
    # time per kernel is what it is for) ----
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def profiled(label, fn, top, host_ops=True):
        """``host_ops=False`` traces the device alone (its busy time is
        all this reads), for a run of many thousand steps whose host
        events the profiler cannot summarise within the time limit."""
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

    # path (e) takes ~14,000 BSP steps at side 2048; its breakdown is
    # taken on the delta grid of side PROFILE_GRID_SIDE (~3,500 steps),
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
    del g_tc, g16, graphs5, g_prof

    # each kernel, then the column or precision variants this slice timed
    # as rows of their own, launches those of the main path's run
    kernels = []
    for name, k in K.KERNELS.items():
        kernels.append({"name": name, "route": "cuda", "source": k.source,
                        "replaces": k.replaces,
                        "launches": (launches[name] + launches2[name]
                                     + launches3[name] + launches4[name]
                                     + launches5[name]),
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
