"""K7c (attention_combine) and the split-form ``flash_attention`` call
at the 128-query chunk and at prefill, measured apart: the kernel's own
device time, the wrapper's host time and the whole call, for one tree
or two.

  python tools/attention_combine_ab.py [BASE_DIR] [--pairs 5] [--reps 200]
      [--splits 16,32] [--host-parts]

BASE_DIR is another checkout (for example the parent commit, unpacked
with ``git archive`` under ``build/``); without it only this tree is
measured. One worker process per tree imports that tree's
``repro_torch`` (``PYTHONPATH=<tree>/src``) and makes the same inputs
from the same seed, as ``chip_smoke.py`` makes them: a causal chunk of
128 queries against 8,192 keys (64 kv parts in bf16, 128 in fp32) and
a causal prefill of 8,192 (3 parts), at the head widths of Qwen2-VL-2B
(128) and Kimi K2 (112), in bf16 and fp32, with the parts of K7's split
form. Each worker checks the combine and the whole call
against the plain versions, then answers, for every case:

  * ``comb_ev``: the combine by CUDA events over ``--reps`` calls of its
    Python wrapper (``chip_smoke.py``'s way; the wrapper's host time is
    in it when the host is slower than the card);
  * ``comb_dev``: one combine launch's device time, by ``torch.profiler``
    over ``--reps`` launches of the C entry point called directly;
  * ``comb_graph``: the same launches captured in a CUDA graph and
    replayed, by events, per launch (back to back, no host in between);
  * ``comb_host``: the wrapper's host time per call with its kernel
    launch stubbed out (host clock over ``--reps`` calls), and
    ``ctypes_host`` the C entry point alone at Sq = 0 (it returns before
    launching);
  * ``call_ev``: the whole ``flash_attention`` call by events;
    ``call_graph`` the same calls captured in a CUDA graph and replayed
    (the call's time on the card without the host); ``call_dev`` /
    ``k7_dev`` / ``comb_in_call`` its device time by kernel
    (``torch.profiler``; under a programmatic dependent launch the
    combine's record starts while K7's last blocks run, so the two
    overlap); ``call_host`` the call's host time with its launches
    stubbed out, ``call_enq`` with them (host clock, no synchronisation
    inside: the time to enqueue a call);
  * ``sdpa``: ``scaled_dot_product_attention`` on the same inputs with
    the end-aligned mask (its own causal mask at prefill), by events.

The workers take turns, base first in even pairs. Prints every pair and
the medians of each tree. ``--host-parts`` also times, in this tree,
each host piece of the split-form call (its input checks, the split
count, the allocations, the stream and pointer arguments, the C call
that returns at once, the C call that launches, the whole call).
``--splits`` also times this tree's whole call at the chunk
with the kv axis cut into each listed number of parts (the choice of
``attention_splits`` is 64 in bf16 and 128 in fp32 here), by events and
from a CUDA graph, medians of ``--pairs`` rounds.
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
# (label, Sq, Sk), causal: chip_smoke.py's chunk and prefill
SHAPES = (("chunk", 128, 8192), ("prefill", 8192, 8192))
HEADS = (128, 112)             # Qwen2-VL-2B, Kimi K2
DTYPES = ("bfloat16", "float32")
METRICS = ("comb_ev", "comb_dev", "comb_graph", "comb_host", "ctypes_host",
           "call_ev", "call_graph", "call_dev", "k7_dev", "comb_in_call",
           "call_host", "call_enq", "sdpa")


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def worker(reps: int) -> None:
    """Make and check the cases, then answer each line of standard input
    (``measure`` or ``splits N``) with one JSON line."""
    import ctypes
    import math

    import torch
    import torch.nn.functional as TF
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops as K
    from repro_torch.kernels import ref as P
    from repro_torch.kernels import runtime

    print(f"worker: {K.__file__}", file=sys.stderr, flush=True)
    dev = torch.device("cuda")
    stream = runtime.stream_ptr(dev)
    comb_c = K._fn("attention", "attention_combine")
    cases = {}
    gen = torch.Generator(device=dev).manual_seed(2)
    for (label, sq, sk), head, name in itertools.product(SHAPES, HEADS,
                                                         DTYPES):
        dtype = getattr(torch, name)
        q, k, v = (torch.randn((r, head), generator=gen,
                               device=dev).to(dtype)
                   for r in (sq, sk, sk))
        nsplit = K.attention_splits(sq, sk, dtype, K.sm_count(dev))
        acc, ml = K.attention_partials(q, k, v, True, nsplit)
        out = K.attention_combine(acc, ml, dtype)
        if not torch.allclose(out.float(), P.attention_combine(
                acc, ml, dtype).float(), rtol=8e-3, atol=1e-4):
            raise AssertionError(f"{label} combine D={head} {name} off "
                                 f"its plain version")
        got = K.flash_attention(q, k, v, causal=True)
        if not torch.allclose(got.float(), P.flash_attention(
                q, k, v, True).float(), rtol=8e-3, atol=1e-4):
            raise AssertionError(f"{label} flash_attention D={head} {name} "
                                 f"off its plain version")
        # SDPA's own causal mask where it is the end-aligned one (sq ==
        # sk), as chip_smoke.py passes it; else the mask as a tensor
        mask = None if sq == sk else (
            torch.arange(sk, device=dev)[None, :]
            <= torch.arange(sq, device=dev)[:, None] + (sk - sq))
        args = (K._ATTN_DTYPES[dtype], runtime.ptr(acc),
                runtime.ptr(ml), runtime.ptr(out), sq, head, nsplit,
                stream)
        cases[f"{label}_D{head}_{name}"] = dict(
            q=q, k=k, v=v, acc=acc, ml=ml, out=out, dtype=dtype,
            nsplit=nsplit, mask=mask, args=args)
    print(json.dumps({c: x["nsplit"] for c, x in cases.items()}),
          file=sys.stderr, flush=True)

    def events(fn, n=reps):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n

    def host_us(fn):
        """Host microseconds a call with every kernel launch stubbed."""
        real = K._launch
        K._launch = lambda *a: None
        try:
            fn()
            # reprolint: disable=RL004 -- host time, every launch stubbed
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            return (time.perf_counter() - t0) / reps * 1e6
        finally:
            K._launch = real

    def device_ms(fn):
        """{kernel name: device ms per call} over ``reps`` calls."""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        return {e.key: e.self_device_time_total / 1e3 / reps
                for e in prof.key_averages()
                if e.self_device_time_total > 0}

    def graph_ms(fn):
        """ms per launch of ``reps`` launches replayed from a CUDA graph."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        return events(graph.replay, 5) / reps

    def measure():
        res = {}
        for key, c in cases.items():
            acc, ml, dtype = c["acc"], c["ml"], c["dtype"]
            q, k, v = c["q"], c["k"], c["v"]
            q4, k4, v4 = q[None, None], k[None, None], v[None, None]

            def launch_c(args=c["args"]):
                code = comb_c(*args)
                if code:
                    raise RuntimeError(f"attention_combine: CUDA {code}")

            def launch_graph(c=c):
                a = list(c["args"])
                a[-1] = runtime.stream_ptr(dev)
                launch_c(tuple(a))

            zero = list(c["args"])
            zero[4] = 0
            zero = tuple(zero)

            def call():
                return K.flash_attention(q, k, v, causal=True)

            def comb():
                return K.attention_combine(acc, ml, dtype)

            r = {"nsplit": c["nsplit"]}
            r["comb_ev"] = events(comb)
            rows = device_ms(launch_c)
            r["comb_dev"] = sum(ms for n, ms in rows.items()
                                if "attn_combine" in n)
            try:
                r["comb_graph"] = graph_ms(launch_graph)
            except RuntimeError as exc:
                print(f"graph capture refused: {exc}", file=sys.stderr,
                      flush=True)
                r["comb_graph"] = math.nan
            r["comb_host"] = host_us(comb)
            t0 = time.perf_counter()
            for _ in range(reps):
                comb_c(*zero)
            r["ctypes_host"] = (time.perf_counter() - t0) / reps * 1e6
            r["call_ev"] = events(call)
            r["call_graph"] = graph_ms(call)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                call()
            r["call_enq"] = (time.perf_counter() - t0) / reps * 1e6
            torch.cuda.synchronize()
            rows = device_ms(call)
            r["call_dev"] = sum(rows.values())
            r["k7_dev"] = sum(ms for n, ms in rows.items()
                              if "attn_kernel" in n)
            r["comb_in_call"] = sum(ms for n, ms in rows.items()
                                    if "attn_combine" in n)
            r["call_host"] = host_us(call)
            r["sdpa"] = events(lambda: TF.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=c["mask"], is_causal=c["mask"] is None))
            res[key] = r
        return res

    def splits(n):
        real = K.attention_splits
        K.attention_splits = lambda *a: n
        try:
            out = {}
            for key, c in cases.items():
                if not key.startswith("chunk"):
                    continue
                q, k, v = c["q"], c["k"], c["v"]
                got = K.flash_attention(q, k, v, causal=True)
                if not torch.allclose(got.float(), P.flash_attention(
                        q, k, v, True).float(), rtol=8e-3, atol=1e-4):
                    raise AssertionError(f"{key} at {n} parts off the "
                                         f"plain version")
                def call(q=q, k=k, v=v):
                    return K.flash_attention(q, k, v, causal=True)

                out[key] = [events(call), graph_ms(call)]
            return out
        finally:
            K.attention_splits = real

    def host_parts():
        """Host microseconds of each piece of this tree's split-form call
        at D = 128 in bf16 (host clock over ``reps``; ``launch`` and
        ``call`` enqueue real work and synchronise only after the loop)."""
        c = cases["chunk_D128_bfloat16"]
        q, k, v, nsplit = c["q"], c["k"], c["v"], c["nsplit"]
        code, sq, sk, d, *_ = K._attention_inputs(q, k, v)
        out = torch.empty((sq, d), dtype=q.dtype, device=dev)
        acc, ml = K._attention_workspace(nsplit, sq, d, dev)
        fn = K._fn("attention", "flash_attention_split")
        args = [code, *(runtime.ptr(t) for t in (q, k, v, out, acc, ml)),
                sq, sk, d, ctypes.c_float(1.0 / math.sqrt(d)), 1, nsplit,
                stream]
        idle = list(args)
        idle[7] = 0                     # Sq = 0: the C call returns at once
        parts = {
            "inputs": lambda: K._attention_inputs(q, k, v),
            "splits": lambda: K.attention_splits(sq, sk, q.dtype,
                                                 K.sm_count(dev)),
            "alloc_out": lambda: torch.empty((sq, d), dtype=q.dtype,
                                             device=dev),
            "alloc_ws": lambda: K._attention_workspace(nsplit, sq, d, dev),
            "stream": lambda: runtime.stream_ptr(dev),
            "ptrs": lambda: [runtime.ptr(t) for t in (q, k, v, out, acc,
                                                      ml)],
            "ctypes_sq0": lambda: fn(*idle),
            "launch": lambda: fn(*args),
            "call": lambda: K.flash_attention(q, k, v, causal=True),
        }
        res = {}
        for name, f in parts.items():
            f()
            torch.cuda.synchronize()
            # reprolint: disable=RL004 -- host time of each part of a call
            t0 = time.perf_counter()
            for _ in range(reps):
                f()
            res[name] = (time.perf_counter() - t0) / reps * 1e6
            torch.cuda.synchronize()
        return res

    print("ready", flush=True)
    for line in sys.stdin:
        words = line.split()
        if words[0] == "measure":
            print(json.dumps(measure()), flush=True)
        elif words[0] == "hostparts":
            print(json.dumps(host_parts()), flush=True)
        else:
            print(json.dumps(splits(int(words[1]))), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("base", type=Path, nargs="?")
    ap.add_argument("--pairs", type=int, default=5)
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--splits", default="")
    ap.add_argument("--host-parts", action="store_true")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        worker(args.reps)
        return 0
    print(f"card: {_smi()}", flush=True)
    trees = [("change", HERE)]
    if args.base is not None:
        trees.insert(0, ("base", args.base))
    procs = {}
    for label, root in trees:
        env = dict(os.environ, PYTHONPATH=str(root.resolve() / "src"))
        procs[label] = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--worker",
             "--reps", str(args.reps)], stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, text=True, env=env, cwd=root)

    def ask(label, line):
        p = procs[label]
        p.stdin.write(line + "\n")
        p.stdin.flush()
        return json.loads(p.stdout.readline())

    runs = {label: [] for label in procs}
    split_runs: dict = {}
    host_runs: list = []
    try:
        for label, p in procs.items():
            if p.stdout.readline().strip() != "ready":
                raise SystemExit(f"{label} worker failed")
        for i in range(args.pairs):
            order = list(procs) if i % 2 == 0 else list(procs)[::-1]
            for label in order:
                res = ask(label, "measure")
                runs[label].append(res)
                for case, r in res.items():
                    print(f"pair {i} {label:6s} {case:12s} " + ", ".join(
                        f"{m} {r[m]:.5g}" for m in ("nsplit",) + METRICS),
                        flush=True)
            for n in [int(s) for s in args.splits.split(",") if s]:
                res = ask("change", f"splits {n}")
                for case, ms in res.items():
                    split_runs.setdefault((case, n), []).append(ms)
                print(f"pair {i} change splits {n}: " + ", ".join(
                    f"{c} {ev:.5f} / {gr:.5f}"
                    for c, (ev, gr) in res.items()), flush=True)
            if args.host_parts:
                host_runs.append(ask("change", "hostparts"))
                print(f"pair {i} change host parts (us): " + ", ".join(
                    f"{k} {x:.2f}" for k, x in host_runs[-1].items()),
                    flush=True)
    finally:
        for p in procs.values():
            p.stdin.close()
            p.wait(timeout=120)
    print("medians (ms; *_host in us):")
    for label, rs in runs.items():
        for case in rs[0]:
            print(f"  {label:6s} {case:12s} " + ", ".join(
                f"{m} {statistics.median(r[case][m] for r in rs):.5g}"
                for m in METRICS), flush=True)
    if host_runs:
        print("  change host parts (us), chunk_D128_bfloat16: " + ", ".join(
            f"{k} {statistics.median(r[k] for r in host_runs):.2f}"
            for k in host_runs[0]))
    for (case, n), v in sorted(split_runs.items()):
        print(f"  splits {n:4d} {case:12s} call_ev "
              f"{statistics.median(x[0] for x in v):.5f}, call_graph "
              f"{statistics.median(x[1] for x in v):.5f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
