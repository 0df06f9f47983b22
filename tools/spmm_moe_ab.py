"""A/B of K4m (spmm) and K8 (moe_gather) between two checkouts of this
repo on one card, at the shapes of ``chip_smoke.py``.

  python tools/spmm_moe_ab.py BASE_DIR [--pairs 10] [--lp-pairs 2]

BASE_DIR is another checkout (for example the parent commit, unpacked
with ``git archive``). One worker process per tree imports that tree's
``repro_torch`` (``PYTHONPATH=<tree>/src``) and makes the same inputs
from the same seeds: label propagation's shape (``rmat(16, 16, seed=0,
weighted)``, k = 32: the one-hot block of the first 32 labels,
uniform floats in fp32 and in bf16 precision) and Kimi K2's MoE
dispatch (8192 x 7168 bf16 tokens, 384 experts x capacity 216, the
seeded top-8 routing of ``chip_smoke.py``). The workers take turns, base
first in even pairs: each case is the mean of ``--reps`` calls by CUDA
events after a warm-up call (K8's time includes its wrapper's sort).
``lp`` is one ``label_propagation`` of 30 iterations on the host clock,
timed in the first ``--lp-pairs`` pairs. Each worker checks its results
against the plain versions first. Yardsticks, in the change's worker:
``torch.sparse.mm`` and ``torch.index_select(X, 0, cols)`` (the m rows
of X that K4m gathers, written out) at LP's shape, and
``torch.index_select`` for K8. Prints every run, then per case the
median of each tree and of the change-minus-base differences; with
``--profile``, each tree's device time per call by kernel name for every
case (``torch.profiler`` over ``--reps`` calls), which tells the
kernels' own time from the wrappers' host time.
"""
from __future__ import annotations

import argparse
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
CASES = ("k4m_onehot", "k4m_uniform", "k4m_bf16", "k8", "lp")
YARDSTICKS = ("sparse_mm", "gather_rows", "k8_index_select")


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def worker(reps: int) -> None:
    """Make the inputs, check and warm every case, then time the case
    named on each line of standard input and answer with its ms."""
    import torch
    from repro_torch.core import graph as G
    from repro_torch.core.primitives import label_propagation
    from repro_torch.kernels import ops as K
    from repro_torch.kernels import ref as P
    from repro_torch.linalg import semiring as SR

    print(f"worker: {K.__file__}", file=sys.stderr, flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    g = G.rmat(16, 16, seed=0, weighted=True, device=dev)
    n, m = g.num_vertices, g.num_edges
    lanes = torch.arange(32, dtype=torch.int32, device=dev)
    onehot = (torch.arange(n, dtype=torch.int32, device=dev)[:, None]
              == lanes[None, :]).to(torch.float32)
    uniform = torch.rand((n, 32), generator=gen, device=dev)
    base = (g.row_offsets, g.col_indices, None)
    rest = (g.ell_width, None, g.row_seg)
    bf16 = SR.with_precision(SR.plus_times, "bf16")
    a16 = torch.sparse_csr_tensor(g.row_offsets, g.col_indices,
                                  torch.ones(m, device=dev), size=(n, n))
    cols = g.col_indices.long()

    tokens, d_model, experts, top_k = 8192, 7168, 384, 8
    cap = max(8 * math.ceil(math.ceil(tokens * top_k / experts * 1.25) / 8),
              8)
    scores = torch.rand((tokens, experts), generator=gen, device=dev)
    expert = torch.topk(scores, top_k, dim=1).indices.reshape(-1)
    token = torch.arange(tokens, device=dev).repeat_interleave(top_k)
    order = torch.sort(expert, stable=True).indices
    expert, token = expert[order], token[order]
    counts = torch.bincount(expert, minlength=experts)
    rank = torch.arange(expert.numel(), device=dev) - (
        torch.cumsum(counts, 0) - counts)[expert]
    keep = rank < cap
    slot = torch.full((experts * cap,), -1, dtype=torch.int32, device=dev)
    slot[(expert * cap + rank)[keep]] = token[keep].to(torch.int32)
    x = torch.randn((tokens, d_model), generator=gen,
                    device=dev).to(torch.bfloat16)
    xz = torch.cat([x, x.new_zeros((1, d_model))])
    idx = torch.where(slot < 0, tokens, slot).long()

    run = {
        "k4m_onehot": lambda: K.spmm(*base, onehot, SR.plus_times, *rest),
        "k4m_uniform": lambda: K.spmm(*base, uniform, SR.plus_times, *rest),
        "k4m_bf16": lambda: K.spmm(*base, uniform, bf16, *rest),
        "k8": lambda: K.moe_gather(x, slot),
        "sparse_mm": lambda: torch.sparse.mm(a16, uniform),
        "gather_rows": lambda: torch.index_select(uniform, 0, cols),
        "k8_index_select": lambda: torch.index_select(xz, 0, idx),
    }
    plain = {
        "k4m_onehot": lambda: P.spmm(*base, onehot, SR.plus_times, *rest),
        "k4m_uniform": lambda: P.spmm(*base, uniform, SR.plus_times, *rest),
        "k4m_bf16": lambda: P.spmm(*base, uniform, bf16, *rest),
        "k8": lambda: P.moe_gather(x, slot),
    }
    for name, fn in plain.items():
        got, want = run[name](), fn()
        if name == "k4m_onehot" or name == "k8":
            ok = torch.equal(got, want)
        else:       # the plain version's atomic adds regroup float sums
            ok = torch.allclose(got, want, rtol=1e-5, atol=1e-5)
        if not ok:
            raise AssertionError(f"{name} differs from its plain version")

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

    def lp():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        label_propagation(g, backend="cuda")
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    def profile(name):
        from torch.profiler import ProfilerActivity, profile as prof
        run[name]()
        torch.cuda.synchronize()
        with prof(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as pr:
            for _ in range(reps):
                run[name]()
            torch.cuda.synchronize()
        rows = [(e.key, e.device_time_total / reps, e.count / reps)
                for e in pr.key_averages() if e.device_time_total > 0]
        rows.sort(key=lambda r: -r[1])
        return "; ".join(f"{k[:60]} {us:.1f} us x{c:g}" for k, us, c in
                         rows[:6] if c >= 1)

    print(f"n={n} m={m} slots={slot.numel()} "
          f"filled={int((slot >= 0).sum())}", file=sys.stderr, flush=True)
    print("ready", flush=True)
    for line in sys.stdin:
        name = line.strip()
        if name.startswith("profile "):
            print(profile(name.split()[1]), flush=True)
            continue
        print(f"{lp() if name == 'lp' else timed(run[name]):.4f}",
              flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("base", type=Path, nargs="?")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--lp-pairs", type=int, default=2)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        worker(args.reps)
        return 0
    if args.base is None:
        ap.error("BASE_DIR is required")
    print(f"card: {_smi()}", flush=True)
    procs = {}
    for label, root in (("base", args.base), ("change", HERE)):
        env = dict(os.environ, PYTHONPATH=str(root.resolve() / "src"))
        procs[label] = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--worker",
             "--reps", str(args.reps)], stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, text=True, env=env, cwd=root)

    def ask(label, name):
        p = procs[label]
        p.stdin.write(name + "\n")
        p.stdin.flush()
        line = p.stdout.readline()
        return line.strip() if name.startswith("profile ") else float(line)

    try:
        for label, p in procs.items():
            if p.stdout.readline().strip() != "ready":
                raise SystemExit(f"{label} worker failed")
        runs = {(t, c): [] for t in procs for c in CASES}
        for i in range(args.pairs):
            order = ("base", "change") if i % 2 == 0 else ("change", "base")
            for name in CASES:
                if name == "lp" and i >= args.lp_pairs:
                    continue
                for label in order:
                    ms = ask(label, name)
                    runs[(label, name)].append(ms)
                    print(f"pair {i:2d} {label:6s} {name:11s} {ms:10.4f} ms",
                          flush=True)
        for name in YARDSTICKS:
            print(f"yardstick {name:15s} {ask('change', name):10.4f} ms",
                  flush=True)
        if args.profile:
            for name in CASES[:-1] + YARDSTICKS:
                for label in procs:
                    if name in YARDSTICKS and label == "base":
                        continue
                    print(f"profile {label:6s} {name:15s} "
                          f"{ask(label, 'profile ' + name)}", flush=True)
    finally:
        for p in procs.values():
            p.stdin.close()
            p.wait(timeout=120)
    for name in CASES:
        b, c = runs[("base", name)], runs[("change", name)]
        if not b:
            continue
        diff = [y - x for x, y in zip(b, c)]
        print(f"{name:11s} median base {statistics.median(b):.4f} ms, "
              f"change {statistics.median(c):.4f} ms, change - base "
              f"{statistics.median(diff):+.4f} ms (pairs {len(diff)}, "
              f"change slower in {sum(d > 0 for d in diff)})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
