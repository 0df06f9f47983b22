"""K5's design steps on one card: variants of the kernel
(``src/repro_torch/kernels/csrc/search.cu``) and of the two measured
shared-memory designs (``tools/search_variants/``), each a copy of its
source with one change, built side by side and timed in turns on K5's
shapes in one process.

  PYTHONPATH=src python tools/search_steps.py [--tree NAME=DIR ...]
      [--rounds 5] [--reps 10] [--variants this,lanes2] [--shapes tc18]

Variants (``build/search_steps/<name>/``, one ``nvcc`` each, all started
together; every one at 256 threads a block):

  * ``this``: the kernel as it is (4 lanes a thread, 1,536 threads an
    SM); ``lanes1`` / ``lanes2`` / ``lanes8``: 1, 2 or 8 lanes a thread;
    ``sm2048`` / ``sm1024``: 2,048 (32 registers) or 1,024 (64) threads
    an SM; ``clamp_always``: the clamp on every read;
  * ``tiles``: one block a tile of 2,048 lanes, each run's segment or its
    top tree levels staged in 16 KB of shared memory
    (``search_variants/tiles.cu``); ``tiles_stage0`` a 0-byte budget,
    ``tiles_trees_only`` / ``tiles_staged_only`` without whole segments /
    without trees, ``tiles_lanes4`` tiles of 1,024 lanes,
    ``tiles_budget8k`` / ``tiles_budget32k``, ``tiles_plain_stores`` one
    store a lane;
  * ``warp_stage``: warp chunks of 4 rows, a row of 32 lanes sharing a
    segment staged in its warp's region, 16 KB a block
    (``search_variants/warp_stage.cu``); ``warp_stage0`` no staging,
    ``warp_stage8k`` / ``warp_stage32k``;
  * ``--tree NAME=DIR``: DIR's ``search.cu`` (for example the parent
    commit, unpacked with ``git archive``).

Shapes: ``tc18`` K5 locate at triangle counting's mxm probes on rmat
scale 18 (659,157,569 lanes); ``found22`` K5 found on
segmented_intersect's probes of random edge pairs of rmat-22 (as many as
keep the expansion at 3e8 lanes; chip_smoke.py's); ``subgraph16`` K5
found at subgraph_match's join on rmat-16 (the triangle query's one
probe launch, its inputs taken from a run of subgraph_match);
``tc15_int16`` / ``tc15_int32`` / ``tc15_int64`` K5 locate at rmat-15's
mxm probes over the three column dtypes. Every variant's output must
equal ``this`` one's on every lane, and ``this`` one its plain version
on each shape's first 2^24 lanes. Each time is the mean of ``--reps``
calls by CUDA events; each variant's median over ``--rounds`` rounds,
the order rotated each round, is printed beside ``this`` one's.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
CSRC = HERE / "src" / "repro_torch" / "kernels" / "csrc"
ALT = HERE / "tools" / "search_variants"
OUT = HERE / "build" / "search_steps"
THREADS = 256
TRIANGLE = [(0, 1), (0, 2), (1, 2)]

KERNEL, TILES, WARP = (CSRC / "search.cu", ALT / "tiles.cu",
                       ALT / "warp_stage.cu")
LANES = "constexpr int kSearchLanes = 4;"
SM = "constexpr int kSearchSmThreads = 1536;"
# name: (source, edits, staging bytes or None where the source takes none)
VARIANTS = {
    "this": (KERNEL, [], None),
    "lanes1": (KERNEL, [(LANES, LANES.replace("4", "1"))], None),
    "lanes2": (KERNEL, [(LANES, LANES.replace("4", "2"))], None),
    "lanes8": (KERNEL, [(LANES, LANES.replace("4", "8"))], None),
    "sm2048": (KERNEL, [(SM, SM.replace("1536", "2048"))], None),
    "sm1024": (KERNEL, [(SM, SM.replace("1536", "1024"))], None),
    "clamp_always": (KERNEL, [("    if (__all_sync(kFull, inside)) {",
                               "    if (false) {")], None),
    "tiles": (TILES, [], 16384),
    "tiles_stage0": (TILES, [], 0),
    "tiles_trees_only": (TILES, [("constexpr int kStageRatio = 8;",
                                  "constexpr int kStageRatio = 0;")], 16384),
    "tiles_staged_only": (TILES, [
        ("  return min(31 - __clz(c + 1), steps_of(len));",
         "  return 0;")], 16384),
    "tiles_lanes4": (TILES, [("constexpr int kSearchLanes = 8;",
                              "constexpr int kSearchLanes = 4;")], 16384),
    "tiles_budget8k": (TILES, [], 8192),
    "tiles_budget32k": (TILES, [], 32768),
    "tiles_plain_stores": (TILES, [("  if (full) {\n    store_lanes<V>(",
                                    "  if (false) {\n    store_lanes<V>(")],
                           16384),
    "warp_stage": (WARP, [], 16384),
    "warp_stage0": (WARP, [], 0),
    "warp_stage8k": (WARP, [], 8192),
    "warp_stage32k": (WARP, [], 32768),
}
SHAPES = ("tc18", "found22", "subgraph16", "tc15_int16", "tc15_int32",
          "tc15_int64")


def _build(names, trees):
    """Each variant's source under OUT/<name>/, then one nvcc each, all
    started together → {name: library path}."""
    from repro_torch.kernels import runtime
    procs = {}
    for name in names:
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        if name in trees:
            src = trees[name] / "src" / "repro_torch" / "kernels" / "csrc"
            text = (src / "search.cu").read_text()
            inc = src
        else:
            path, edits, _ = VARIANTS[name]
            text, inc = path.read_text(), CSRC
            for old, new in edits:
                if text.count(old) != 1:
                    raise SystemExit(f"variant {name}: {old!r} not found "
                                     f"once in {path.name}")
                text = text.replace(old, new)
        cu = d / "search.cu"
        cu.write_text(text)
        lib = d / "libsearch.so"
        procs[name] = (lib, subprocess.Popen(
            [runtime._nvcc(), *runtime.NVCC_FLAGS, "-I", str(inc), "-o",
             str(lib), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, p) in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"variant {name} failed to build:\n{out}")
        libs[name] = lib
    return libs


def _bind(path: Path, staged: bool):
    """The library's two entry points; ``staged`` ones take the staging
    budget after the block size."""
    lib = ctypes.CDLL(str(path))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fns = {}
    for mode in ("found", "locate"):
        fn = getattr(lib, f"segment_search_{mode}")
        fn.argtypes = ([P, I, I] + [P] * 3 + [L, P, I]
                       + ([I] if staged else []) + [P])
        fn.restype = ctypes.c_int
        fns[mode] = fn
    return fns


def _shapes(torch, names):
    """{name: (haystack, lo, hi, needles, locate)} on the card."""
    import numpy as np
    from repro_torch.core import frontier as F
    from repro_torch.core import graph as G
    from repro_torch.core import operators as O
    from repro_torch.core import backend as B
    from repro_torch.core.primitives import subgraph_match, triangle_count
    from repro_torch.kernels import ops as K
    from repro_torch.linalg import ops as L
    tc = importlib.import_module("repro_torch.core.primitives.tc")
    dev = torch.device("cuda")
    out = {}

    def mxm_probes(g, dtype=None):
        sub, ssrc, sdst = tc._orient(g)
        (a_off, a_idx, _), (bt_off, bt_idx, _), base, probe, cap = (
            L.mxm_plan(sub, sub, (ssrc, sdst), b_transpose=True))
        sizes = (torch.index_select(a_off, 0, base + 1)
                 - torch.index_select(a_off, 0, base)).to(torch.int32)
        _, needles, _, pair, _, _, _ = K.advance(a_off, a_idx, base, sizes,
                                                 cap)
        rows = torch.index_select(probe, 0, pair)
        del pair
        lo = torch.index_select(bt_off, 0, rows)
        hi = torch.index_select(bt_off, 0, rows + 1)
        hay = bt_idx if dtype is None else bt_idx.to(dtype)
        return hay.contiguous(), lo, hi, needles, True

    if "tc18" in names:
        out["tc18"] = mxm_probes(G.rmat(18, 16, seed=0, weighted=True,
                                        device=dev))
    for dt in ("int16", "int32", "int64"):
        if f"tc15_{dt}" in names:
            g15 = G.rmat(15, 16, seed=0, weighted=True, device=dev)
            out[f"tc15_{dt}"] = mxm_probes(g15, getattr(torch, dt))
    if "found22" in names:
        g = G.rmat(22, 16, seed=0, weighted=True, device=dev)
        rng = np.random.default_rng(1)
        e_ids = torch.from_numpy(rng.integers(0, g.num_edges,
                                              1 << 20)).to(dev)
        pu = torch.index_select(g.row_seg, 0, e_ids)
        pv = torch.index_select(g.col_indices, 0, e_ids)
        mins = torch.minimum(g.degrees[pu.long()], g.degrees[pv.long()])
        npairs = int((torch.cumsum(mins.long(), 0, dtype=torch.int64)
                      <= 3 * 10 ** 8).sum(dtype=torch.int64))
        need = int(mins[:npairs].sum())
        length = torch.tensor(npairs, dtype=torch.int32, device=dev)
        fa = F.SparseFrontier(ids=pu[:npairs].contiguous(), length=length)
        fb = F.SparseFrontier(ids=pv[:npairs].contiguous(), length=length)
        needles, lo, hi, _, _ = O._intersect_probes(g, fa, fb, need, "cuda")
        out["found22"] = (g.col_indices, lo, hi, needles, False)
    if "subgraph16" in names:
        g16 = G.rmat(16, 16, seed=0, weighted=True, device=dev)
        cap = max(6 * int(triangle_count(g16, backend="cuda").total),
                  g16.num_edges)
        out["subgraph16"] = (*join_probe(B, subgraph_match, g16, cap),
                             False)
    return out


def join_probe(B, subgraph_match, g16, cap):
    """(haystack, lo, hi, needles) of the K5 launch of subgraph_match's
    triangle query on ``g16``: the join's one probe, kept from a run."""
    key = ("segment_search", "cuda", "single")
    real = B._REGISTRY[key]
    seen = []

    def spy(hay, lo, hi, needles, **kw):
        seen.append((hay, lo, hi, needles))
        return real(hay, lo, hi, needles, **kw)

    B._REGISTRY[key] = spy
    try:
        subgraph_match(g16, 3, TRIANGLE, cap=cap, backend="cuda")
    finally:
        B._REGISTRY[key] = real
    if len(seen) != 1:
        raise AssertionError(f"subgraph_match made {len(seen)} K5 calls")
    return seen[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="NAME=DIR: DIR's search.cu as variant NAME")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--variants", default="")
    ap.add_argument("--shapes", default=",".join(SHAPES))
    args = ap.parse_args(argv)
    import torch
    from repro_torch.kernels import ops as K
    from repro_torch.kernels import ref as P
    from repro_torch.kernels import runtime
    if not torch.cuda.is_available():
        raise SystemExit("search_steps.py: no CUDA device")
    trees = {k: Path(v) for k, v in (t.split("=", 1) for t in args.tree)}
    names = ([v for v in args.variants.split(",") if v]
             or list(VARIANTS) + list(trees))
    if "this" not in names:
        names.insert(0, "this")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    libs = _build(names, trees)
    stage = {n: VARIANTS[n][2] if n in VARIANTS else None for n in names}
    fns = {n: _bind(libs[n], stage[n] is not None) for n in names}
    shapes = _shapes(torch, [s for s in args.shapes.split(",") if s])
    dev = torch.device("cuda")
    stream = runtime.stream_ptr(dev)

    def call(name, hay, lo, hi, needles, locate):
        cap = int(needles.shape[0])
        out = torch.empty((cap,), device=dev,
                          dtype=torch.int32 if locate else torch.bool)
        kind = {torch.int32: 0, torch.int16: 1, torch.int64: 2}[hay.dtype]
        extra = [] if stage[name] is None else [stage[name]]
        code = fns[name]["locate" if locate else "found"](
            hay.data_ptr(), kind, int(hay.shape[0]), lo.data_ptr(),
            hi.data_ptr(), needles.data_ptr(), cap, out.data_ptr(), THREADS,
            *extra, stream)
        if code:
            raise RuntimeError(f"{name}: CUDA error {code}")
        return out

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(args.reps):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / args.reps

    for shape, (hay, lo, hi, needles, locate) in shapes.items():
        cap = int(needles.shape[0])
        want = call("this", hay, lo, hi, needles, locate)
        head = slice(0, min(cap, 1 << 24))
        plain = (P.segment_locate if locate else P.segment_search)(
            hay, lo[head], hi[head], needles[head])
        if not torch.equal(want[head], plain):
            raise AssertionError(f"{shape}: this kernel differs from the "
                                 f"plain version")
        del plain
        for name in names:
            if not torch.equal(call(name, hay, lo, hi, needles, locate),
                               want):
                raise AssertionError(f"{shape}: {name} differs from this")
        del want
        torch.cuda.empty_cache()
        times = {n: [] for n in names}
        for r in range(args.rounds):
            for i in range(len(names)):
                n = names[(r + i) % len(names)]
                times[n].append(timed(
                    lambda n=n: call(n, hay, lo, hi, needles, locate)))
        base = statistics.median(times["this"])
        print(f"{shape}: {cap} lanes, {'locate' if locate else 'found'}, "
              f"{hay.dtype} haystack of {int(hay.shape[0])}; each variant "
              f"equal to this on every lane", flush=True)
        for n in names:
            med = statistics.median(times[n])
            print(f"  {n:13s} {med:9.4f} ms ({med / base:6.3f} x this; "
                  f"rounds {', '.join(f'{t:.4f}' for t in times[n])})",
                  flush=True)
    K.reset_launches()
    return 0


if __name__ == "__main__":
    sys.exit(main())
