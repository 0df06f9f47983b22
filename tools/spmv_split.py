"""Where K4's time goes: one PageRank sweep's SpMV on the card, whole and
split into its light rows (degree <= the ELL width: the halving tree
alone) and its heavy rows (the tree plus the ordered overflow fold).

  python tools/spmv_split.py [--scale 22] [--reps 20]

Builds ``rmat(scale, 16, seed=0, weighted)`` on the card, as
``chip_smoke.py`` does, and times ``kernels.ops.spmv`` over the CSC
transpose (structural plus_times, the sweep of ``pagerank``) with no
mask, with the mask of the light rows, with the mask of the heavy rows
and with the mask of the max-degree row alone, each by CUDA events over
``--reps`` calls after a warm-up call. Prints the byte bound and the
serial-chain floor: the longest overflow times a 4-cycle FADD latency at
the card's maximum SM clock, as ``nvidia-smi`` reports it. Imports the
``repro_torch`` found on ``PYTHONPATH`` first, else this checkout's.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
HBM_BYTES_PER_S = 3.35e12
FADD_CYCLES = 4


def _smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=22)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    sys.path.append(str(HERE / "src"))
    import torch
    if not torch.cuda.is_available():
        print("spmv_split.py: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.core import graph as G
    from repro_torch.kernels import ops as K
    from repro_torch.linalg import semiring as SR

    print(f"card: {_smi('name,power.limit')}; kernels from {K.__file__}")
    dev = torch.device("cuda")
    g = G.rmat(args.scale, 16, seed=0, weighted=True, device=dev)
    n, m, width = g.num_vertices, g.num_edges, g.csc_ell_width
    deg = (g.csc_offsets[1:] - g.csc_offsets[:-1]).long()
    x = torch.rand(n, generator=torch.Generator(device=dev).manual_seed(0),
                   device=dev)
    hub = torch.zeros(n, dtype=torch.bool, device=dev)
    hub[int(torch.argmax(deg))] = True
    masks = {"all rows": None, "light rows": deg <= width,
             "heavy rows": deg > width, "max-degree row": hub}

    def run(mask):
        return K.spmv(g.csc_offsets, g.csc_indices, None, x, SR.plus_times,
                      width, mask, g.csc_row_seg, g.csc_over_pos,
                      g.csc_over_row)

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    over = (deg - width).clamp(min=0)
    print(f"rmat scale {args.scale}: n={n} m={m} csc_ell_width={width} "
          f"max degree {int(deg.max())}; heavy rows "
          f"{int((deg > width).sum(dtype=torch.int64))} hold "
          f"{int(over.sum())} overflow "
          f"edges ({float(over.sum()) / m:.3f} of m)")
    for label, mask in masks.items():
        run(mask)
        torch.cuda.synchronize()
        start.record()
        for _ in range(args.reps):
            run(mask)
        end.record()
        end.synchronize()
        rows = n if mask is None else int(mask.sum())
        edges = m if mask is None else int(deg[mask].sum(dtype=torch.int64))
        print(f"K4 spmv {label:15s} rows {rows:9d} edges {edges:10d}: "
              f"{start.elapsed_time(end) / args.reps:.4f} ms")
    mhz = float(_smi("clocks.max.sm").split()[0])
    floor_ms = int(over.max()) * FADD_CYCLES / (mhz * 1e6) * 1e3
    nbytes = m * 4 + 3 * n * 4 + 4
    print(f"byte bound {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms; serial-chain "
          f"floor {floor_ms:.4f} ms ({int(over.max())} ordered adds x "
          f"{FADD_CYCLES} cycles at {mhz:.0f} MHz)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
