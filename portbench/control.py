"""The control's readings at a cell's own size, on the card.

    python3 portbench/control.py --workload graph500-22.traverse --seeds 11,12,13 --seconds 1

For each seed, one run of the cell as ``run.py`` makes it (``pb/cell.py``:
the graph from the seed, the program's build, the warm-up chunk, a short
window at the cell's own batch and mix, and the comparison with the plain
reference), with the control in the program's place: every batch that
serve_mixed flushes is answered by the plain reference stopped one round
before it converges. One JSON line a seed, with ``correct`` and the
numbers compared; the control has to come out as not correct.
"""
import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from pb import cell as C  # noqa: E402
from pb import spec  # noqa: E402


def reference_in_place(cell, seed: int, dev, rounds_short: int = 1):
    """A stand-in for serve_mixed's ``_run_kind`` that answers each
    flushed batch with the plain reference on the cell's graph of
    ``seed``, ``rounds_short`` rounds before convergence."""
    answer = C.reference_answers(C.draw_graph(cell, seed, dev), dev,
                                 rounds_short)

    def run_kind(g, kind, srcs, backend, hops, budget=None):
        field = np.stack([answer(kind, s, hops) for s in srcs])
        return torch.from_numpy(field), np.zeros(len(srcs), np.int64), None

    return run_kind


def control_run(cell, seed: int, seconds: float, device: str,
                rounds_short: int = 1) -> dict:
    """One run of ``cell`` with the reference, ``rounds_short`` rounds
    short, in the program's place."""
    from repro_torch.launch import graph_serve as gs
    run_kind = gs._run_kind
    gs._run_kind = reference_in_place(cell, seed, torch.device(device),
                                      rounds_short)
    try:
        return C.run_cell(cell, seed, seconds, False, device,
                          time.monotonic())
    finally:
        gs._run_kind = run_kind


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds, three or more")
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(HERE.parent, args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        r = control_run(cell, seed, args.seconds, "cuda")
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": r["correct"],
                          "attempted": r["attempted"],
                          "checks": r["checks"]}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
