"""The benchmark of repro_torch, the PyTorch / CUDA port.

  python3 portbench/run.py --workload CELL --seed N --seconds S --trace 0|1

from the root of a checkout. One process is one run of one cell of
BENCHMARK.json: set-up, a window of ``--seconds``, the check of what the
window served against the plain reference, and, as the last line of
standard output, one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1`` a
``breakdown``, and ``checks`` last (each number compared, with its
limit; they are also the last lines of standard error).

Exits non-zero and prints no result where there is no CUDA device or
fewer than the cell asks for, or where a module of JAX, Flax or the JAX
package ``repro`` was loaded.
"""
import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _environment() -> None:
    """Every compiler cache at a fixed path inside the checkout (the
    port's own nvcc build is build/repro_torch/ there already), and
    PyTorch's allocator in expandable segments: at batch 8 on
    graph500-22 the program allocates ~68 GB at its peak, and with fixed
    segments a run can fail on fragmentation (17 GiB reserved but
    unallocated) before it reaches the card's 80."""
    cache = ROOT / "build" / "portbench-cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    sys.path[:0] = [str(HERE), str(ROOT / "src")]
    import torch
    from pb import cell as C
    from pb import imports, spec

    cell = spec.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    result = C.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                        "cuda", T_START)
    leaked = imports.forbidden_loaded()
    if leaked:
        print(f"forbidden modules loaded: {', '.join(leaked)}",
              file=sys.stderr)
        return 3
    report(result, sys.stdout, sys.stderr)
    return 0


def report(result: dict, out, err) -> None:
    """The checks as the last lines of ``err``; the import line, then the
    result object as the last line of ``out``."""
    from pb import imports
    for name, c in result["checks"].items():
        side = "max" if "max" in c else "min"
        print(f"check {name} = {c['value']} ({side} {c[side]})", file=err,
              flush=True)
    print(f"imports: no module of {', '.join(sorted(imports.FORBIDDEN))} "
          f"loaded", file=out)
    print(json.dumps(result), file=out, flush=True)


if __name__ == "__main__":
    sys.exit(main())
