"""MiniCPM-2B's training loss on the card with int8 AdamW moments against
fp32 ones, over several peak learning rates, and what the int8 moments
do to each step (ROADMAP C-ref-15).

  python tools/train_int8_lr.py [--lrs 1e-3,1e-4,1e-5] [--steps 4]

For each lr: ``--steps`` steps with fp32 moments, then with int8 ones,
each from the init ``chip_smoke.py`` path (l) draws (seed 0 on the
card), on its one repeated batch (B = 4, S = 512), AdamW under its WSD
schedule (8 steps, 2 of warmup) peaking at the lr. Each step prints its
loss and grad norm, how many int8 moment entries it read with a v code
of 0 and an m code that is not (such an entry moves its param by
lr·m̂ / eps), and how many params it moved by more than 10 lr plus one
bf16 quantum (``chip_smoke._train_run(diagnose=...)``).
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lrs", default="1e-3,1e-4,1e-5")
    ap.add_argument("--steps", type=int, default=4)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(HERE / "src"), str(HERE)]
    import torch

    import chip_smoke as C
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.kernels.runtime import resolve_device

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = resolve_device(None)
    print(f"card: {_smi()}")
    cfg = get_config("minicpm-2b")
    batch = SyntheticLMDataset(cfg.vocab, C.TRAIN_S, C.TRAIN_B, seed=0,
                               device=dev).next_batch()
    for lr in (float(x) for x in args.lrs.split(",")):
        for quant in (False, True):
            rows = C._train_run(torch, cfg, batch, dev, remat="none",
                                quant=quant, steps=args.steps, lr=lr,
                                diagnose=args.steps)[0]
            for i, (loss, gnorm, _, (hit, of), moved) in enumerate(rows):
                print(f"lr {lr:g} {'int8' if quant else 'fp32'} step "
                      f"{i + 1}: loss {loss:.4f}, grad_norm {gnorm:.3f}; "
                      f"read v code 0 under m code != 0 at {hit:,} of "
                      f"{of:,} int8 entries; moved > 10 lr: {moved:,}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
