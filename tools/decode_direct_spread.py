"""Decode against direct on the card, over several prompts: how far a
decode step's logits fall from a direct prefill of the prompt plus the
decoded token, for whole models in bf16 and, with the same draw upcast,
in fp32.

  python tools/decode_direct_spread.py [--archs mamba2-780m,zamba2-2.7b]
      [--prompts 5] [--lengths 128,256,511]

For each arch (params drawn on the card from seed i, the i-th arch, as
``chip_smoke.py`` path (k) draws them): batch 4, ``--prompts`` prompts
of 512 tokens (``serve.prompt_batch`` from numpy seeds 2, 3, ...), then
one prompt of each of ``--lengths``; each prompt is prefilled into a
cache of S + 2 rows, one random token decoded, and the logits compared
with a prefill of the S + 1 tokens by relative L2 (``chip_smoke``'s
``_rel_l2``). Then the first prompt once more with the params and the
compute in fp32 (TF32 off), which separates bf16 rounding from a
difference between the two code paths. Imports the ``repro_torch``
found on ``PYTHONPATH`` first, else this checkout's.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
SEEDS = {"mamba2-780m": 0, "zamba2-2.7b": 1, "whisper-large-v3": 2}


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def _rel(torch, model, params, batch, seed, dev) -> float:
    s = batch["tokens"].shape[1]
    _, cache = model.prefill(params, batch, cache_len=s + 2)
    nxt = torch.randint(0, model.cfg.vocab, (batch["tokens"].shape[0], 1),
                        dtype=torch.int32, device=dev,
                        generator=torch.Generator(device=dev)
                        .manual_seed(seed))
    dec, _ = model.decode_step(params, cache, {"tokens": nxt})
    direct, _ = model.prefill(params, {**batch, "tokens": torch.cat(
        [batch["tokens"], nxt], 1)})
    dec, direct = dec.float(), direct.float()
    return float(torch.linalg.norm(dec - direct) / torch.linalg.norm(direct))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--archs", default="mamba2-780m,zamba2-2.7b")
    ap.add_argument("--prompts", type=int, default=5)
    ap.add_argument("--lengths", default="128,256,511")
    args = ap.parse_args(argv)
    sys.path.append(str(HERE / "src"))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("decode_direct_spread.py: no CUDA device is available",
              file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import prompt_batch
    from repro_torch.models import build_model
    from repro_torch.models.api import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    print(f"card: {_smi()}; torch {torch.__version__}")
    lengths = [int(x) for x in args.lengths.split(",") if x]
    for arch in args.archs.split(","):
        cfg = get_config(arch)
        model = build_model(cfg)
        params = model.init(torch.Generator(device=dev).manual_seed(
            SEEDS.get(arch, 0)), device=dev)
        rels = []
        for i in range(args.prompts):
            batch = prompt_batch(cfg, np.random.default_rng(2 + i), 4, 512,
                                 dev)
            rels.append(_rel(torch, model, params, batch, 3 + i, dev))
        for s in lengths:
            batch = prompt_batch(cfg, np.random.default_rng(2), 4, s, dev)
            rels.append(_rel(torch, model, params, batch, 3, dev))
        print(f"{arch} bf16: {args.prompts} prompts of 512, then S = "
              f"{lengths}: " + ", ".join(f"{r:.3e}" for r in rels)
              + f"; max {max(rels):.3e}")
        cfg32 = cfg.replace(param_dtype=torch.float32,
                            compute_dtype=torch.float32)
        model32 = build_model(cfg32)
        params32 = tree_map(lambda t: t.float(), params)
        del params
        batch = prompt_batch(cfg32, np.random.default_rng(2), 4, 512, dev)
        print(f"{arch} fp32 (the bf16 draw upcast), the first prompt: "
              f"{_rel(torch, model32, params32, batch, 3, dev):.3e}")
        del params32
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
