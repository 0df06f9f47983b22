"""Batched serving driver: prefill + greedy decode with a static request
batch — the inference-side end-to-end example (counterpart of
``repro.launch.serve``).

Prompts fill fixed-shape slots: each batch of --batch prompts is
prefilled into a KV cache sized prompt + generation, then every slot
decodes in lockstep, greedy, for --gen-len tokens (the argmax ranges
over the padded vocabulary, as the reference's does).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch minicpm-2b \
      --smoke --requests 8 --batch 4 --prompt-len 32 --gen-len 16

``--device`` defaults to the card; ``--device cpu`` runs the plain
PyTorch path on the CPU.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config, get_smoke_config
from ..kernels.runtime import resolve_device
from ..models import build_model
from ..obs.log import get_logger


def generate(model, params, batch: dict, gen_len: int,
             cache_len=None) -> tuple:
    """Prefill ``batch``, then greedy-decode ``gen_len - 1`` more tokens.
    Returns (ids (B, gen_len) int32, logits (B, gen_len, Vp)): the
    tokens and the logits each was picked from. Nothing is read back to
    the host."""
    logits, cache = model.prefill(params, batch, cache_len=cache_len)
    lgs = [logits[:, -1, :]]
    toks = [torch.argmax(lgs[-1], dim=-1).to(torch.int32)[:, None]]
    for _ in range(gen_len - 1):
        logits, cache = model.decode_step(params, cache,
                                          {"tokens": toks[-1]})
        lgs.append(logits[:, -1, :])
        toks.append(torch.argmax(lgs[-1], dim=-1).to(torch.int32)[:, None])
    return torch.cat(toks, dim=1), torch.stack(lgs, dim=1)


def prompt_batch(cfg, rng: np.random.Generator, batch: int, prompt_len: int,
                 device) -> dict:
    """One batch of prompts: the reference's draw from ``rng`` — the
    tokens, then for the encdec family 32 stub frames (B, 32, d) × 0.02
    in the compute dtype."""
    ids = rng.integers(0, cfg.vocab, (batch, prompt_len))
    out = {"tokens": torch.from_numpy(ids).to(device=device,
                                              dtype=torch.int32)}
    if cfg.family == "encdec":
        frames = rng.standard_normal((batch, 32, cfg.d_model)) * 0.02
        out["frames"] = torch.from_numpy(frames).to(
            device=device, dtype=cfg.compute_dtype)
    return out


def serve(model, params, *, requests: int, batch: int, prompt_len: int,
          gen_len: int, seed: int, device) -> dict:
    """Serve ``requests`` prompts drawn from ``seed`` in batches of
    ``batch``. Returns the report: requests, tokens, seconds, tok/s and
    each batch's generated ids (host tensors)."""
    log = get_logger("serve")
    rng = np.random.default_rng(seed)
    cache_len = prompt_len + gen_len
    served = 0
    total_tokens = 0
    outputs = []
    t0 = time.monotonic()
    while served < requests:
        gen, _ = generate(model, params,
                          prompt_batch(model.cfg, rng, batch, prompt_len,
                                       device),
                          gen_len, cache_len)
        outputs.append(gen.cpu())                   # waits for the batch
        served += batch
        total_tokens += int(gen.numel())
        log.info(f"batch done: {batch} requests, "
                 f"sample output ids: {outputs[-1][0, :8].tolist()}")
    dt = time.monotonic() - t0
    log.info(f"{served} requests, {total_tokens} tokens in {dt:.2f}s "
             f"({total_tokens / dt:.1f} tok/s)")
    return {"requests": served, "tokens": total_tokens, "seconds": dt,
            "tok_per_s": total_tokens / dt, "ids": outputs}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = (get_smoke_config(args.arch) if args.smoke
           else get_config(args.arch))
    model = build_model(cfg)
    params = model.init(0, device=dev)
    return serve(model, params, requests=args.requests, batch=args.batch,
                 prompt_len=args.prompt_len, gen_len=args.gen_len,
                 seed=args.seed, device=dev)


if __name__ == "__main__":
    main()
