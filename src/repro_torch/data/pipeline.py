"""Deterministic, shardable, resumable data pipeline (counterpart of
``repro.data.pipeline``).

SyntheticLMDataset generates language-model token streams from numpy's
counter-seeded ``default_rng((seed, step))``, the reference's draws, so
the port's batches equal the reference's bit for bit:
  * every (step, shard) batch is reproducible without replaying history —
    restart-from-checkpoint resumes the stream exactly (the `state()` /
    `restore()` pair is just the step counter);
  * no filesystem dependency. A real corpus would slot in behind the
    same interface (state = file offsets).

The synthetic stream is Zipf-distributed token ids with a deterministic
"repeat previous token block" structure so the LM loss actually
decreases. Batches are drawn on the host and returned as tensors on
``device`` (None: the card).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np
import torch

from ..kernels.runtime import resolve_device


def _on(a: np.ndarray, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device=device,
                                                        dtype=dtype)


@dataclass
class SyntheticLMDataset:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    step: int = 0
    zipf_a: float = 1.2
    device: Optional[object] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def state(self) -> dict:
        return {"step": self.step, "seed": self.seed}

    def restore(self, state: dict):
        self.step = int(state["step"])
        self.seed = int(state["seed"])

    def _tokens(self, step: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, step))
        # Zipf-ish marginal over the vocab
        z = rng.zipf(self.zipf_a, size=(self.global_batch,
                                        self.seq_len)).astype(np.int64)
        toks = (z - 1) % self.vocab
        # learnable structure: second half of every 64-token block repeats
        # the first half shifted by one
        s = self.seq_len
        blk = 64
        if s >= blk:
            t = toks.reshape(self.global_batch, -1)[:, :s - s % blk]
            t = t.reshape(self.global_batch, -1, blk)
            t[:, :, blk // 2:] = np.roll(t[:, :, :blk // 2], -1, axis=2)
            toks[:, :s - s % blk] = t.reshape(self.global_batch, -1)
        return toks.astype(np.int32)

    def next_batch(self) -> dict:
        toks = self._tokens(self.step)
        self.step += 1
        tokens = toks[:, :-1] if self.seq_len > 1 else toks
        labels = toks[:, 1:] if self.seq_len > 1 else toks
        # pad back to seq_len so shapes stay static
        pad = self.seq_len - tokens.shape[1]
        if pad:
            tokens = np.pad(tokens, ((0, 0), (0, pad)))
            labels = np.pad(labels, ((0, 0), (0, pad)),
                            constant_values=-100)
        return {"tokens": _on(tokens, torch.int32, self.device),
                "labels": _on(labels, torch.int32, self.device)}

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.next_batch()


def make_batch_for(cfg, shape: dict, kind: str, seed: int = 0,
                   device=None) -> dict:
    """Materialize one concrete batch matching a model's input_specs —
    covers the stub-frontend archs (frames / patch embeddings /
    M-RoPE position ids)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    b, s = shape["global_batch"], shape["seq_len"]
    batch = {}
    if kind in ("train", "prefill"):
        ds = SyntheticLMDataset(cfg.vocab, s, b, seed=seed, device=dev)
        lm = ds.next_batch()
        batch["tokens"] = lm["tokens"]
        if kind == "train":
            batch["labels"] = lm["labels"]
    else:  # decode
        batch["tokens"] = _on(rng.integers(0, cfg.vocab, (b, 1)),
                              torch.int32, dev)
    if cfg.family == "encdec" and kind in ("train", "prefill"):
        se = min(cfg.max_source_len, s)
        batch["frames"] = _on(rng.standard_normal((b, se, cfg.d_model))
                              * 0.02, cfg.compute_dtype, dev)
    if cfg.family == "vlm":
        st = 1 if kind == "decode" else s
        pos = np.broadcast_to(np.arange(st, dtype=np.int32)[None, None],
                              (3, b, st)).copy()
        batch["positions"] = _on(pos, torch.int32, dev)
        if kind != "decode":
            batch.pop("tokens", None)
            batch["input_embeds"] = _on(
                rng.standard_normal((b, s, cfg.d_model)) * 0.02,
                cfg.compute_dtype, dev)
    return batch
