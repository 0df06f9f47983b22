"""Architecture config + the family-agnostic Model protocol (counterpart
of ``repro.models.api``).

Every architecture builds to a ``Model`` with the same entry points, so
the launchers are family-blind:

    init(generator=0, device=None) -> params
    loss(params, batch) -> (scalar, metrics)
    prefill(params, batch, cache_len=None) -> (logits, cache)
    decode_step(params, cache, batch) -> (logits, cache)
    param_specs(mesh_axes) -> tree of spec tuples
    cache_specs(mesh_axes) -> tree of spec tuples
    input_specs(shape, kind) -> dict of ``meta`` tensors

Params are nested dicts of tensors under the reference's keys, layers
stacked on a leading (L, ...) axis. ``init`` draws from a
``torch.Generator`` (an int seeds one on ``device``) with the
reference's distributions; ``device=None`` is the card, ``"meta"``
builds the shapes and allocates nothing.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch
from ..kernels.runtime import resolve_device
from ..pytree import flatten, leaves as tree_leaves, tree_map, unflatten


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    rope_theta: float = 10000.0
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    mlp: str = "swiglu"              # swiglu | gelu
    tie_embeddings: bool = False
    attn_bias: bool = False
    norm_eps: float = 1e-5
    # MoE
    n_experts: int = 0
    top_k: int = 0
    d_expert: int = 0                # per-expert FFN hidden
    capacity_factor: float = 1.25
    n_shared_experts: int = 0
    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    # hybrid (zamba2): shared attention block applied every k ssm layers
    attn_every: int = 0
    # enc-dec (whisper)
    n_enc_layers: int = 0
    n_dec_layers: int = 0
    max_source_len: int = 1500       # whisper: 30 s → 1500 frames
    # VLM (qwen2-vl)
    mrope_sections: Optional[tuple] = None
    # dtypes / optimization
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.float32
    remat: str = "none"              # none | dots | full
    # serving
    max_cache_len: int = 32768       # encdec: the decoder's position table
    kv_quant: bool = False           # int8 KV cache
    weight_quant: bool = False       # int8 MoE expert weights (serving)
    # notes for DESIGN/EXPERIMENTS
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


@dataclass
class Model:
    cfg: ArchConfig
    init: Callable                  # (generator=0, device=None) -> params
    loss: Callable                  # (params, batch) -> (loss, metrics)
    prefill: Callable               # (params, batch) -> (logits, cache)
    decode_step: Callable           # (params, cache, batch) -> (logits, cache)
    param_specs: Callable           # (mesh_axes: dict) -> spec tree
    cache_specs: Callable           # (mesh_axes: dict) -> spec tree
    input_specs: Callable           # (shape, kind) -> dict[str, meta tensor]
    param_count: Callable           # (params) -> int
    active_param_count: Callable    # () -> analytic active params


def count_params(params) -> int:
    return sum(int(x.numel()) for x in tree_leaves(params))


def maybe_scan(body, carry, xs):
    """The reference's ``lax.scan`` over the stacked layer axis, as a
    Python loop (eager PyTorch has no trace to keep depth-independent).
    ``body(carry, x_i) -> (carry, y_i)``; the ``y_i`` (tensors or dicts
    of them, or None) are stacked. Each stacked leaf is split once with
    ``unbind(0)``: its backward stacks the L layer gradients in one
    write, where indexing ``a[i]`` would write a zero-filled stack for
    every layer (L² bytes)."""
    flat, spec = flatten(xs)
    layers = [a.unbind(0) for a in flat]
    ys = []
    for i in range(len(layers[0])):
        carry, y = body(carry, unflatten(spec, [u[i] for u in layers]))
        ys.append(y)
    if not ys or ys[0] is None:
        return carry, None
    return carry, tree_map(lambda *a: torch.stack(a), *ys)


def init_device(device) -> torch.device:
    """``device`` for ``init`` / ``input_specs``: ``"meta"`` as given,
    else the port's rule (None = the card, raising without one)."""
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")
    return resolve_device(device)


def init_generator(generator, device: torch.device):
    """A ``torch.Generator`` on ``device`` (None on ``meta``); an int
    seeds a new one."""
    if device.type == "meta":
        return None
    if isinstance(generator, torch.Generator):
        if generator.device.type != device.type:
            raise ValueError(f"generator on {generator.device}, params on "
                             f"{device}")
        return generator
    return torch.Generator(device=device).manual_seed(int(generator or 0))


def build_model(cfg: ArchConfig) -> Model:
    if cfg.family in ("dense", "vlm", "moe"):
        # MoE FFN plugs into the same skeleton
        from .transformer import make_dense_model
        return make_dense_model(cfg)
    if cfg.family == "ssm":
        from .mamba2 import make_mamba2_model
        return make_mamba2_model(cfg)
    if cfg.family == "hybrid":
        from .hybrid import make_hybrid_model
        return make_hybrid_model(cfg)
    if cfg.family == "encdec":
        from .encdec import make_encdec_model
        return make_encdec_model(cfg)
    raise ValueError(f"unknown family {cfg.family}")
