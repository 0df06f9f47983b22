"""Decoder-only transformer skeleton covering the dense, MoE, and VLM
families (GQA + RoPE / M-RoPE; SwiGLU or MoE FFN; stacked layers)
(counterpart of ``repro.models.transformer``).

Layers are stacked (leading L axis) and run by ``maybe_scan``, a Python
loop over that axis. KV caches are stacked (L, B, Smax, KV, hd), and
``cache["len"]`` is a 0-d int32 tensor on the cache's device, so a
decode step reads nothing back to the host. ``loss`` is the forward pass
and the cross-entropy; ``train.make_train_step`` differentiates it, and
``cfg.remat`` picks what a layer's backward recomputes (``_remat``).
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
from torch.utils import checkpoint as CK

from ..parallel.sharding import constrain
from . import layers as L
from .api import (ArchConfig, Model, count_params, init_device,
                  init_generator, maybe_scan, tree_map)
from .moe import moe_ffn, moe_init

BATCH = ("pod", "data")


def _vocab_padded(cfg: ArchConfig) -> int:
    return -(-cfg.vocab // 256) * 256


def _norm_init(cfg, *, device, lead=()):
    return (L.rmsnorm_init(cfg.d_model, torch.float32, device=device,
                           lead=lead)
            if cfg.norm == "rmsnorm"
            else L.layernorm_init(cfg.d_model, torch.float32, device=device,
                                  lead=lead))


def _norm(cfg, p, x):
    return (L.rmsnorm(p, x, cfg.norm_eps) if cfg.norm == "rmsnorm"
            else L.layernorm(p, x, cfg.norm_eps))


def init_dense(cfg: ArchConfig, generator, device) -> dict:
    """The reference's tree (``init_dense``), every layer leaf stacked on
    a leading (n_layers,) axis."""
    vp = _vocab_padded(cfg)
    dt = cfg.param_dtype
    lead = (cfg.n_layers,)
    layer = {
        "attn_norm": _norm_init(cfg, device=device, lead=lead),
        "attn": L.attention_init(generator, cfg.d_model, cfg.n_heads,
                                 cfg.n_kv_heads, cfg.hd, dt,
                                 with_bias=cfg.attn_bias, device=device,
                                 lead=lead),
        "mlp_norm": _norm_init(cfg, device=device, lead=lead),
    }
    if cfg.is_moe:
        layer["moe"] = moe_init(generator, cfg, dt, device=device, lead=lead)
    elif cfg.mlp == "swiglu":
        layer["mlp"] = L.swiglu_init(generator, cfg.d_model, cfg.d_ff, dt,
                                     device=device, lead=lead)
    else:
        layer["mlp"] = L.gelu_mlp_init(generator, cfg.d_model, cfg.d_ff, dt,
                                       device=device, lead=lead)
    params = {
        "embed": L.embedding_init(generator, vp, cfg.d_model, dt,
                                  device=device),
        "layers": layer,
        "final_norm": _norm_init(cfg, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.truncated_normal_init(
            generator, (cfg.d_model, vp), 1.0 / math.sqrt(cfg.d_model), dt,
            device=device)
    return params


def _zero_aux(device):
    z = torch.zeros((), dtype=torch.float32, device=device)
    return {"moe_aux_loss": z, "moe_drop_frac": z}


def _block(cfg: ArchConfig, lp, x, rope, kv_cache, cache_index):
    """One transformer block; ``rope`` the forward's ``_rope`` table.
    Returns (x, aux, new_cache)."""
    h = _norm(cfg, lp["attn_norm"], x)
    h = constrain(h, BATCH, None, None)
    attn_out, new_cache = L.attention(
        lp["attn"], h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.hd, rope=rope, causal=True, kv_cache=kv_cache,
        cache_index=cache_index)
    x = x + attn_out
    h = _norm(cfg, lp["mlp_norm"], x)
    if cfg.is_moe:
        f, aux = moe_ffn(lp["moe"], h, cfg)
    else:
        f = (L.swiglu(lp["mlp"], h) if cfg.mlp == "swiglu"
             else L.gelu_mlp(lp["mlp"], h))
        aux = _zero_aux(x.device)
    x = x + f
    x = constrain(x, BATCH, None, None)
    return x, aux, new_cache


# the weight matmuls: ``x @ W`` reaches autograd as ``aten.mm`` (a 2-D W
# folds the batch into rows), the attention and expert einsums as
# ``aten.bmm`` — the dots the reference's
# ``dots_with_no_batch_dims_saveable`` keeps and recomputes
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CK.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CK.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg, fn):
    """``fn`` (a layer loop's body) under ``cfg.remat``: "none" keeps
    every activation for the backward, "full" keeps the layer's inputs
    and recomputes the rest (``jax.checkpoint``), "dots" also keeps the
    outputs of the weight matmuls. Under ``no_grad`` (serving) it is
    ``fn``."""
    if cfg.remat == "none":
        return fn
    if cfg.remat not in ("dots", "full"):
        raise ValueError(f"unknown remat {cfg.remat!r}")
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            CK.create_selective_checkpoint_contexts, _dots_policy)

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return CK.checkpoint(fn, *args, use_reentrant=False, **kw)

    return wrapped


def _default_positions(cfg, b: int, s: int, device, start=0):
    """(B, S) positions start .. start + S - 1, or (3, B, S) under
    M-RoPE; ``start`` an int or a 0-d tensor."""
    pos = (torch.arange(s, dtype=torch.int32, device=device)
           + start)[None, :].expand(b, s)
    if cfg.mrope_sections:
        pos = pos[None].expand(3, b, s)
    return pos.to(torch.int32)


def _rope(cfg, positions):
    """The RoPE / M-RoPE table of ``positions``, shared by every layer."""
    return L.rope_table(positions, cfg.hd, cfg.rope_theta,
                        tuple(cfg.mrope_sections)
                        if cfg.mrope_sections else None)


def _embed_inputs(cfg, params, tokens, input_embeds):
    dt = cfg.compute_dtype
    if input_embeds is not None:
        return input_embeds.to(dt)
    return L.embed(params["embed"], tokens, dt)


def forward(cfg: ArchConfig, params, tokens, positions=None,
            input_embeds=None):
    """tokens: (B,S) int32 (or input_embeds (B,S,d)); positions: (B,S) or
    (3,B,S) for M-RoPE. Returns (final hidden states (B,S,d), aux)."""
    x = _embed_inputs(cfg, params, tokens, input_embeds)
    b, s = x.shape[:2]
    if positions is None:
        positions = _default_positions(cfg, b, s, x.device)
    x = constrain(x, BATCH, None, None)
    rope = _rope(cfg, positions)

    def body(carry, lp):
        x, aux, _ = _block(cfg, lp, carry, rope, None, None)
        return x, aux

    x, auxs = maybe_scan(_remat(cfg, body), x, params["layers"])
    x = _norm(cfg, params["final_norm"], x)
    return x, tree_map(torch.mean, auxs)


def logits_fn(cfg, params, hidden):
    if cfg.tie_embeddings:
        lg = hidden @ params["embed"]["table"].to(hidden.dtype).T
    else:
        lg = hidden @ params["lm_head"].to(hidden.dtype)
    return constrain(lg, BATCH, None, "model")


def xent_loss(cfg, logits, labels, mask=None):
    """Cross-entropy in fp32 with the z-loss; labels -100 ignored."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    ignore = labels < 0
    safe = torch.where(ignore, 0, labels).long()
    gold = torch.gather(lf, -1, safe[..., None])[..., 0]
    nll = lse - gold
    zloss = 1e-4 * lse ** 2
    w = torch.where(ignore, 0.0, 1.0)
    if mask is not None:
        w = w * mask
    denom = torch.clamp(torch.sum(w), min=1.0)
    return torch.sum((nll + zloss) * w) / denom


def _spec_tree(cfg: ArchConfig, axes: dict) -> dict:
    """``param_specs``: the reference's PartitionSpecs as tuples."""
    vp = _vocab_padded(cfg)
    model = axes.get("model", 1)
    h_ok = cfg.n_heads % model == 0
    kv_ok = cfg.n_kv_heads % model == 0
    ff_ok = (cfg.d_expert if cfg.is_moe else cfg.d_ff) % model == 0
    e_ok = cfg.is_moe and cfg.n_experts % model == 0
    v_ok = vp % model == 0
    h = "model" if h_ok else None
    kv = "model" if kv_ok else None
    ff = "model" if ff_ok else None

    attn = {"wq": (None, "data", h), "wk": (None, "data", kv),
            "wv": (None, "data", kv), "wo": (None, h, "data")}
    if cfg.attn_bias:
        attn.update({"bq": (None, h), "bk": (None, kv), "bv": (None, kv)})
    layer = {"attn_norm": {"scale": (None, None)}, "attn": attn,
             "mlp_norm": {"scale": (None, None)}}
    if cfg.norm == "layernorm":
        layer["attn_norm"]["bias"] = (None, None)
        layer["mlp_norm"]["bias"] = (None, None)
    swiglu = {"w1": (None, "data", ff), "w3": (None, "data", ff),
              "w2": (None, ff, "data")}
    if cfg.is_moe:
        ex = "model" if e_ok else None
        layer["moe"] = {"router": (None, None, None),
                        "w1": (None, ex, "data", None),
                        "w3": (None, ex, "data", None),
                        "w2": (None, ex, None, "data")}
        if cfg.weight_quant:
            layer["moe"].update({f"{w}_scale": (None, ex, None)
                                 for w in ("w1", "w3", "w2")})
        if cfg.n_shared_experts:
            layer["moe"]["shared"] = swiglu
    elif cfg.mlp == "swiglu":
        layer["mlp"] = swiglu
    else:
        layer["mlp"] = {"w1": (None, "data", ff), "b1": (None, ff),
                        "w2": (None, ff, "data"), "b2": (None, None)}
    specs = {"embed": {"table": ("model" if v_ok else None, "data")},
             "layers": layer, "final_norm": {"scale": (None,)}}
    if cfg.norm == "layernorm":
        specs["final_norm"]["bias"] = (None,)
    if not cfg.tie_embeddings:
        specs["lm_head"] = ("data", "model" if v_ok else None)
    return specs


def make_dense_model(cfg: ArchConfig) -> Model:
    vp = _vocab_padded(cfg)

    def init(generator=0, device=None):
        dev = init_device(device)
        return init_dense(cfg, init_generator(generator, dev), dev)

    def loss(params, batch):
        hidden, aux = forward(cfg, params, batch.get("tokens"),
                              batch.get("positions"),
                              input_embeds=batch.get("input_embeds"))
        lg = logits_fn(cfg, params, hidden)
        l = xent_loss(cfg, lg, batch["labels"])
        total = l + 0.01 * aux["moe_aux_loss"]
        return total, {"xent": l, **aux}

    # ---- serving ---------------------------------------------------------
    def _empty_cache(b, smax, device):
        shp = (cfg.n_layers, b, smax, cfg.n_kv_heads, cfg.hd)
        if cfg.kv_quant:
            sshp = (cfg.n_layers, b, smax, cfg.n_kv_heads)
            return {"k": torch.zeros(shp, dtype=torch.int8, device=device),
                    "v": torch.zeros(shp, dtype=torch.int8, device=device),
                    "k_scale": torch.zeros(sshp, dtype=torch.float32,
                                           device=device),
                    "v_scale": torch.zeros(sshp, dtype=torch.float32,
                                           device=device)}
        return {"k": torch.zeros(shp, dtype=cfg.compute_dtype,
                                 device=device),
                "v": torch.zeros(shp, dtype=cfg.compute_dtype,
                                 device=device)}

    def _run_cached(params, x, positions, cache, index, remat=False):
        rope = _rope(cfg, positions)

        def body(carry, xs):
            lp, cache_l = xs
            x, _, nc = _block(cfg, lp, carry, rope, cache_l, index)
            return x, nc

        x, caches = maybe_scan(_remat(cfg, body) if remat else body, x,
                               (params["layers"], cache))
        return _norm(cfg, params["final_norm"], x), caches

    def prefill(params, batch, cache_len: Optional[int] = None):
        """Full-sequence forward that also emits the KV cache.

        cache_len: cache capacity; defaults to the prompt length. Pass
        prompt+headroom for prefill→decode flows. Returns the last
        position's logits (B, 1, Vp) and the cache.
        """
        x = _embed_inputs(cfg, params, batch.get("tokens"),
                          batch.get("input_embeds"))
        b, s = x.shape[:2]
        positions = batch.get("positions")
        if positions is None:
            positions = _default_positions(cfg, b, s, x.device)
        x = constrain(x, BATCH, None, None)
        cache0 = _empty_cache(b, cache_len or s, x.device)
        x, caches = _run_cached(params, x, positions, cache0, 0, remat=True)
        lg = logits_fn(cfg, params, x[:, -1:, :])
        return lg, {**caches, "len": torch.full((), s, dtype=torch.int32,
                                                device=x.device)}

    def decode_step(params, cache, batch):
        """One-token decode against a static-size cache."""
        tokens = batch["tokens"]                     # (B, 1)
        b = tokens.shape[0]
        pos = cache["len"]                           # () int32
        x = L.embed(params["embed"], tokens, cfg.compute_dtype)
        positions = _default_positions(cfg, b, 1, x.device, start=pos)
        x = constrain(x, BATCH, None, None)
        x, caches = _run_cached(
            params, x, positions,
            {k_: v_ for k_, v_ in cache.items() if k_ != "len"}, pos)
        lg = logits_fn(cfg, params, x)
        return lg, {**caches, "len": pos + 1}

    # ---- sharding --------------------------------------------------------
    def param_specs(axes: dict):
        return _spec_tree(cfg, axes)

    def cache_specs(axes: dict):
        model = axes.get("model", 1)
        # KV heads over "model" when they divide, else the sequence dim
        if cfg.n_kv_heads % model == 0:
            kv = (None, BATCH, None, "model", None)
            sc = (None, BATCH, None, "model")
        else:
            kv = (None, BATCH, "model", None, None)
            sc = (None, BATCH, "model", None)
        out = {"k": kv, "v": kv, "len": ()}
        if cfg.kv_quant:
            out.update({"k_scale": sc, "v_scale": sc})
        return out

    def input_specs(shape, kind: str):
        """The batch's tensors for one shape and kind, on ``meta``."""
        b, s = shape["global_batch"], shape["seq_len"]

        def meta(shp, dtype):
            return torch.empty(shp, dtype=dtype, device="meta")

        if kind == "train":
            d = {"tokens": meta((b, s), torch.int32),
                 "labels": meta((b, s), torch.int32)}
        elif kind == "prefill":
            d = {"tokens": meta((b, s), torch.int32)}
        elif kind == "decode":
            d = {"tokens": meta((b, 1), torch.int32)}
        else:
            raise ValueError(kind)
        if cfg.family == "vlm":
            # stub frontend: precomputed patch/frame embeddings + M-RoPE ids
            st = 1 if kind == "decode" else s
            d["positions"] = meta((3, b, st), torch.int32)
            if kind != "decode":
                d.pop("tokens")
                d["input_embeds"] = meta((b, s, cfg.d_model),
                                         cfg.compute_dtype)
                if kind == "train":
                    d["labels"] = meta((b, s), torch.int32)
        return d

    def active_param_count() -> int:
        """Analytic active params (per-token) for MODEL_FLOPS = 6·N·D."""
        d, l = cfg.d_model, cfg.n_layers
        attn = d * cfg.n_heads * cfg.hd + 2 * d * cfg.n_kv_heads * cfg.hd \
            + cfg.n_heads * cfg.hd * d
        if cfg.is_moe:
            ffn = 3 * d * cfg.d_expert * (cfg.top_k + cfg.n_shared_experts)
            ffn += d * cfg.n_experts  # router
        elif cfg.mlp == "swiglu":
            ffn = 3 * d * cfg.d_ff
        else:
            ffn = 2 * d * cfg.d_ff
        emb = vp * d * (1 if cfg.tie_embeddings else 2)
        return l * (attn + ffn) + emb

    return Model(cfg=cfg, init=init, loss=loss, prefill=prefill,
                 decode_step=decode_step, param_specs=param_specs,
                 cache_specs=cache_specs, input_specs=input_specs,
                 param_count=count_params,
                 active_param_count=active_param_count)
