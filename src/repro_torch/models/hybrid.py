"""Zamba2-style hybrid: Mamba2 backbone + a *shared* attention block
(single parameter set) applied after every `attn_every` SSM layers
(arXiv:2411.15242) (counterpart of ``repro.models.hybrid``).

Structure: G = n_layers / attn_every groups; an outer loop over groups
(carrying the hidden state + that group's KV cache), an inner loop over
the group's Mamba2 layers. The shared block's params are closed over —
the same weights execute at every application, exactly the paper's
weight sharing — and so is the forward's RoPE table, built once from the
positions. Simplification vs. the released model: the shared block
consumes the hidden state only (no concat with the original embedding),
as in the reference.
"""
from __future__ import annotations

import math

import torch

from ..parallel.sharding import constrain
from . import layers as L
from .api import (ArchConfig, Model, count_params, init_device,
                  init_generator, maybe_scan, tree_map)
from .mamba2 import _dims, _token_input_specs, mamba2_block, \
    mamba2_layer_init
from .transformer import (_default_positions, _norm, _norm_init, _remat,
                          _rope, _vocab_padded, logits_fn, xent_loss)

BATCH = ("pod", "data")


def _groups(cfg: ArchConfig) -> int:
    if not (cfg.attn_every > 0 and cfg.n_layers % cfg.attn_every == 0):
        raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} is not a "
                         f"multiple of attn_every {cfg.attn_every}")
    return cfg.n_layers // cfg.attn_every


def init_hybrid(cfg: ArchConfig, generator, device) -> dict:
    vp = _vocab_padded(cfg)
    dt = cfg.param_dtype
    g = _groups(cfg)
    k = cfg.attn_every
    stacked = mamba2_layer_init(generator, cfg, dt, device=device,
                                lead=(cfg.n_layers,))
    # regroup leading axis L -> (G, k)
    grouped = tree_map(lambda a: a.reshape((g, k) + tuple(a.shape[1:])),
                       stacked)
    shared = {
        "attn_norm": _norm_init(cfg, device=device),
        "attn": L.attention_init(generator, cfg.d_model, cfg.n_heads,
                                 cfg.n_kv_heads, cfg.hd, dt, device=device),
        "mlp_norm": _norm_init(cfg, device=device),
        "mlp": L.swiglu_init(generator, cfg.d_model, cfg.d_ff, dt,
                             device=device),
    }
    params = {
        "embed": L.embedding_init(generator, vp, cfg.d_model, dt,
                                  device=device),
        "mamba": grouped,
        "shared": shared,
        "final_norm": _norm_init(cfg, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.truncated_normal_init(
            generator, (cfg.d_model, vp), 1.0 / math.sqrt(cfg.d_model), dt,
            device=device)
    return params


def _shared_block(cfg, sp, x, rope, kv_cache, cache_index):
    h = _norm(cfg, sp["attn_norm"], x)
    attn_out, new_cache = L.attention(
        sp["attn"], h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.hd, rope=rope, causal=True, kv_cache=kv_cache,
        cache_index=cache_index)
    x = x + attn_out
    h = _norm(cfg, sp["mlp_norm"], x)
    x = x + L.swiglu(sp["mlp"], h)
    return constrain(x, BATCH, None, None), new_cache


def make_hybrid_model(cfg: ArchConfig) -> Model:
    d_inner, nh, ds, conv_dim = _dims(cfg)
    g = _groups(cfg)

    def init(generator=0, device=None):
        dev = init_device(device)
        return init_hybrid(cfg, init_generator(generator, dev), dev)

    def _run(params, tokens, ssm0=None, conv0=None, kv0=None, pos0=None,
             decode=False, collect=False, cache_len=None):
        """Shared trunk for forward/prefill/decode.

        ssm0/conv0: (G,k,...) states; kv0: {k,v} (G,B,Smax,KV,hd);
        pos0: () cache write index. Returns (hidden, states)."""
        bsz, s = tokens.shape
        x = L.embed(params["embed"], tokens, cfg.compute_dtype)
        x = constrain(x, BATCH, None, None)
        cache_index = 0 if pos0 is None else pos0
        rope = _rope(cfg, _default_positions(cfg, bsz, s, x.device,
                                             start=cache_index))
        stateful = decode or collect

        def inner(carry, xs):
            if stateful:
                lp, hs, cs = xs
                x, nh_, nc_ = mamba2_block(cfg, lp, carry, ssm_state=hs,
                                           conv_state=cs, decode=decode)
                return x, (nh_, nc_)
            return mamba2_block(cfg, xs, carry)[0], None

        def outer(carry, xs):
            if stateful:
                mp, hs, cs, ck, cv = xs
                x, states = maybe_scan(inner, carry, (mp, hs, cs))
                x, ncache = _shared_block(cfg, params["shared"], x, rope,
                                          {"k": ck, "v": cv}, cache_index)
                return x, (states[0], states[1], ncache["k"], ncache["v"])
            x, _ = maybe_scan(inner, carry, xs)
            x, _ = _shared_block(cfg, params["shared"], x, rope, None, None)
            return x, None

        if stateful:
            if kv0 is None:  # prefill: fresh caches (s or cache_len)
                dev = x.device
                kvshape = (g, bsz, cache_len or s, cfg.n_kv_heads, cfg.hd)
                kv0 = {"k": torch.zeros(kvshape, dtype=cfg.compute_dtype,
                                        device=dev),
                       "v": torch.zeros(kvshape, dtype=cfg.compute_dtype,
                                        device=dev)}
                ssm0 = torch.zeros((g, cfg.attn_every, bsz, nh, ds,
                                    cfg.ssm_head_dim), dtype=torch.float32,
                                   device=dev)
                conv0 = torch.zeros((g, cfg.attn_every, bsz,
                                     cfg.ssm_conv - 1, conv_dim),
                                    dtype=cfg.compute_dtype, device=dev)
            x, states = maybe_scan(outer, x, (params["mamba"], ssm0, conv0,
                                              kv0["k"], kv0["v"]))
        else:
            x, states = maybe_scan(_remat(cfg, outer), x, params["mamba"])
        return _norm(cfg, params["final_norm"], x), states

    def loss(params, batch):
        hidden, _ = _run(params, batch["tokens"])
        lg = logits_fn(cfg, params, hidden)
        l = xent_loss(cfg, lg, batch["labels"])
        return l, {"xent": l}

    def prefill(params, batch, cache_len=None):
        tokens = batch["tokens"]
        s = tokens.shape[1]
        hidden, (hs, cs, ck, cv) = _run(params, tokens, collect=True,
                                        cache_len=cache_len)
        lg = logits_fn(cfg, params, hidden[:, -1:, :])
        return lg, {"ssm": hs, "conv": cs, "kv_k": ck, "kv_v": cv,
                    "len": torch.full((), s, dtype=torch.int32,
                                      device=hidden.device)}

    def decode_step(params, cache, batch):
        hidden, (hs, cs, ck, cv) = _run(
            params, batch["tokens"], ssm0=cache["ssm"], conv0=cache["conv"],
            kv0={"k": cache["kv_k"], "v": cache["kv_v"]},
            pos0=cache["len"], decode=True)
        lg = logits_fn(cfg, params, hidden)
        return lg, {"ssm": hs, "conv": cs, "kv_k": ck, "kv_v": cv,
                    "len": cache["len"] + 1}

    def param_specs(axes: dict):
        model = axes.get("model", 1)
        vp = _vocab_padded(cfg)
        hm = "model" if nh % model == 0 else None
        a = "model" if cfg.n_heads % model == 0 else None
        kv = "model" if cfg.n_kv_heads % model == 0 else None
        ff = "model" if cfg.d_ff % model == 0 else None
        v = "model" if vp % model == 0 else None
        mamba = {
            "norm": {"scale": (None, None, None)},
            "in_proj": (None, None, "data", hm),
            "conv_w": (None, None, None, None),
            "conv_b": (None, None, None),
            "A_log": (None, None, hm),
            "D": (None, None, hm),
            "dt_bias": (None, None, hm),
            "gate_norm": {"scale": (None, None, hm)},
            "out_proj": (None, None, hm, "data"),
        }
        shared = {
            "attn_norm": {"scale": (None,)},
            "attn": {"wq": ("data", a), "wk": ("data", kv),
                     "wv": ("data", kv), "wo": (a, "data")},
            "mlp_norm": {"scale": (None,)},
            "mlp": {"w1": ("data", ff), "w3": ("data", ff),
                    "w2": (ff, "data")},
        }
        specs = {
            "embed": {"table": (v, "data")},
            "mamba": mamba,
            "shared": shared,
            "final_norm": {"scale": (None,)},
        }
        if not cfg.tie_embeddings:
            specs["lm_head"] = ("data", v)
        return specs

    def cache_specs(axes: dict):
        model = axes.get("model", 1)
        hm = "model" if nh % model == 0 else None
        kv = ((None, BATCH, None, "model", None)
              if cfg.n_kv_heads % model == 0
              else (None, BATCH, "model", None, None))
        return {"ssm": (None, None, BATCH, hm, None, None),
                "conv": (None, None, BATCH, None, None),
                "kv_k": kv, "kv_v": kv, "len": ()}

    def active_param_count() -> int:
        vp = _vocab_padded(cfg)
        per_mamba = (cfg.d_model * (2 * d_inner + 2 * ds + nh)
                     + cfg.ssm_conv * conv_dim + d_inner * cfg.d_model)
        shared = (2 * cfg.d_model * cfg.n_heads * cfg.hd
                  + 2 * cfg.d_model * cfg.n_kv_heads * cfg.hd
                  + 3 * cfg.d_model * cfg.d_ff)
        emb = vp * cfg.d_model * (1 if cfg.tie_embeddings else 2)
        # the shared block executes G times but its params count once;
        # *active* compute counts every application
        return cfg.n_layers * per_mamba + g * shared + emb

    return Model(cfg=cfg, init=init, loss=loss, prefill=prefill,
                 decode_step=decode_step, param_specs=param_specs,
                 cache_specs=cache_specs, input_specs=_token_input_specs,
                 param_count=count_params,
                 active_param_count=active_param_count)
