"""Whisper-style encoder-decoder backbone (arXiv:2212.04356) (counterpart
of ``repro.models.encdec``).

The conv/mel frontend is a stub, as in the reference: the batch carries
precomputed frame embeddings (B, S_enc, d) — the two conv1d layers +
GELU that would produce them are out of scope. Everything after
(sinusoidal positions, the bidirectional encoder, the decoder with
cross-attention, layernorm/GELU) is implemented.

Serving: prefill encodes the source and precomputes per-layer cross KV
(they are decode-invariant), then decode steps run self-attn against the
growing cache + fixed cross KV. A decode step's sinusoidal position is
the one row of the ``max_cache_len`` table at the cache length, the
index clamped into the table as the reference's ``dynamic_slice``
clamps it, computed on the device (no host read, no table).
"""
from __future__ import annotations

import torch

from ..parallel.sharding import constrain
from . import layers as L
from .api import (ArchConfig, Model, count_params, init_device,
                  init_generator, maybe_scan)
from .transformer import (_norm, _norm_init, _remat, _vocab_padded,
                          xent_loss)

BATCH = ("pod", "data")


def _enc_layers(cfg):
    return cfg.n_enc_layers or cfg.n_layers


def _dec_layers(cfg):
    return cfg.n_dec_layers or cfg.n_layers


def init_encdec(cfg: ArchConfig, generator, device) -> dict:
    vp = _vocab_padded(cfg)
    dt = cfg.param_dtype

    def norm(lead):
        return _norm_init(cfg, device=device, lead=lead)

    def attn(lead):
        return L.attention_init(generator, cfg.d_model, cfg.n_heads,
                                cfg.n_kv_heads, cfg.hd, dt, with_bias=True,
                                device=device, lead=lead)

    def mlp(lead):
        return L.gelu_mlp_init(generator, cfg.d_model, cfg.d_ff, dt,
                               device=device, lead=lead)

    le, ld = (_enc_layers(cfg),), (_dec_layers(cfg),)
    return {
        "enc_layers": {"attn_norm": norm(le), "attn": attn(le),
                       "mlp_norm": norm(le), "mlp": mlp(le)},
        "enc_final_norm": norm(()),
        "dec_embed": L.embedding_init(generator, vp, cfg.d_model, dt,
                                      device=device),
        "dec_layers": {"self_norm": norm(ld), "self_attn": attn(ld),
                       "cross_norm": norm(ld), "cross_attn": attn(ld),
                       "mlp_norm": norm(ld), "mlp": mlp(ld)},
        "dec_final_norm": norm(()),
    }


def encode(cfg, params, frames):
    """frames: (B, S_enc, d) stub embeddings → encoder states."""
    _, s, d = frames.shape
    x = frames.to(cfg.compute_dtype)
    x = x + L.sinusoidal_positions(s, d, x.device).to(x.dtype)[None]
    x = constrain(x, BATCH, None, None)

    def body(carry, lp):
        h = _norm(cfg, lp["attn_norm"], carry)
        a, _ = L.attention(lp["attn"], h, n_heads=cfg.n_heads,
                           n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
                           causal=False)
        x = carry + a
        h = _norm(cfg, lp["mlp_norm"], x)
        x = x + L.gelu_mlp(lp["mlp"], h)
        return constrain(x, BATCH, None, None), None

    x, _ = maybe_scan(_remat(cfg, body), x, params["enc_layers"])
    return _norm(cfg, params["enc_final_norm"], x)


def _dec_block(cfg, lp, x, enc_out, kv_cache, cache_index, cross_kv=None):
    h = _norm(cfg, lp["self_norm"], x)
    a, new_cache = L.attention(lp["self_attn"], h, n_heads=cfg.n_heads,
                               n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
                               causal=True, kv_cache=kv_cache,
                               cache_index=cache_index)
    x = x + a
    h = _norm(cfg, lp["cross_norm"], x)
    if cross_kv is None:
        b, se, _ = enc_out.shape
        ca = lp["cross_attn"]
        k = (enc_out @ ca["wk"].to(enc_out.dtype)
             + ca["bk"].to(enc_out.dtype)).reshape(b, se, cfg.n_kv_heads,
                                                   cfg.hd)
        v = (enc_out @ ca["wv"].to(enc_out.dtype)
             + ca["bv"].to(enc_out.dtype)).reshape(b, se, cfg.n_kv_heads,
                                                   cfg.hd)
        cross_kv = (k, v)
    a, _ = L.attention(lp["cross_attn"], h, n_heads=cfg.n_heads,
                       n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
                       causal=False, kv_override=cross_kv)
    x = x + a
    h = _norm(cfg, lp["mlp_norm"], x)
    x = x + L.gelu_mlp(lp["mlp"], h)
    return constrain(x, BATCH, None, None), new_cache, cross_kv


def _embed_tokens(cfg, params, tokens):
    """The decoder's token embeddings plus positions 0 .. S-1."""
    x = L.embed(params["dec_embed"], tokens, cfg.compute_dtype)
    pe = L.sinusoidal_positions(tokens.shape[1], cfg.d_model, x.device)
    return x + pe.to(x.dtype)[None]


def decode_train(cfg, params, enc_out, tokens):
    x = constrain(_embed_tokens(cfg, params, tokens), BATCH, None, None)

    def body(carry, lp):
        return _dec_block(cfg, lp, carry, enc_out, None, None)[0], None

    x, _ = maybe_scan(_remat(cfg, body), x, params["dec_layers"])
    return _norm(cfg, params["dec_final_norm"], x)


def make_encdec_model(cfg: ArchConfig) -> Model:
    vp = _vocab_padded(cfg)

    def init(generator=0, device=None):
        dev = init_device(device)
        return init_encdec(cfg, init_generator(generator, dev), dev)

    def _logits(params, hidden):
        # whisper ties the decoder unembedding to the token embedding
        table = params["dec_embed"]["table"]
        lg = hidden @ table.to(hidden.dtype).T
        return constrain(lg, BATCH, None, "model")

    def loss(params, batch):
        enc_out = encode(cfg, params, batch["frames"])
        hidden = decode_train(cfg, params, enc_out, batch["tokens"])
        lg = _logits(params, hidden)
        l = xent_loss(cfg, lg, batch["labels"])
        return l, {"xent": l}

    def prefill(params, batch, cache_len=None):
        """Encode + decoder prefill over the prompt tokens."""
        enc_out = encode(cfg, params, batch["frames"])
        tokens = batch["tokens"]
        b, s = tokens.shape
        x = _embed_tokens(cfg, params, tokens)
        cache0 = torch.zeros((_dec_layers(cfg), b, cache_len or s,
                              cfg.n_kv_heads, cfg.hd),
                             dtype=cfg.compute_dtype, device=x.device)

        def body(carry, xs):
            lp, ck, cv = xs
            x, nc, ckv = _dec_block(cfg, lp, carry, enc_out,
                                    {"k": ck, "v": cv}, 0)
            return x, (nc["k"], nc["v"], ckv[0], ckv[1])

        x, (ks, vs, cks, cvs) = maybe_scan(
            body, x, (params["dec_layers"], cache0, cache0))
        x = _norm(cfg, params["dec_final_norm"], x)
        lg = _logits(params, x[:, -1:, :])
        return lg, {"k": ks, "v": vs, "cross_k": cks, "cross_v": cvs,
                    "len": torch.full((), s, dtype=torch.int32,
                                      device=x.device)}

    def decode_step(params, cache, batch):
        pos = cache["len"]
        x = L.embed(params["dec_embed"], batch["tokens"], cfg.compute_dtype)
        # sinusoidal position at the current index: the table's row at
        # pos clamped into [0, max_cache_len)
        row = torch.clamp(pos, 0, cfg.max_cache_len - 1).reshape(1)
        x = x + L.sinusoidal_rows(row, cfg.d_model).to(x.dtype)[None]

        def body(carry, xs):
            lp, ck, cv, xk, xv = xs
            x, nc, _ = _dec_block(cfg, lp, carry, None, {"k": ck, "v": cv},
                                  pos, cross_kv=(xk, xv))
            return x, (nc["k"], nc["v"])

        x, (ks, vs) = maybe_scan(
            body, x, (params["dec_layers"], cache["k"], cache["v"],
                      cache["cross_k"], cache["cross_v"]))
        x = _norm(cfg, params["dec_final_norm"], x)
        lg = _logits(params, x)
        return lg, {"k": ks, "v": vs, "cross_k": cache["cross_k"],
                    "cross_v": cache["cross_v"], "len": pos + 1}

    def param_specs(axes: dict):
        model = axes.get("model", 1)
        a = "model" if cfg.n_heads % model == 0 else None
        kv = "model" if cfg.n_kv_heads % model == 0 else None
        ff = "model" if cfg.d_ff % model == 0 else None

        def attn_spec():
            return {"wq": (None, "data", a), "wk": (None, "data", kv),
                    "wv": (None, "data", kv), "wo": (None, a, "data"),
                    "bq": (None, a), "bk": (None, kv), "bv": (None, kv)}

        def mlp_spec():
            return {"w1": (None, "data", ff), "b1": (None, ff),
                    "w2": (None, ff, "data"), "b2": (None, None)}

        def norm_spec(lead=(None,)):
            spec = {"scale": (*lead, None)}
            if cfg.norm == "layernorm":
                spec["bias"] = (*lead, None)
            return spec

        return {
            "enc_layers": {"attn_norm": norm_spec(), "attn": attn_spec(),
                           "mlp_norm": norm_spec(), "mlp": mlp_spec()},
            "enc_final_norm": norm_spec(()),
            "dec_embed": {"table": ("model" if vp % model == 0 else None,
                                    "data")},
            "dec_layers": {"self_norm": norm_spec(),
                           "self_attn": attn_spec(),
                           "cross_norm": norm_spec(),
                           "cross_attn": attn_spec(),
                           "mlp_norm": norm_spec(), "mlp": mlp_spec()},
            "dec_final_norm": norm_spec(()),
        }

    def cache_specs(axes: dict):
        if cfg.n_kv_heads % axes.get("model", 1) == 0:
            kv = (None, BATCH, None, "model", None)
        else:   # flash-decode layout: shard the sequence dim
            kv = (None, BATCH, "model", None, None)
        return {"k": kv, "v": kv, "cross_k": kv, "cross_v": kv, "len": ()}

    def input_specs(shape, kind: str):
        """The batch's tensors for one shape and kind, on ``meta``."""
        b, s = shape["global_batch"], shape["seq_len"]
        se = min(cfg.max_source_len, s)

        def meta(shp, dtype):
            return torch.empty(shp, dtype=dtype, device="meta")

        frames = meta((b, se, cfg.d_model), cfg.compute_dtype)
        tok = meta((b, s), torch.int32)
        if kind == "train":
            return {"frames": frames, "tokens": tok,
                    "labels": meta((b, s), torch.int32)}
        if kind == "prefill":
            return {"frames": frames, "tokens": tok}
        if kind == "decode":
            return {"tokens": meta((b, 1), torch.int32)}
        raise ValueError(kind)

    def active_param_count() -> int:
        d = cfg.d_model
        attn = 2 * d * cfg.n_heads * cfg.hd + 2 * d * cfg.n_kv_heads * cfg.hd
        mlp = 2 * d * cfg.d_ff
        enc = _enc_layers(cfg) * (attn + mlp)
        dec = _dec_layers(cfg) * (2 * attn + mlp)
        return enc + dec + vp * d

    return Model(cfg=cfg, init=init, loss=loss, prefill=prefill,
                 decode_step=decode_step, param_specs=param_specs,
                 cache_specs=cache_specs, input_specs=input_specs,
                 param_count=count_params,
                 active_param_count=active_param_count)
