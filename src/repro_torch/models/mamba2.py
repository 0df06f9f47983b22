"""Mamba2 (state-space duality / SSD) — arXiv:2405.21060 (counterpart of
``repro.models.mamba2``).

Chunked SSD algorithm: the sequence is split into chunks of Q tokens;
within a chunk the recurrence is computed in its 'attention dual' form
(lower-triangular decay matrix — dense matmuls), and chunk boundary
states are propagated by a loop of S/Q steps (the reference's
``lax.scan``). Decode is the O(1)-state recurrence.

Per-layer structure follows the reference implementation: fused in_proj →
(z, x, B, C, dt), causal depthwise conv over (x,B,C), SSD core, gated
RMSNorm, out_proj. n_groups = 1 (B/C shared across heads).

Precision is the reference's: ``dt``, the decays and the SSM state are
float32 whatever the compute dtype, and where a product mixes them with
the bf16 streams (x, B, C) the bf16 operand is widened first — JAX
promotes bf16 with f32 to f32, ``torch.einsum`` refuses the mix.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..parallel.sharding import constrain
from . import layers as L
from .api import (ArchConfig, Model, count_params, init_device,
                  init_generator, maybe_scan)
from .transformer import (_norm, _norm_init, _remat, _vocab_padded,
                          logits_fn, xent_loss)

BATCH = ("pod", "data")


def _dims(cfg: ArchConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    nh = d_inner // cfg.ssm_head_dim
    ds = cfg.ssm_state
    conv_dim = d_inner + 2 * ds          # x, B, C streams get the conv
    return d_inner, nh, ds, conv_dim


def mamba2_layer_init(generator, cfg: ArchConfig, dtype, *, device,
                      lead=()):
    """One layer's params, every leaf with ``lead`` prepended (the
    stacked layer axis)."""
    d = cfg.d_model
    d_inner, nh, ds, conv_dim = _dims(cfg)
    in_dim = 2 * d_inner + 2 * ds + nh

    def w(shape, scale):
        return L.truncated_normal_init(generator, (*lead, *shape), scale,
                                       dtype, device=device)

    def f32(values):
        return values.to(device).expand(*lead, nh).clone()

    return {
        "norm": _norm_init(cfg, device=device, lead=lead),
        "in_proj": w((d, in_dim), 1.0 / math.sqrt(d)),
        "conv_w": w((cfg.ssm_conv, conv_dim), 0.5),
        "conv_b": torch.zeros((*lead, conv_dim), dtype=dtype, device=device),
        "A_log": f32(torch.log(torch.linspace(1.0, 16.0, nh,
                                              dtype=torch.float32))),
        "D": f32(torch.ones((nh,), dtype=torch.float32)),
        "dt_bias": f32(torch.zeros((nh,), dtype=torch.float32)),
        "gate_norm": {"scale": torch.ones((*lead, d_inner),
                                          dtype=torch.float32,
                                          device=device)},
        "out_proj": w((d_inner, d), 1.0 / math.sqrt(d_inner)),
    }


def _causal_conv(xbc, w, b, state=None):
    """Depthwise causal conv. xbc: (B,S,C); w: (K,C). state: (B,K-1,C)
    prefix for decode. Returns (out, new_state): the new state is the
    last K-1 rows of [state | xbc], which is the reference's
    ``full[:, s:s+k-1]`` when S >= K-1 and its concatenated tail when
    S < K-1."""
    k = w.shape[0]
    bsz, s, c = xbc.shape
    if state is None:
        pad = torch.zeros((bsz, k - 1, c), dtype=xbc.dtype, device=xbc.device)
    else:
        pad = state.to(xbc.dtype)
    full = torch.cat([pad, xbc], dim=1)                 # (B, S+K-1, C)
    out = torch.zeros((bsz, s, c), dtype=torch.float32, device=xbc.device)
    for i in range(k):
        out = out + full[:, i:i + s, :].float() * w[i].float()
    out = F.silu(out + b.float()).to(xbc.dtype)
    return out, full[:, s:, :]


def _segsum(x):
    """exp-friendly segment sums: out[..., i, j] = Σ_{j<k<=i} x[..., k]."""
    q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    return out.masked_fill(~mask, -math.inf)


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int, h0=None):
    """Chunked SSD scan.

    x: (B,S,H,P) inputs; dt: (B,S,H) softplus'd steps (f32); A: (H,)
    negative (f32); Bm/Cm: (B,S,N) shared across heads (n_groups=1).
    Returns (y: (B,S,H,P) in x's dtype, final_state: (B,H,N,P) f32).
    """
    bsz, s, h, p = x.shape
    n = Bm.shape[-1]
    q = min(chunk, s)
    s_pad = -(-s // q) * q
    if s_pad != s:
        # ragged tail: pad with dt=0 steps (decay 1, zero input — identity
        # on the state); padded outputs are sliced off below.
        pad = s_pad - s
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    nc = s_pad // q

    xc = x.reshape(bsz, nc, q, h, p)
    dtc = dt.reshape(bsz, nc, q, h)
    bc = Bm.reshape(bsz, nc, q, n)
    cc = Cm.reshape(bsz, nc, q, n)

    dA = dtc * A[None, None, None, :]                  # (B,nc,Q,H) ≤ 0
    cum = torch.cumsum(dA, dim=2)                      # (B,nc,Q,H)

    # intra-chunk (attention dual): scores shared across heads, decay per
    # head, Lmat[b,c,h,i,j] = exp(Σ_{j<k<=i} dA_k) via segsum
    lmat = torch.exp(_segsum(dA.permute(0, 1, 3, 2)))  # (B,nc,H,Q,Q)
    scores = torch.einsum("bcqn,bckn->bcqk", cc, bc)   # (B,nc,Q,Q), x's
    m = scores[:, :, None] * lmat                      # (B,nc,H,Q,Q) f32
    dx = dtc[..., None] * xc                           # dt ⊙ x, f32
    y_intra = torch.einsum("bchqk,bckhp->bcqhp", m, dx)

    # chunk states: S_c = Σ_j exp(cum_end - cum_j) dt_j B_j x_j^T
    decay_end = torch.exp(cum[:, :, -1:, :] - cum)     # (B,nc,Q,H)
    sc = torch.einsum("bckn,bckh,bckhp->bchnp", bc.float(),
                      decay_end * dtc, xc.float())

    # inter-chunk recurrence over nc steps: hprevs[c] is the state
    # entering chunk c
    chunk_decay = torch.exp(cum[:, :, -1, :])          # (B,nc,H)
    hstate = (torch.zeros((bsz, h, n, p), dtype=torch.float32,
                          device=x.device)
              if h0 is None else h0.float())
    hprevs = []
    for c in range(nc):
        hprevs.append(hstate)
        hstate = hstate * chunk_decay[:, c, :, None, None] + sc[:, c]
    hprevs = torch.stack(hprevs, dim=1)                # (B,nc,H,N,P)

    y_inter = torch.einsum("bcqn,bchnp,bcqh->bcqhp", cc.float(), hprevs,
                           torch.exp(cum))
    y = (y_intra + y_inter).reshape(bsz, s_pad, h, p)[:, :s]
    return y.to(x.dtype), hstate


def ssd_decode(x, dt, A, Bm, Cm, hprev):
    """Single-token recurrence. x: (B,1,H,P); hprev: (B,H,N,P) f32."""
    dA = torch.exp(dt[:, 0, :, None, None] * A[None, :, None, None])
    dBx = torch.einsum("bn,bh,bhp->bhnp", Bm[:, 0].float(), dt[:, 0],
                       x[:, 0].float())
    hnew = hprev * dA + dBx
    y = torch.einsum("bn,bhnp->bhp", Cm[:, 0].float(), hnew)
    return y[:, None].to(x.dtype), hnew


def mamba2_block(cfg, lp, x, ssm_state=None, conv_state=None,
                 decode: bool = False):
    """x: (B,S,d). Returns (out, new_ssm_state, new_conv_state)."""
    d_inner, nh, ds, conv_dim = _dims(cfg)
    bsz, s, _ = x.shape
    h = _norm(cfg, lp["norm"], x)
    zxbcdt = h @ lp["in_proj"].to(h.dtype)
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner:d_inner + conv_dim]      # x, B, C streams
    dt = zxbcdt[..., d_inner + conv_dim:]
    xbc, new_conv = _causal_conv(xbc, lp["conv_w"], lp["conv_b"],
                                 conv_state)
    xs, bm, cm = torch.split(xbc, [d_inner, ds, ds], dim=-1)
    xs = xs.reshape(bsz, s, nh, cfg.ssm_head_dim)
    xs = constrain(xs, BATCH, None, "model", None)
    a = -torch.exp(lp["A_log"])
    dt = F.softplus(dt.float() + lp["dt_bias"][None, None, :])
    if decode:
        y, new_ssm = ssd_decode(xs, dt, a, bm, cm, ssm_state)
    else:
        y, new_ssm = ssd_chunked(xs, dt, a, bm, cm, cfg.ssm_chunk,
                                 h0=ssm_state)
    y = y + lp["D"][None, None, :, None].to(y.dtype) * xs
    y = y.reshape(bsz, s, d_inner)
    # gated RMSNorm (mamba2's norm-before-out)
    y = L.rmsnorm(lp["gate_norm"], y * F.silu(z.float()).to(y.dtype),
                  cfg.norm_eps)
    out = y @ lp["out_proj"].to(y.dtype)
    return x + out, new_ssm, new_conv


def init_mamba2(cfg: ArchConfig, generator, device) -> dict:
    """The reference's tree (``init_mamba2``), layers stacked on a
    leading (n_layers,) axis."""
    vp = _vocab_padded(cfg)
    dt = cfg.param_dtype
    params = {
        "embed": L.embedding_init(generator, vp, cfg.d_model, dt,
                                  device=device),
        "layers": mamba2_layer_init(generator, cfg, dt, device=device,
                                    lead=(cfg.n_layers,)),
        "final_norm": _norm_init(cfg, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.truncated_normal_init(
            generator, (cfg.d_model, vp), 1.0 / math.sqrt(cfg.d_model), dt,
            device=device)
    return params


def _token_input_specs(shape, kind: str) -> dict:
    """The token batch of one shape and kind, on ``meta`` (the ssm and
    hybrid families' ``input_specs``)."""
    b, s = shape["global_batch"], shape["seq_len"]

    def tok(width):
        return torch.empty((b, width), dtype=torch.int32, device="meta")

    if kind == "train":
        return {"tokens": tok(s), "labels": tok(s)}
    if kind == "prefill":
        return {"tokens": tok(s)}
    if kind == "decode":
        return {"tokens": tok(1)}
    raise ValueError(kind)


def make_mamba2_model(cfg: ArchConfig) -> Model:
    d_inner, nh, ds, conv_dim = _dims(cfg)

    def init(generator=0, device=None):
        dev = init_device(device)
        return init_mamba2(cfg, init_generator(generator, dev), dev)

    def forward(params, tokens):
        x = L.embed(params["embed"], tokens, cfg.compute_dtype)
        x = constrain(x, BATCH, None, None)

        def body(carry, lp):
            return mamba2_block(cfg, lp, carry)[0], None

        x, _ = maybe_scan(_remat(cfg, body), x, params["layers"])
        return _norm(cfg, params["final_norm"], x)

    def loss(params, batch):
        hidden = forward(params, batch["tokens"])
        lg = logits_fn(cfg, params, hidden)
        l = xent_loss(cfg, lg, batch["labels"])
        return l, {"xent": l}

    def prefill(params, batch, cache_len=None):
        # cache_len accepted for API uniformity; SSM state is O(1) in
        # sequence length so there is nothing to size.
        tokens = batch["tokens"]
        s = tokens.shape[1]
        x = L.embed(params["embed"], tokens, cfg.compute_dtype)

        def body(carry, lp):
            x, hs, cs = mamba2_block(cfg, lp, carry)
            return x, (hs, cs)

        x, (hs, cs) = maybe_scan(body, x, params["layers"])
        x = _norm(cfg, params["final_norm"], x)
        lg = logits_fn(cfg, params, x[:, -1:, :])
        return lg, {"ssm": hs, "conv": cs,
                    "len": torch.full((), s, dtype=torch.int32,
                                      device=x.device)}

    def decode_step(params, cache, batch):
        x = L.embed(params["embed"], batch["tokens"], cfg.compute_dtype)

        def body(carry, xs):
            lp, hs, cs = xs
            x, nh_, nc_ = mamba2_block(cfg, lp, carry, ssm_state=hs,
                                       conv_state=cs, decode=True)
            return x, (nh_, nc_)

        x, (hs, cs) = maybe_scan(body, x, (params["layers"], cache["ssm"],
                                           cache["conv"]))
        x = _norm(cfg, params["final_norm"], x)
        lg = logits_fn(cfg, params, x)
        return lg, {"ssm": hs, "conv": cs, "len": cache["len"] + 1}

    def param_specs(axes: dict):
        model = axes.get("model", 1)
        vp = _vocab_padded(cfg)
        hm = "model" if nh % model == 0 else None
        layer = {
            "norm": {"scale": (None, None)},
            "in_proj": (None, "data", hm),
            "conv_w": (None, None, None),
            "conv_b": (None, None),
            "A_log": (None, hm),
            "D": (None, hm),
            "dt_bias": (None, hm),
            "gate_norm": {"scale": (None, hm)},
            "out_proj": (None, hm, "data"),
        }
        specs = {
            "embed": {"table": ("model" if vp % model == 0 else None,
                                "data")},
            "layers": layer,
            "final_norm": {"scale": (None,)},
        }
        if not cfg.tie_embeddings:
            specs["lm_head"] = ("data", "model" if vp % model == 0 else None)
        return specs

    def cache_specs(axes: dict):
        hm = "model" if nh % axes.get("model", 1) == 0 else None
        return {"ssm": (None, BATCH, hm, None, None),
                "conv": (None, BATCH, None, None),
                "len": ()}

    def active_param_count() -> int:
        vp = _vocab_padded(cfg)
        per_layer = (cfg.d_model * (2 * d_inner + 2 * ds + nh)
                     + cfg.ssm_conv * conv_dim + d_inner * cfg.d_model)
        emb = vp * cfg.d_model * (1 if cfg.tie_embeddings else 2)
        return cfg.n_layers * per_layer + emb

    return Model(cfg=cfg, init=init, loss=loss, prefill=prefill,
                 decode_step=decode_step, param_specs=param_specs,
                 cache_specs=cache_specs, input_specs=_token_input_specs,
                 param_count=count_params,
                 active_param_count=active_param_count)
