"""Shared neural layers: norms, rotary embeddings (RoPE / M-RoPE), GQA
attention (with KV cache), SwiGLU/GeLU MLPs, embeddings (counterpart of
``repro.models.layers``).

Plain functions on tensors: each layer is ``f(params, x, ...)`` with
params a dict; ``*_init`` builds params from a ``torch.Generator`` on
``device`` (``lead`` prepends the stacked layer axis). Layers compute in
the dtype of ``x`` and keep params in their stored dtype. The attention
is the reference's plain softmax attention (``_sdpa``: logits in fp32,
query blocks of ``ATTN_CHUNK``), not a kernel: the reference's model
path reaches no Pallas kernel.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

BATCH = ("pod", "data")
# the reference's masked logit: a row with every key masked gets a
# uniform softmax, not NaN
MASKED = -1e30
# elements drawn per fp32 temporary when a large leaf is initialised
_INIT_CHUNK = 1 << 26


def truncated_normal_init(generator, shape, scale, dtype, *, device):
    """Normal truncated to [-2, 2], times ``scale``, drawn in fp32 and
    cast to ``dtype`` (the reference's distribution; ``jax.random``'s
    stream itself cannot be replayed). On ``meta`` nothing is drawn."""
    shape = tuple(int(s) for s in shape)
    out = torch.empty(shape, dtype=dtype, device=device)
    if out.device.type == "meta" or out.numel() == 0:
        return out
    flat = out.view(-1)
    tmp = torch.empty(min(flat.numel(), _INIT_CHUNK), dtype=torch.float32,
                      device=out.device)
    for lo in range(0, flat.numel(), _INIT_CHUNK):
        part = tmp[:min(_INIT_CHUNK, flat.numel() - lo)]
        torch.nn.init.trunc_normal_(part, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        flat[lo:lo + part.numel()].copy_(part.mul_(scale))
    return out


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm_init(d: int, dtype=torch.float32, *, device, lead=()):
    return {"scale": torch.ones((*lead, d), dtype=dtype, device=device)}


def rmsnorm(params, x, eps: float = 1e-5):
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(dt)


def layernorm_init(d: int, dtype=torch.float32, *, device, lead=()):
    return {"scale": torch.ones((*lead, d), dtype=dtype, device=device),
            "bias": torch.zeros((*lead, d), dtype=dtype, device=device)}


def layernorm(params, x, eps: float = 1e-5):
    dt = x.dtype
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"].float()
            + params["bias"].float()).to(dt)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float = 10000.0, device=None):
    """Inverse frequencies for the even/odd rotary pairs: (head_dim//2,)."""
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def rope_table(positions, head_dim: int, theta: float = 10000.0,
               sections=None):
    """(sin, cos) of the rotation angles, fp32 (..., S, 1, hd/2), for
    positions (..., S); under M-RoPE (``sections``: 3 ints summing to
    hd//2) positions are (3, B, S) and stream i drives the i-th band of
    ``sections[i]`` frequency pairs — the reference's per-frequency
    stream selector, taken as slices so that nothing is copied to or read
    from the device. A forward pass builds it once for all its layers."""
    inv = rope_freqs(head_dim, theta, positions.device)     # (hd/2,)
    if sections is None:
        ang = positions[..., :, None, None].float() * inv
    else:
        if sum(sections) != head_dim // 2:
            raise ValueError("mrope sections must cover hd/2")
        bands, lo = [], 0
        for i, n in enumerate(sections):
            bands.append(positions[i, ..., :, None, None].float()
                         * inv[lo:lo + n])
            lo += n
        ang = torch.cat(bands, dim=-1)                      # (B,S,1,hd/2)
    return torch.sin(ang), torch.cos(ang)


def _rotate(x, table):
    """Rotate the interleaved pairs (x[..., 0::2], x[..., 1::2]) by the
    angles of ``table`` (sin, cos) and restack them in place of the
    pairs."""
    sin, cos = table
    x1 = x[..., 0::2].float()
    x2 = x[..., 1::2].float()
    r1 = x1 * cos - x2 * sin
    r2 = x1 * sin + x2 * cos
    return torch.stack([r1, r2], dim=-1).reshape(x.shape).to(x.dtype)


def apply_rope(x, positions, theta: float = 10000.0):
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    return _rotate(x, rope_table(positions, x.shape[-1], theta))


def apply_mrope(x, positions, sections, theta: float = 10000.0):
    """Multimodal RoPE (Qwen2-VL): 3 position streams (temporal, height,
    width) drive disjoint frequency bands.

    x: (B, S, H, hd); positions: (3, B, S); sections: 3 ints summing to
    hd//2 — how many frequency pairs each stream owns.
    """
    return _rotate(x, rope_table(positions, x.shape[-1], theta,
                                 tuple(sections)))


def sinusoidal_rows(positions, d: int):
    """Rows ``positions`` ((n,) integer tensor) of the sinusoidal table:
    (n, d) fp32 on the positions' device, each row the same elementwise
    arithmetic as ``sinusoidal_positions``'s, so equal to it bit for
    bit."""
    device = positions.device
    pos = positions.to(torch.float32)[:, None]
    div = torch.exp(-math.log(10000.0)
                    * torch.arange(0, d, 2, dtype=torch.float32,
                                   device=device) / d)
    pe = torch.zeros((pos.shape[0], d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


def sinusoidal_positions(s: int, d: int, device=None):
    """Whisper-style fixed sinusoidal embeddings: (s, d)."""
    return sinusoidal_rows(torch.arange(s, dtype=torch.int32,
                                        device=device), d)


# ---------------------------------------------------------------------------
# attention (GQA, optional KV cache, optional M-RoPE / no-RoPE)
# ---------------------------------------------------------------------------

def attention_init(generator, d_model: int, n_heads: int, n_kv_heads: int,
                   head_dim: int, dtype=torch.float32, with_bias=False, *,
                   device, lead=()):
    scale = 1.0 / math.sqrt(d_model)

    def w(shape):
        return truncated_normal_init(generator, (*lead, *shape), scale,
                                     dtype, device=device)

    p = {
        "wq": w((d_model, n_heads * head_dim)),
        "wk": w((d_model, n_kv_heads * head_dim)),
        "wv": w((d_model, n_kv_heads * head_dim)),
        "wo": w((n_heads * head_dim, d_model)),
    }
    if with_bias:
        for name, width in (("bq", n_heads), ("bk", n_kv_heads),
                            ("bv", n_kv_heads)):
            p[name] = torch.zeros((*lead, width * head_dim), dtype=dtype,
                                  device=device)
    return p


ATTN_CHUNK = 1024  # query-block size for the memory-bounded attention path


def _kv_quantize(x):
    """Per-(token, head) int8 quantization of K/V rows over head_dim.
    Returns (int8 codes, f32 scales (..., KV)); ``torch.round`` rounds
    half to even, as ``jnp.round`` does."""
    xf = x.float()
    scale = torch.amax(torch.abs(xf), dim=-1) / 127.0
    codes = torch.round(xf / torch.clamp(scale[..., None], min=1e-12))
    return codes.to(torch.int8), scale


def _kv_dequantize(codes, scale, dtype):
    return (codes.float() * scale[..., None]).to(dtype)


def _sdpa_block(q, k, v, scale, qpos, kpos, kmask=None):
    """One query block vs all keys. q: (B,cq,H,hd); k/v: (B,Sk,H,hd)."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = kpos[None, :] <= qpos[:, None]
    if kmask is not None:
        mask = mask & kmask[None, :]
    logits = logits.masked_fill(~mask[None, None], MASKED)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def _sdpa(q, k, v, causal: bool, q_offset=None, kmask_len=None):
    """q: (B,Sq,H,hd), k/v: (B,Sk,H,hd) — softmax attention.

    Long sequences are processed in query blocks of ATTN_CHUNK (the
    reference's ``lax.map``), so the live score tensor is
    (B,H,chunk,Sk) instead of (B,H,Sq,Sk).

    q_offset: position of q[0] within the key sequence (an int or a 0-d
    tensor: cached decode passes the cache length; default aligns the
    ends). kmask_len: keys at positions >= kmask_len are masked
    (partially filled caches).
    """
    sq, hd = q.shape[1], q.shape[3]
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    off = (sk - sq) if q_offset is None else q_offset
    kpos = torch.arange(sk, dtype=torch.int32, device=q.device)
    kmask = (kpos < kmask_len) if kmask_len is not None else None
    if not causal:
        qpos = torch.full((sq,), sk, dtype=torch.int32, device=q.device)
    else:
        qpos = torch.arange(sq, dtype=torch.int32, device=q.device) + off
    if sq <= ATTN_CHUNK:
        return _sdpa_block(q, k, v, scale, qpos, kpos, kmask)
    return torch.cat([_sdpa_block(q[:, lo:lo + ATTN_CHUNK], k, v, scale,
                                  qpos[lo:lo + ATTN_CHUNK], kpos, kmask)
                      for lo in range(0, sq, ATTN_CHUNK)], dim=1)


def _write_rows(cache, new, index):
    """``cache`` (B, Smax, ...) with rows index .. index + S - 1 replaced
    by ``new`` (B, S, ...), out of place. A one-token write is a masked
    select against the cache position (no host read of ``index``); a
    longer one copies at the start ``dynamic_update_slice`` would take
    (clamped so the rows fit)."""
    s, smax = int(new.shape[1]), int(cache.shape[1])
    new = new.to(cache.dtype)
    if s == 1:
        spos = torch.arange(smax, dtype=torch.int32, device=cache.device)
        hit = spos.view(1, smax, *([1] * (cache.dim() - 2))) == index
        return torch.where(hit, new, cache)
    start = torch.clamp(torch.as_tensor(index, device=cache.device),
                        0, smax - s)
    rows = start + torch.arange(s, device=cache.device)
    return cache.index_copy(1, rows, new)


def attention(params, x, *, n_heads: int, n_kv_heads: int, head_dim: int,
              rope=None, causal: bool = True, kv_cache=None,
              cache_index=None, kv_override=None):
    """GQA attention.

    x: (B, S, d). rope: the ``rope_table`` of x's positions (built once
    a forward for every layer), or None for no rotary embedding.
    kv_cache: optional dict {k, v}: (B, Smax, KV, hd) (+ k_scale /
    v_scale under kv_quant) and cache_index (an int or a 0-d int32
    tensor) — decode appends at cache_index and attends to the prefix.
    kv_override: (k, v), each (B, Sk, KV, hd), for cross-attention: the
    keys and values are taken as given, not projected from x (nor
    rotated). Returns (out, new_kv_cache).
    """
    b, s, _ = x.shape
    q = x @ params["wq"].to(x.dtype)
    if "bq" in params:
        q = q + params["bq"].to(x.dtype)
    q = q.reshape(b, s, n_heads, head_dim)
    if rope is not None:
        q = _rotate(q, rope)
    if kv_override is None:
        k = x @ params["wk"].to(x.dtype)
        v = x @ params["wv"].to(x.dtype)
        if "bk" in params:
            k = k + params["bk"].to(x.dtype)
            v = v + params["bv"].to(x.dtype)
        k = k.reshape(b, s, n_kv_heads, head_dim)
        v = v.reshape(b, s, n_kv_heads, head_dim)
        if rope is not None:
            k = _rotate(k, rope)
    else:
        k, v = kv_override

    new_cache = None
    valid_len = None
    if kv_cache is not None:
        quant = "k_scale" in kv_cache
        if quant:
            k_store, k_scale = _kv_quantize(k)
            v_store, v_scale = _kv_quantize(v)
        else:
            k_store, v_store = k, v
        new_cache = {"k": _write_rows(kv_cache["k"], k_store, cache_index),
                     "v": _write_rows(kv_cache["v"], v_store, cache_index)}
        if quant:
            new_cache["k_scale"] = _write_rows(kv_cache["k_scale"], k_scale,
                                               cache_index)
            new_cache["v_scale"] = _write_rows(kv_cache["v_scale"], v_scale,
                                               cache_index)
            k = _kv_dequantize(new_cache["k"], new_cache["k_scale"], x.dtype)
            v = _kv_dequantize(new_cache["v"], new_cache["v_scale"], x.dtype)
        else:
            k, v = new_cache["k"], new_cache["v"]
        # mask out cache slots beyond cache_index + s
        valid_len = cache_index + s

    groups = n_heads // n_kv_heads
    if groups > 1:
        k = torch.repeat_interleave(k, groups, dim=2)
        v = torch.repeat_interleave(v, groups, dim=2)

    if kv_cache is not None:
        # decode/cached path: causal against absolute positions, with the
        # unwritten cache tail masked
        out = _sdpa(q, k, v, causal=True, q_offset=cache_index,
                    kmask_len=valid_len)
    else:
        out = _sdpa(q, k, v, causal)

    out = out.reshape(b, s, n_heads * head_dim)
    return out @ params["wo"].to(x.dtype), new_cache


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def swiglu_init(generator, d_model: int, d_ff: int, dtype=torch.float32, *,
                device, lead=()):
    s1 = 1.0 / math.sqrt(d_model)
    s2 = 1.0 / math.sqrt(d_ff)

    def w(shape, scale):
        return truncated_normal_init(generator, (*lead, *shape), scale,
                                     dtype, device=device)

    return {
        "w1": w((d_model, d_ff), s1),  # gate
        "w3": w((d_model, d_ff), s1),  # up
        "w2": w((d_ff, d_model), s2),  # down
    }


def swiglu(params, x):
    g = F.silu(x @ params["w1"].to(x.dtype))
    u = x @ params["w3"].to(x.dtype)
    return (g * u) @ params["w2"].to(x.dtype)


def gelu_mlp_init(generator, d_model: int, d_ff: int, dtype=torch.float32,
                  *, device, lead=()):
    def w(shape, scale):
        return truncated_normal_init(generator, (*lead, *shape), scale,
                                     dtype, device=device)

    return {
        "w1": w((d_model, d_ff), 1.0 / math.sqrt(d_model)),
        "b1": torch.zeros((*lead, d_ff), dtype=dtype, device=device),
        "w2": w((d_ff, d_model), 1.0 / math.sqrt(d_ff)),
        "b2": torch.zeros((*lead, d_model), dtype=dtype, device=device),
    }


def gelu_mlp(params, x):
    # jax.nn.gelu's default is the tanh approximation
    h = F.gelu(x @ params["w1"].to(x.dtype) + params["b1"].to(x.dtype),
               approximate="tanh")
    return h @ params["w2"].to(x.dtype) + params["b2"].to(x.dtype)


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------

def embedding_init(generator, vocab: int, d_model: int, dtype=torch.float32,
                   *, device):
    return {"table": truncated_normal_init(generator, (vocab, d_model), 0.02,
                                           dtype, device=device)}


def embed(params, ids, dtype):
    return F.embedding(ids.long(), params["table"].to(dtype))


def unembed(params, x, table=None):
    """Project to vocab logits; `table` for tied embeddings."""
    w = table if table is not None else params["out"]
    return x @ w.to(x.dtype)
