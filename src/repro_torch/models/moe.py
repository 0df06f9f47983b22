"""Mixture-of-Experts FFN with Gunrock frontier-style dispatch
(counterpart of ``repro.models.moe``).

Token→expert routing is a bipartite V→E *advance*: each token expands to
its top-k expert edges; capacity enforcement is Gunrock's *inexact
filter* (over-capacity items culled); the gather into per-expert buffers
is the data movement; the weighted combine is a *neighborhood reduction*
back onto tokens.

The token stream is viewed as (D, t_local), D the data shards of the
active mesh (1 on one card), and the routing, sort and compaction run
per shard, as the reference's do. Where the reference's ops leave an
order to the backend, the port fixes it:
  * top-k is a stable descending sort (ties: the lower expert first, as
    ``lax.top_k``); ``torch.topk`` promises no tie order;
  * dropped pairs carry slot ``e * cap`` (out of range, the reference's
    ``mode="drop"``): they scatter into a spare column that is cut off;
  * the combine adds each token's k slot outputs one after the other in
    ascending slot order, starting from zero — the order the reference's
    scatter-add takes on the CPU — with no atomics, so two runs of one
    batch on the card give the same bits.
The expert products are plain ``torch.einsum``, as the reference's are
plain jnp.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..parallel.sharding import mesh_axis_size
from . import layers as L

BATCH = ("pod", "data")


def moe_init(generator, cfg, dtype, *, device, lead=()):
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_expert
    s1 = 1.0 / math.sqrt(d)
    s2 = 1.0 / math.sqrt(f)

    def w(shape, scale, dt):
        return L.truncated_normal_init(generator, (*lead, *shape), scale, dt,
                                       device=device)

    p = {
        "router": w((d, e), s1, torch.float32),
        "w1": w((e, d, f), s1, dtype),
        "w3": w((e, d, f), s1, dtype),
        "w2": w((e, f, d), s2, dtype),
    }
    if cfg.weight_quant:
        # int8 weight-only serving: per-(expert, out-column) absmax scales
        for name in ("w1", "w3", "w2"):
            p[name], p[f"{name}_scale"] = _quantize_columns(p[name])
    if cfg.n_shared_experts:
        p["shared"] = L.swiglu_init(generator, d,
                                    cfg.d_expert * cfg.n_shared_experts,
                                    dtype, device=device, lead=lead)
    return p


def _quantize_columns(w):
    """(int8 codes, fp32 scales) of ``w`` (..., e, in, out): one absmax
    scale per (expert, out column)."""
    if w.device.type == "meta":
        return (torch.empty(w.shape, dtype=torch.int8, device="meta"),
                torch.empty((*w.shape[:-2], w.shape[-1]),
                            dtype=torch.float32, device="meta"))
    full = w.float()
    scale = torch.amax(torch.abs(full), dim=-2) / 127.0       # (..., e, out)
    codes = torch.round(full / torch.clamp(scale.unsqueeze(-2), min=1e-12))
    return codes.to(torch.int8), scale


def _wq(params, name, dtype):
    """Fetch an expert weight, dequantizing int8 storage if present."""
    w = params[name]
    if w.dtype == torch.int8:
        scale = params[f"{name}_scale"]
        return (w.float() * scale[:, None, :]).to(dtype)
    return w.to(dtype)


def _num_data_shards() -> int:
    d = 1
    for a in BATCH:
        d *= mesh_axis_size(a)
    return d


def _capacity(t_local: int, cfg) -> int:
    c = math.ceil(t_local * cfg.top_k / cfg.n_experts
                  * cfg.capacity_factor)
    return max(8 * math.ceil(c / 8), 8)


def _top_k(probs, k: int):
    """(values, indices) of the k largest along the last axis, the lower
    index first among equal values (a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(params, x3, cfg, cap: int):
    """The dispatch of ``moe_ffn`` for x3 (D, t_local, d): returns probs,
    the routed pairs ``flat_e`` (D, tl·k) int32, their slots in pair
    order ``pair_slot`` (D, tl·k) int64 (``e * cap`` where dropped),
    ``keep`` in sorted order, and the slot tables ``slot_tok`` (D, e·cap)
    int32 (-1 where empty) and ``slot_gate`` (D, e·cap) fp32."""
    dsh, tl, _ = x3.shape
    e, k = cfg.n_experts, cfg.top_k
    dev = x3.device
    logits = x3.float() @ params["router"]
    probs = torch.softmax(logits, dim=-1)
    gate, expert = _top_k(probs, k)                  # (D, tl, k)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)

    flat_e = expert.reshape(dsh, tl * k).to(torch.int32)
    flat_g = gate.reshape(dsh, tl * k)
    flat_tok = torch.arange(tl, dtype=torch.int32, device=dev) \
        .repeat_interleave(k).expand(dsh, tl * k)

    # --- LB dispatch: per-shard sort by expert (frontier compaction) -----
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, -1, order)
    sorted_tok = torch.gather(flat_tok, -1, order)
    sorted_g = torch.gather(flat_g, -1, order)
    experts = torch.arange(e, dtype=torch.int32, device=dev) \
        .expand(dsh, e).contiguous()
    seg_start = torch.searchsorted(sorted_e, experts, right=False)  # (D, E)
    rank = torch.arange(tl * k, device=dev)[None] \
        - torch.gather(seg_start, -1, sorted_e.long())
    keep = rank < cap                                # inexact filter
    slot = torch.where(keep, sorted_e.long() * cap + rank, e * cap)

    # kept slots are distinct; dropped pairs land in the spare column e·cap
    slot_tok = torch.full((dsh, e * cap + 1), -1, dtype=torch.int32,
                          device=dev)
    slot_tok.scatter_(-1, slot, torch.where(keep, sorted_tok, -1))
    slot_gate = torch.zeros((dsh, e * cap + 1), dtype=torch.float32,
                            device=dev)
    slot_gate.scatter_(-1, slot, torch.where(keep, sorted_g, 0.0))
    pair_slot = torch.empty_like(slot).scatter_(-1, order, slot)
    return (probs, flat_e, pair_slot, keep, slot_tok[:, :e * cap],
            slot_gate[:, :e * cap])


def moe_ffn(params, x, cfg):
    """x: (B, S, d) → (B, S, d) plus aux metrics dict."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    dsh = _num_data_shards()
    if t % dsh != 0:
        dsh = 1
    tl = t // dsh                                    # tokens per shard
    cap = _capacity(tl, cfg)
    x3 = x.reshape(dsh, tl, d)
    probs, flat_e, pair_slot, keep, slot_tok, slot_gate = route(
        params, x3, cfg, cap)
    slot_tok = slot_tok.reshape(dsh, e, cap)
    slot_gate = slot_gate.reshape(dsh, e, cap).to(x.dtype)
    mask2 = slot_tok >= 0

    # --- gather tokens into expert buffers (shard-local) ------------------
    rows = torch.arange(dsh, device=x.device)[:, None, None]
    xin = x3[rows, torch.where(mask2, slot_tok, 0).long()]
    xin = torch.where(mask2[..., None], xin, torch.zeros((), dtype=x.dtype,
                                                         device=x.device))

    # --- expert SwiGLU (dense per-expert einsums) -------------------------
    w1 = _wq(params, "w1", x.dtype)
    w3 = _wq(params, "w3", x.dtype)
    w2 = _wq(params, "w2", x.dtype)
    g = F.silu(torch.einsum("xecd,edf->xecf", xin, w1))
    u = torch.einsum("xecd,edf->xecf", xin, w3)
    eo = torch.einsum("xecf,efd->xecd", g * u, w2)
    eo = eo * slot_gate[..., None]

    # --- combine (neighborhood reduction back onto tokens) ----------------
    # each token's k slots in ascending order (a dropped pair's e·cap
    # sorts last and reads the zero row), added one after the other
    eo_ext = torch.cat([eo.reshape(dsh, e * cap, d),
                        torch.zeros((dsh, 1, d), dtype=x.dtype,
                                    device=x.device)], dim=1)
    slots = torch.sort(pair_slot.reshape(dsh, tl, k), dim=-1).values
    parts = eo_ext[torch.arange(dsh, device=x.device)[:, None, None], slots]
    y3 = torch.zeros((dsh, tl, d), dtype=x.dtype, device=x.device)
    for j in range(k):
        y3 = y3 + parts[:, :, j]
    y2 = y3.reshape(t, d)

    if cfg.n_shared_experts:
        y2 = y2 + L.swiglu(params["shared"], x.reshape(t, d))

    # load-balance aux loss (Switch-style) + drop-rate metric
    me = torch.mean(probs, dim=(0, 1))               # (e,)
    ce = torch.zeros((e,), dtype=torch.float32, device=x.device).index_add_(
        0, flat_e.reshape(-1).long(),
        torch.full((t * k,), 1.0 / (t * k), dtype=torch.float32,
                   device=x.device))
    aux = {"moe_aux_loss": e * torch.sum(me * ce),
           "moe_drop_frac": 1.0 - torch.sum(keep, dtype=torch.float32)
           / (t * k)}
    return y2.reshape(b, s, d), aux
