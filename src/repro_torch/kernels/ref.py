"""The plain PyTorch version of every CUDA kernel (counterpart of
``repro.kernels.ref``).

The graph kernels' plain versions are the ``"torch"`` registry providers
of the same ops — the bit-exact twins of the reference's ``xla``
providers — so the CUDA kernels are held against exactly what the CPU
tests hold against the reference. ``lb_expand``, ``flash_attention`` and
``moe_gather`` are the counterparts of the reference's oracles
``lb_expand_ref``, ``flash_attention_ref`` and ``moe_gather_ref``. The
kernel wrappers in ``kernels.ops`` run these on CPU tensors;
``chip_smoke.py`` runs them on the card to compare.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core.frontier import _compact_torch as compact
from ..core.operators import _advance_batch_torch as advance_batch
from ..core.operators import _advance_filter_batch_torch as advance_filter_batch
from ..core.operators import _segment_locate_torch as segment_locate
from ..core.operators import _segment_search_torch as segment_search
from ..linalg.ops import _spmm_torch as spmm
from ..linalg.ops import _spmv_torch as spmv

__all__ = ["KExpansion", "advance_batch", "advance_filter_batch", "compact",
           "flash_attention", "lb_expand", "moe_gather", "segment_locate",
           "segment_search", "spmm", "spmv"]


class KExpansion(NamedTuple):
    in_pos: torch.Tensor
    rank: torch.Tensor
    valid: torch.Tensor
    total: torch.Tensor


def lb_expand(offsets: torch.Tensor, cap_out: int):
    """LB expansion geometry: offsets (cap_in+1,) int32, the exclusive
    scan of the segment sizes with the total last → (in_pos, rank,
    valid) (cap_out,), int32, int32 and bool: each slot's segment (the
    upper bound of the slot in offsets[:-1], less one, clipped to a
    segment), its rank there, and slot < total."""
    cap_in = int(offsets.shape[0]) - 1
    slots = torch.arange(cap_out, dtype=torch.int32, device=offsets.device)
    in_pos = torch.searchsorted(offsets[:-1].contiguous(), slots, right=True,
                                out_int32=True) - 1
    in_pos = in_pos.clamp_(0, max(cap_in - 1, 0))
    rank = slots - torch.index_select(offsets, 0, in_pos)
    return in_pos, rank, slots < offsets[-1]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Single-head attention, q (Sq, D), k and v (Sk, D), in fp32 with
    the end-aligned causal mask (query i sees keys j <= i + Sk - Sq); a
    row that sees no key is 0. Output in q's type."""
    sq, d = q.shape
    sk = k.shape[0]
    logits = (q.float() @ k.float().T) * (1.0 / math.sqrt(d))
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        kpos = torch.arange(sk, device=q.device)[None, :]
        logits = logits.masked_fill(kpos > qpos, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    p = torch.where(torch.isnan(p), 0.0, p)
    return (p @ v.float()).to(q.dtype)


def moe_gather(x: torch.Tensor, slot_token: torch.Tensor) -> torch.Tensor:
    """out[s] = x[slot_token[s]] for x (T, D), a zero row where
    slot_token[s] < 0; ids past the last token read the last row, as
    JAX's gather clamps them. Output (S, D) in x's type."""
    t = x.shape[0]
    mask = slot_token >= 0
    if t == 0:
        return x.new_zeros((slot_token.shape[0], x.shape[1]))
    safe = torch.where(mask, slot_token, 0).clamp_(max=t - 1).long()
    rows = torch.index_select(x, 0, safe)
    return torch.where(mask[:, None], rows, x.new_zeros(()))
