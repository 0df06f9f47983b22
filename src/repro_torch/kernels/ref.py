"""The plain PyTorch version of every CUDA kernel (counterpart of
``repro.kernels.ref``).

The graph kernels' plain versions are the ``"torch"`` registry providers
of the same ops — the bit-exact twins of the reference's ``xla``
providers — so the CUDA kernels are held against exactly what the CPU
tests hold against the reference. ``lb_expand``, ``flash_attention`` and
``moe_gather`` are the counterparts of the reference's oracles
``lb_expand_ref``, ``flash_attention_ref`` and ``moe_gather_ref``;
``attention_partials`` and ``attention_combine`` are the plain versions
of K7's split form and of its combine kernel, and model the kernel's
arithmetic: its kv parts, and its products in pieces of the input type
(``tf32_round``). The
kernel wrappers in ``kernels.ops`` run these on CPU tensors;
``chip_smoke.py`` runs them on the card to compare.

The reference's oracle names (``lb_expand_ref``, ``spmv_ell_ref``,
``semiring_ell_ref``, ``segment_search_ref``, ``filter_compact_ref``,
``flash_attention_ref``, ``moe_gather_ref``) are here too, with its
contracts: plain PyTorch specifications, never a kernel.
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

__all__ = ["ATTN_BQ", "KExpansion", "advance_batch", "advance_filter_batch",
           "attention_combine", "attention_kv_tile", "attention_partials",
           "compact", "flash_attention", "lb_expand", "lb_offsets",
           "moe_gather", "segment_locate", "segment_search", "spmm", "spmv",
           "tf32_round", "lb_expand_ref", "spmv_ell_ref", "semiring_ell_ref",
           "segment_search_ref", "filter_compact_ref", "flash_attention_ref",
           "moe_gather_ref"]

ATTN_BQ = 64                   # K7's queries per block (kBQ)
ATTN_NEG = -1e30               # the reference's NEG_INF
ATTN_P16_SCALE = 4096.0        # fp16's p scale before its split (2^12)


class KExpansion(NamedTuple):
    in_pos: torch.Tensor
    rank: torch.Tensor
    valid: torch.Tensor
    total: torch.Tensor


def lb_offsets(sizes: torch.Tensor) -> torch.Tensor:
    """(cap_in+1,) int32 exclusive scan of ``sizes`` with the total last,
    saturating at INT32_MAX as K6's scan does (the reference wrapper's
    int32 cumsum wraps past it): the plain version's input where K6's
    wrapper takes the sizes."""
    incl = torch.cumsum(sizes, 0, dtype=torch.int64).clamp_(max=2 ** 31 - 1)
    return torch.cat([sizes.new_zeros(1, dtype=torch.int32),
                      incl.to(torch.int32)])


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
                    causal: bool = True, scale=None) -> torch.Tensor:
    """Single-head attention, q (Sq, D), k and v (Sk, D), in fp32 with
    the end-aligned causal mask (query i sees keys j <= i + Sk - Sq) and
    the scores scaled by ``scale`` (1/sqrt(D) by default); a row that
    sees no key is 0. Output in q's type."""
    sq, d = q.shape
    sk = k.shape[0]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    logits = (q.float() @ k.float().T) * scale
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        kpos = torch.arange(sk, device=q.device)[None, :]
        logits = logits.masked_fill(kpos > qpos, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    p = torch.where(torch.isnan(p), 0.0, p)
    return (p @ v.float()).to(q.dtype)


def attention_kv_tile(dtype: torch.dtype) -> int:
    """K7's keys per kv tile: 32 for fp32 inputs, 64 for bf16 and fp16."""
    return 32 if dtype == torch.float32 else 64


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 (10 fraction bits), to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32`` rounds (finite values)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """The top 19 bits of fp32, as the tensor cores read a tf32 operand
    that was not rounded."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _split_mm(a: torch.Tensor, b: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
    """a @ b in fp32 as K7 runs it on the tensor cores for inputs of
    ``dtype``: 16-bit a is the split p (hi + lo pieces of the type, each
    product exact in fp32); fp32 is 3xTF32 (lo_a hi_b + hi_a lo_b + hi_a
    hi_b, hi rounded to tf32, lo the rest truncated to it)."""
    if dtype == torch.float32:
        ah, bh = tf32_round(a), tf32_round(b)
        al, bl = _tf32_trunc(a - ah), _tf32_trunc(b - bh)
        return al @ bh + ah @ bl + ah @ bh
    scale = ATTN_P16_SCALE if dtype == torch.float16 else 1.0
    a = a * scale
    hi = a.to(dtype).float()
    lo = (a - hi).to(dtype).float()
    return (lo @ b + hi @ b) * (1.0 / scale)


def attention_partials(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool, nsplit: int):
    """K7's split form: the kv tiles a q tile of ``ATTN_BQ`` rows visits
    (up to its last row's last visible key) cut into ``nsplit`` parts of
    ceil(tiles / nsplit) tiles → (acc (nsplit, Sq, D), ml (nsplit, Sq, 2))
    in fp32: per part and row m = the max visible score (-1e30 where the
    part sees none), l = sum exp(s - m) and acc = sum exp(s - m) v, the
    scores and sums computed as the kernel computes them."""
    sq, d = q.shape
    sk = k.shape[0]
    dev = q.device
    bk = attention_kv_tile(q.dtype)
    qf, kf, vf = q.float(), k.float(), v.float()
    if q.dtype == torch.float32:
        logits = _split_mm(qf, kf.T, q.dtype)
    else:
        logits = qf @ kf.T
    logits = logits * (1.0 / math.sqrt(d))
    qpos = torch.arange(sq, device=dev)
    kpos = torch.arange(sk, device=dev)
    vis = torch.ones((sq, sk), dtype=torch.bool, device=dev)
    if causal:
        vis = kpos[None, :] <= qpos[:, None] + (sk - sq)
        q_end = torch.clamp((qpos // ATTN_BQ + 1) * ATTN_BQ, max=sq)
        kend = torch.clamp(q_end + (sk - sq), 0, sk)
    else:
        kend = torch.full((sq,), sk, device=dev)
    ntile = -(-kend // bk)                      # the row's q tile's tiles
    per = -(-ntile // nsplit)                   # tiles a part
    ktile = (kpos // bk)[None, :]
    acc = torch.empty((nsplit, sq, d), dtype=torch.float32, device=dev)
    ml = torch.empty((nsplit, sq, 2), dtype=torch.float32, device=dev)
    for s in range(nsplit):
        part = vis & (ktile >= s * per[:, None]) & (ktile < (s + 1)
                                                    * per[:, None])
        lg = logits.masked_fill(~part, ATTN_NEG)
        m = lg.max(dim=1).values if sk else torch.full(
            (sq,), ATTN_NEG, device=dev)
        p = torch.where(part, torch.exp(lg - m[:, None]), 0.0)
        acc[s] = _split_mm(p, vf, q.dtype)
        ml[s, :, 0] = m
        ml[s, :, 1] = p.sum(dim=1)
    return acc, ml


def attention_combine(acc: torch.Tensor, ml: torch.Tensor,
                      dtype: torch.dtype) -> torch.Tensor:
    """o (Sq, D) in ``dtype`` from K7's parts: w_s = exp(m_s - max m), o
    = sum w_s acc_s / max(sum w_s l_s, 1e-30); a row whose parts see no
    key is exactly 0."""
    m, l = ml[..., 0], ml[..., 1]
    w = torch.exp(m - m.max(dim=0).values)
    den = torch.clamp((w * l).sum(dim=0), min=1e-30)
    return ((w[..., None] * acc).sum(dim=0) / den[:, None]).to(dtype)


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


# ---------------------------------------------------------------------------
# The reference's oracle names (repro.kernels.ref), with its contracts
# ---------------------------------------------------------------------------


def lb_expand_ref(offsets: torch.Tensor, cap_out: int):
    """LB expansion geometry from (cap_in+1,) int32 offsets (the total
    last) → (in_pos, rank, valid), (cap_out,) int32 each."""
    in_pos, rank, valid = lb_expand(offsets, cap_out)
    return in_pos, rank, valid.to(torch.int32)


def spmv_ell_ref(nbrs: torch.Tensor, vals: torch.Tensor, x: torch.Tensor):
    """ELL SpMV: y[i] = sum_w vals[i, w] * x[nbrs[i, w]], nbrs -1 = pad."""
    ok = nbrs >= 0
    g = x[torch.where(ok, nbrs, 0).long()]
    return torch.where(ok, vals * g, 0.0).sum(dim=1)


def semiring_ell_ref(nbrs: torch.Tensor, vals: torch.Tensor,
                     x: torch.Tensor, mask: torch.Tensor, sr):
    """Masked-semiring ELL SpMM: y[i, b] = ⊕_w vals[i, w] ⊗ x[nbrs[i, w],
    b] for x (nx, k); rows where ``mask`` is 0 hold the ⊕-identity."""
    ok = nbrs >= 0
    g = x[torch.where(ok, nbrs, 0).long()]              # (n, W, k)
    prod = sr.mul_op(vals[..., None], g)
    zero = torch.full((), sr.zero, dtype=prod.dtype, device=prod.device)
    prod = torch.where(ok[..., None], prod, zero)
    if sr.add == "plus":
        red = prod.sum(dim=1)
    elif sr.add == "min":
        red = prod.amin(dim=1)
    else:
        red = prod.amax(dim=1)
    return torch.where((mask > 0)[:, None], red, zero)


def segment_search_ref(haystack: torch.Tensor, lo: torch.Tensor,
                       hi: torch.Tensor, needles: torch.Tensor):
    """found[i] = needles[i] in haystack[lo[i]:hi[i]) (segments sorted)
    → int32 (1 found, 0 not)."""
    return segment_search(haystack, lo, hi, needles).to(torch.int32)


def filter_compact_ref(ids: torch.Tensor, keep: torch.Tensor):
    """Stable compaction: the kept ids first, -1 after → (packed (cap,),
    count () int32)."""
    packed, counts = compact(ids[None], (keep != 0)[None])
    return packed[0], counts[0]


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, scale=None):
    """Single-head attention, q (Sq, D), k and v (Sk, D), in fp32 with the
    end-aligned causal mask and the scores scaled by ``scale`` (1/sqrt(D)
    by default); a row that sees no key is 0. Output in q's type."""
    return flash_attention(q, k, v, causal, scale)


def moe_gather_ref(x: torch.Tensor, slot_token: torch.Tensor):
    """Token rows gathered into expert slots (-1 = an empty slot, a zero
    row) → (S, D) in x's type."""
    return moe_gather(x, slot_token)
