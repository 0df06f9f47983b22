"""Optimizers + LR schedules (counterpart of ``repro.train.optimizer``).

- ``adamw``: AdamW with decoupled weight decay and global-norm clipping.
  Moment states can be stored in **blockwise-quantized int8** (8-bit Adam
  à la Dettmers): each 256-value block keeps an fp32 absmax scale, which
  cuts optimizer state from 8 B/param to ~2 B/param.
- schedules: constant / cosine / WSD (warmup-stable-decay, the MiniCPM
  training schedule), computed in fp32 tensors as the reference's are.

State layout mirrors the param tree (nested dicts of tensors): moments
keep each param's shape, so they take each param's spec. The reference's
quirks are kept: weight decay applies wherever ``p.ndim >= 2``, which
includes the stacked (L, d) norm scales (ROADMAP C-ref-14), and the
quantized moments block the last axis.

``update_fn(grads, state, params)`` writes the new params, moments and
step into the given tensors and returns them (the reference donates both
buffers to its jitted step), a piece of rows at a time; a caller that
needs the old trees clones them first.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..parallel.sharding import is_spec
from ..pytree import flatten, leaves, tree_map, unflatten

QBLOCK = 256


# ---------------------------------------------------------------------------
# blockwise int8 quantization for moment tensors
#
# Codes keep the PARAM'S SHAPE (blocks run along the last axis), so the
# moments take the param's spec verbatim and dequantization is purely
# elementwise.
# ---------------------------------------------------------------------------

def quantizable(shape) -> bool:
    return len(shape) >= 2 and shape[-1] % QBLOCK == 0


def quantize_blockwise(x: torch.Tensor) -> tuple:
    """x: (..., D) with D % QBLOCK == 0 → (codes int8 of x's shape,
    scale f32 (..., D // QBLOCK))."""
    shape = tuple(x.shape)
    xb = x.float().reshape(shape[:-1] + (shape[-1] // QBLOCK, QBLOCK))
    scale = torch.amax(torch.abs(xb), dim=-1) / 127.0
    codes = torch.round(xb / torch.clamp(scale[..., None], min=1e-12))
    return codes.reshape(shape).to(torch.int8), scale


def dequantize_blockwise(codes: torch.Tensor, scale: torch.Tensor, shape,
                         dtype) -> torch.Tensor:
    shape = tuple(shape)
    xb = codes.float().reshape(shape[:-1] + (shape[-1] // QBLOCK, QBLOCK))
    return (xb * scale[..., None]).reshape(shape).to(dtype)


class QTensor(NamedTuple):
    codes: torch.Tensor     # int8, same shape as the param
    scale: torch.Tensor     # f32, param.shape[:-1] + (D // QBLOCK,)


def _is_q(x) -> bool:
    return isinstance(x, QTensor)


# elements of a leaf the update handles at once
PIECE = 1 << 24


def _pieces(p) -> list:
    """Row slices of ``p`` (all of it when small or 0-d) of at most
    about PIECE elements each; a slice keeps ``p``'s rank."""
    if p.ndim == 0 or p.numel() <= PIECE:
        return [slice(None)]
    rows = max(1, PIECE // (p.numel() // p.shape[0]))
    return [slice(i, i + rows) for i in range(0, p.shape[0], rows)]


def _rows(x, rows):
    if isinstance(x, QTensor):
        return QTensor(x.codes[rows], x.scale[rows])
    return x[rows]


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

def make_schedule(kind: str, base_lr: float, total_steps: int,
                  warmup_steps: int = 100, stable_frac: float = 0.9,
                  min_ratio: float = 0.1):
    """Returns lr(step) -> 0-d fp32 tensor (on ``step``'s device when it
    is a tensor). kinds: constant | cosine | wsd."""
    warmup = max(warmup_steps, 1)

    def _w(step):
        return torch.clamp(step / warmup, max=1.0)

    def constant(step):
        step = torch.as_tensor(step)
        return base_lr * _w(step)

    def cosine(step):
        step = torch.as_tensor(step)
        t = torch.clamp((step - warmup) / max(total_steps - warmup, 1),
                        0., 1.)
        c = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
        return base_lr * _w(step) * c

    def wsd(step):
        """Warmup-Stable-Decay (MiniCPM): flat LR for stable_frac of the
        run, then a fast exponential-ish decay tail."""
        step = torch.as_tensor(step)
        stable_end = warmup + stable_frac * max(total_steps - warmup, 1)
        t = torch.clamp((step - stable_end)
                        / max(total_steps - stable_end, 1.0), 0., 1.)
        decay = torch.pow(torch.tensor(min_ratio, dtype=torch.float32,
                                       device=t.device), t)
        return base_lr * _w(step) * decay

    return {"constant": constant, "cosine": cosine, "wsd": wsd}[kind]


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

class AdamWState(NamedTuple):
    step: torch.Tensor      # int32 scalar
    m: object               # tree of f32 tensors or QTensor
    v: object


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32, the leaves
    added in the reference's order."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves(tree)))


def adamw(schedule, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, clip_norm: Optional[float] = 1.0,
          quantize_moments: bool = False):
    """Returns (init_fn, update_fn).

    update_fn(grads, state, params) -> (params, state, metrics), the
    given params and state updated in place.
    """

    def _q(x):
        if quantize_moments and quantizable(x.shape):
            return QTensor(*quantize_blockwise(x))
        return x.float()

    def _dq(q, like):
        if isinstance(q, QTensor):
            return dequantize_blockwise(q.codes, q.scale, like.shape,
                                        torch.float32)
        return q

    def init_fn(params):
        def zeros(p):
            return _q(torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device))

        return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                           device=leaves(params)[0].device),
                          m=tree_map(zeros, params), v=tree_map(zeros, params))

    def _store(dst, x):
        """The moment ``x`` written into ``dst``'s buffers: a quantized
        one again, an fp32 one is ``dst`` itself already."""
        if isinstance(dst, QTensor):
            codes, scale = quantize_blockwise(x)
            dst.codes.copy_(codes)
            dst.scale.copy_(scale)

    @torch.no_grad()
    def update_fn(grads, state, params):
        step = state.step + 1
        lr = schedule(step)
        gnorm = global_norm(grads)
        scale = None
        if clip_norm is not None:
            scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-12),
                                max=1.0)
        stepf = step.float()
        bc1 = 1 - torch.pow(torch.tensor(b1, device=stepf.device), stepf)
        bc2 = 1 - torch.pow(torch.tensor(b2, device=stepf.device), stepf)

        def upd(p, g, m, v):
            g = g.float() if scale is None else g.float() * scale
            # fp32 moments are updated in their own buffers; a quantized
            # one is dequantized into a fresh tensor and stored back
            mf, vf = _dq(m, p), _dq(v, p)
            mf.mul_(b1).add_((1 - b1) * g)
            vf.mul_(b2).add_((1 - b2) * g * g)
            del g
            u = mf / bc1
            u.div_(torch.sqrt(vf / bc2).add_(eps))
            # decoupled weight decay on matrices only (ndim >= 2)
            if p.ndim >= 2:
                u.add_(weight_decay * p.float())
            p.copy_((p.float() - u.mul_(lr)).to(p.dtype))
            del u
            _store(m, mf)
            _store(v, vf)

        # a piece of rows at a time: every operation is elementwise or
        # within a last-axis block, so the bits are the whole leaf's, and
        # the fp32 temporaries stay small
        for p, g, m, v in zip(leaves(params), leaves(grads),
                              leaves(state.m, _is_q), leaves(state.v, _is_q)):
            for rows in _pieces(p):
                upd(p[rows], g[rows], _rows(m, rows), _rows(v, rows))
        state.step.copy_(step)
        return params, state, {"lr": lr, "grad_norm": gnorm}

    return init_fn, update_fn


def moment_specs(param_specs, params_sds=None,
                 quantize_moments: bool = False):
    """Optimizer-state specs matching the param tree.

    Quantized moments keep the param's shape (codes) / the param's shape
    minus the blocked last axis (scale), so BOTH reuse the param's spec —
    ``fit_sharding`` trims any non-divisible trailing entry on the scale.
    ``params_sds`` is the params tree on ``meta`` (its shapes).
    """
    if not quantize_moments:
        return param_specs
    if params_sds is None:
        raise ValueError("quantized moment_specs needs param shapes")
    flat_s, tdef = flatten(param_specs, is_spec)
    flat_sd = leaves(params_sds)
    return unflatten(tdef, [QTensor(codes=s, scale=s)
                            if quantizable(sd.shape) else s
                            for s, sd in zip(flat_s, flat_sd)])
