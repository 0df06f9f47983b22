"""Train / serve step factories (counterpart of ``repro.train.trainstep``).

make_train_step: loss → grad → (optional microbatch accumulation) →
AdamW update. The reference donates params and optimizer buffers to its
jitted step; the update here writes them in place, so a step holds one
copy of the params and moments, not two (``donate=False`` clones them
first and leaves the given trees as they were).

make_serve_step: prefill or single-token decode against a static cache.
"""
from __future__ import annotations

import torch

from ..models.api import Model
from ..pytree import flatten, leaves, tree_map, unflatten


def value_and_grad(model: Model, params, batch) -> tuple:
    """(loss, metrics, grads): the loss and its metrics detached, and a
    gradient for every params leaf in the leaf's dtype (zeros where the
    loss does not reach it, as ``jax.grad`` gives)."""
    flat, tdef = flatten(params)
    live = [p.detach().requires_grad_(True) for p in flat]
    with torch.enable_grad():
        loss, metrics = model.loss(unflatten(tdef, live), batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            unflatten(tdef, grads))


def make_train_step(model: Model, opt_update, *, grad_accum: int = 1,
                    donate: bool = True):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics). ``grad_accum`` splits the batch on axis 0 into microbatches
    whose gradients add up in fp32 (activation memory ÷ grad_accum), then
    divides them by ``grad_accum``, as the reference's scan does."""

    def train_step(params, opt_state, batch):
        if grad_accum <= 1:
            loss, metrics, grads = value_and_grad(model, params, batch)
        else:
            micro = {k: v.reshape((grad_accum, v.shape[0] // grad_accum)
                                  + tuple(v.shape[1:]))
                     for k, v in batch.items()}
            acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                 device=p.device), params)
            losses, metricss = [], []
            for i in range(grad_accum):
                l, met, g = value_and_grad(model, params,
                                           {k: v[i] for k, v in micro.items()})
                for a, gi in zip(leaves(acc), leaves(g)):
                    a.add_(gi)
                losses.append(l)
                metricss.append(met)
                del g
            grads = tree_map(lambda a: a / grad_accum, acc)
            del acc
            loss = torch.mean(torch.stack(losses))
            metrics = {k: torch.mean(torch.stack([m[k] for m in metricss]))
                       for k in metricss[0]}
        if not donate:
            params, opt_state = tree_map(torch.clone, (params, opt_state))
        params, opt_state, opt_metrics = opt_update(grads, opt_state, params)
        return params, opt_state, {"loss": loss, **metrics, **opt_metrics}

    return train_step


def make_serve_step(model: Model, kind: str):
    """kind='prefill' → serve_step(params, batch) -> (logits, cache);
    kind='decode'  → serve_step(params, cache, batch) -> (logits, cache)."""
    if kind == "prefill":
        return torch.no_grad()(model.prefill)
    if kind == "decode":
        return torch.no_grad()(model.decode_step)
    raise ValueError(kind)
