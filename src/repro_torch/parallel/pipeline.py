"""GPipe-style pipeline parallelism over a mesh axis (counterpart of
``repro.parallel.pipeline``).

``pipeline_apply`` runs ``stage_fn`` across S stages (the parts along
the "stage" axis) on M microbatches with the classic (M + S − 1)-tick
schedule: on every tick each stage processes the microbatch it holds and
hands its activations to the next stage (bubble fraction
(S−1)/(M+S−1)).

Stage i's params and activations live on part i's device. The port is
single-controller: one process drives every stage, ticks run in
order and stages within a tick in stage order, and the hand-off is an
explicit ``.to()`` onto the next stage's device — no
``torch.distributed``. A stage holds nothing on the bubble ticks, so it
computes nothing there (the reference computes on a zero buffer and
discards the result).
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..pytree import tree_map


def _stage_devices(mesh, axis: str) -> list:
    """Part i's device along ``axis``, the other axes at index 0."""
    k = mesh.axis_names.index(axis)
    out = []
    for i in range(mesh.shape[k]):
        idx = [0] * len(mesh.shape)
        idx[k] = i
        out.append(mesh.devices[int(np.ravel_multi_index(idx, mesh.shape))])
    return out


def pipeline_apply(stage_fn: Callable, stage_params, x: torch.Tensor, mesh,
                   n_microbatches: int, axis: str = "stage") -> torch.Tensor:
    """Run a microbatched pipeline-parallel forward.

    stage_fn(params_for_stage, x_micro) -> y_micro (same shape).
    stage_params: tree of tensors with leading axis = n_stages.
    x: (global_batch, ...) — split into n_microbatches on axis 0.
    Returns y with x's shape, on x's device.
    """
    devices = _stage_devices(mesh, axis)
    n_stages = len(devices)
    gb = x.shape[0]
    if gb % n_microbatches:
        raise ValueError(f"batch {gb} is not a multiple of "
                         f"{n_microbatches} microbatches")
    xs = x.reshape((n_microbatches, gb // n_microbatches)
                   + tuple(x.shape[1:]))
    params = [tree_map(lambda a, i=i: a[i].to(devices[i]), stage_params)
              for i in range(n_stages)]
    held = [None] * n_stages                # the microbatch each stage holds
    outs = [None] * n_microbatches
    for t in range(n_microbatches + n_stages - 1):
        if t < n_microbatches:              # stage 0 ingests microbatch t
            held[0] = xs[t].to(devices[0])
        done = t - (n_stages - 1)           # the last stage retires it
        nxt = [None] * n_stages
        for s in range(n_stages):
            if held[s] is None:
                continue
            y = stage_fn(params[s], held[s])
            if s == n_stages - 1:
                outs[done] = y.to(x.device)
            else:
                nxt[s + 1] = y.to(devices[s + 1])
        held = nxt
    return torch.stack(outs).reshape(x.shape)
