"""Production-mesh dry-run of every (architecture × input shape), on the
``meta`` device (counterpart of ``repro.launch.dryrun``).

The reference lowers and compiles each cell's program with XLA on 512
fake host devices and reads the compiler's memory analysis, cost
analysis and the collectives of its post-SPMD HLO. The port has no
compiler to ask. Per cell it:
  1. builds the full model on ``meta`` (no memory, no compute) and
     reports, per device of the production mesh, the bytes of the
     params, the gradients and the optimizer state under
     ``fit_sharding`` of their specs — the state a step holds;
  2. counts FLOPs with ``torch.utils.flop_counter.FlopCounterMode`` over
     one step of the cell's kind (a train step, a prefill, or a decode
     step against a seq_len cache) at two probe depths k1 < k2, and
     extrapolates the reference's way: marginal = (c(k2) − c(k1)) per
     layer unit, fixed = c(k1) − k1·marginal, total ≈ fixed +
     units·marginal.

What it cannot measure: activation and temporary memory (there is no
compiled program to analyse; the eager port holds what autograd saves),
bytes accessed, and the collectives a compiled program would run —
``parse_collectives`` is kept for HLO text from elsewhere. FLOPs are
global (the whole batch); ``flops_per_device`` divides them evenly over
the mesh's chips.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b \
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all \
      --multi-pod both --out dryrun.json
"""
from __future__ import annotations

import argparse
import json
import math
import os
import re
import sys
import time
import traceback

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..configs import ARCH_IDS, get_config, shapes_for
from ..launch.mesh import make_production_mesh, mesh_axis_sizes
from ..models import build_model
from ..obs.log import get_logger
from ..parallel.sharding import fit_sharding, is_spec
from ..pytree import leaves
from ..train.optimizer import (AdamWState, adamw, make_schedule,
                               moment_specs)
from ..train.trainstep import make_train_step

# archs that need int8 optimizer moments to fit their meshes
QUANT_OPT_ARCHS = {"llama3-405b", "kimi-k2-1t-a32b", "qwen3-moe-235b-a22b"}

# microbatch (gradient-accumulation) factor per arch for train_4k — the
# production memory plan: activation temps ÷ accum
GRAD_ACCUM = {
    "llama3-405b": 16, "kimi-k2-1t-a32b": 16, "qwen3-moe-235b-a22b": 16,
    "yi-6b": 8, "starcoder2-15b": 8, "whisper-large-v3": 4,
    "minicpm-2b": 4, "qwen2-vl-2b": 4, "mamba2-780m": 4, "zamba2-2.7b": 4,
}

COLLECTIVE_RE = re.compile(
    r"=\s+(\(?)([a-z0-9\[\],{}\s]*?)\s*"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start)?\(")
SHAPE_RE = re.compile(r"([a-z][a-z0-9]*)\[([0-9,]*)\]")
GROUPS_RE = re.compile(r"replica_groups=(?:\{\{([0-9,]+)\}|\[(\d+),(\d+)\])")

DTYPE_BYTES = {"f64": 8, "f32": 4, "bf16": 2, "f16": 2, "s64": 8, "u64": 8,
               "s32": 4, "u32": 4, "s16": 2, "u16": 2, "s8": 1, "u8": 1,
               "pred": 1, "f8e4m3fn": 1, "f8e5m2": 1}


def _shape_bytes(dtype: str, dims: str) -> int:
    n = 1
    for d in dims.split(","):
        if d.strip():
            n *= int(d)
    return n * DTYPE_BYTES.get(dtype, 4)


def parse_collectives(hlo_text: str) -> dict:
    """Sum collective output bytes (per-device shapes, post-SPMD) and a
    bytes-over-links estimate: all-reduce → 2×out (RS+AG phases);
    reduce-scatter → out×group (input is what moves); others → out."""
    per_op = {}
    total = 0.0
    for line in hlo_text.splitlines():
        m = COLLECTIVE_RE.search(line)
        if not m:
            continue
        op = m.group(3)
        shapes = SHAPE_RE.findall(m.group(2))
        out_bytes = sum(_shape_bytes(dt, dims) for dt, dims in shapes)
        g = 1
        gm = GROUPS_RE.search(line)
        if gm:
            g = (len(gm.group(1).split(",")) if gm.group(1) is not None
                 else int(gm.group(3)))
        if op == "all-reduce":
            link_bytes = 2.0 * out_bytes
        elif op == "reduce-scatter":
            link_bytes = float(out_bytes) * g
        else:
            link_bytes = float(out_bytes)
        rec = per_op.setdefault(op, {"count": 0, "bytes": 0.0,
                                     "link_bytes": 0.0})
        rec["count"] += 1
        rec["bytes"] += out_bytes
        rec["link_bytes"] += link_bytes
        total += link_bytes
    return {"per_op": per_op, "link_bytes": total}


def _probe_layers(cfg):
    """(k1, k2, units): probe layer counts and the full unit count."""
    if cfg.family == "hybrid":
        return cfg.attn_every, 2 * cfg.attn_every, \
            cfg.n_layers // cfg.attn_every
    return 1, 2, cfg.n_layers


def _with_layers(cfg, k):
    kw = dict(n_layers=k)
    if cfg.family == "encdec":
        kw.update(n_enc_layers=k, n_dec_layers=k)
    return cfg.replace(**kw)


def extrapolate(cfg, c1: dict, c2: dict) -> dict:
    """The reference's probe arithmetic over each key of the k1 and k2
    probes' counts: fixed + units × marginal, with both parts."""
    k1, k2, units = _probe_layers(cfg)
    per_unit_k = (k2 - k1) / (1 if cfg.family != "hybrid"
                              else cfg.attn_every)
    n_units_probe1 = k1 if cfg.family != "hybrid" else 1
    est = {}
    for key in c1:
        marginal = max(c2[key] - c1[key], 0.0) / per_unit_k
        fixed = max(c1[key] - n_units_probe1 * marginal, 0.0)
        est[key] = fixed + units * marginal
        est[f"{key}_marginal"] = marginal
        est[f"{key}_fixed"] = fixed
    est["probe_k"] = (k1, k2, units)
    return est


def _per_device_bytes(mesh, tree, spec_tree) -> int:
    """Bytes one device holds of ``tree`` (meta tensors) under the fitted
    sharding of each leaf's spec."""
    total = 0
    for t, spec in zip(leaves(tree), leaves(spec_tree, is_spec)):
        block = fit_sharding(mesh, tuple(t.shape), spec).shard_shape(t.shape)
        total += math.prod(block) * t.element_size()
    return total


def step_flops(cfg, shape: dict, kind: str, quant: bool) -> float:
    """FLOPs of one step of ``kind`` for ``cfg`` at ``shape``, counted
    on ``meta``."""
    model = build_model(cfg)
    params = model.init(device="meta")
    batch = model.input_specs(shape, kind)
    counter = FlopCounterMode(display=False)
    if kind == "train":
        opt_init, opt_update = adamw(make_schedule("cosine", 3e-4, 10000),
                                     quantize_moments=quant)
        step = make_train_step(model, opt_update)
        opt = opt_init(params)
        with counter:
            step(params, opt, batch)
        return float(counter.get_total_flops())
    with torch.no_grad():
        if kind == "prefill":
            with counter:
                model.prefill(params, batch)
        else:
            pf = model.input_specs({"global_batch": shape["global_batch"],
                                    "seq_len": shape["seq_len"]}, "prefill")
            _, cache = model.prefill(params, pf)
            with counter:
                model.decode_step(params, cache, batch)
    return float(counter.get_total_flops())


def dryrun_cell(arch: str, shape_name: str, shape: dict, multi_pod: bool,
                verbose: bool = True, probes: bool = True) -> dict:
    cfg = get_config(arch)
    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = math.prod(mesh.shape)
    kind = shape["kind"]
    quant = arch in QUANT_OPT_ARCHS
    accum = GRAD_ACCUM.get(arch, 1) if kind == "train" else 1

    # ---- 1. the full model on meta: the state one device holds ---------
    # reprolint: disable=RL004 -- meta tensors: host work, nothing queued
    t0 = time.monotonic()
    model = build_model(cfg)
    params = model.init(device="meta")
    pspecs = model.param_specs(mesh_axis_sizes(mesh))
    memory = {"param_bytes": _per_device_bytes(mesh, params, pspecs)}
    if kind == "train":
        # grads in the param dtype; microbatches add an fp32 accumulator
        memory["grad_bytes"] = memory["param_bytes"] + (
            _per_device_bytes(mesh, [torch.empty(p.shape, device="meta")
                                     for p in leaves(params)],
                              leaves(pspecs, is_spec))
            if accum > 1 else 0)
        opt_init, _ = adamw(make_schedule("cosine", 3e-4, 10000),
                            quantize_moments=quant)
        ospecs = moment_specs(pspecs, params, quantize_moments=quant)
        memory["opt_bytes"] = _per_device_bytes(
            mesh, opt_init(params), AdamWState(step=(), m=ospecs, v=ospecs))
    memory["state_per_device"] = sum(memory.values())
    build_s = time.monotonic() - t0

    # ---- 2. FLOP probes at k1 / k2 layer units (accum = 1: a step's
    # FLOPs do not depend on microbatching) -------------------------------
    est = None
    if probes:
        k1, k2, _ = _probe_layers(cfg)
        c1 = {"flops": step_flops(_with_layers(cfg, k1), shape, kind, quant)}
        c2 = {"flops": step_flops(_with_layers(cfg, k2), shape, kind, quant)}
        est = extrapolate(cfg, c1, c2)
        est["flops_per_device"] = est["flops"] / chips

    n_active = model.active_param_count()
    tokens = shape["global_batch"] * (shape["seq_len"]
                                      if kind != "decode" else 1)
    flops_factor = 6 if kind == "train" else 2
    row = {
        "arch": arch, "shape": shape_name, "kind": kind,
        "mesh": "2x16x16" if multi_pod else "16x16", "chips": chips,
        "build_s": round(build_s, 2),
        "quantized_moments": quant, "grad_accum": accum,
        "memory": memory,
        "est": est,
        "model_flops_global": flops_factor * n_active * tokens,
        "n_active_params": n_active,
    }
    if verbose:
        msg = (f"{arch} × {shape_name} × {row['mesh']}: state/dev "
               f"{memory['state_per_device'] / 2**30:.2f} GiB")
        if est:
            msg += (f", est flops {est['flops']:.3e} "
                    f"({est['flops_per_device']:.3e}/dev), model flops "
                    f"{row['model_flops_global']:.3e}")
        get_logger("dryrun").info(msg)
    return row


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", choices=("off", "on", "both"),
                    default="off")
    ap.add_argument("--no-probes", action="store_true",
                    help="state bytes only (skip the FLOP probes)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if (args.all or args.arch is None) \
        else [args.arch]
    pods = {"off": [False], "on": [True], "both": [False, True]}[
        args.multi_pod]

    rows, failures = [], []
    for arch in archs:
        cfg = get_config(arch)
        shp = shapes_for(cfg)
        names = list(shp) if (args.all or args.shape is None) \
            else [args.shape]
        for name in names:
            if name not in shp:
                get_logger("dryrun").info(
                    f"skip {arch} × {name} "
                    f"(inapplicable for family {cfg.family})")
                continue
            for mp in pods:
                try:
                    rows.append(dryrun_cell(arch, name, shp[name], mp,
                                            probes=not args.no_probes))
                except Exception as e:      # a cell's failure is reported
                    traceback.print_exc()
                    failures.append((arch, name, mp, repr(e)))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "failures": failures}, f, indent=1)
        get_logger("dryrun").info(f"wrote {len(rows)} rows to {args.out}")
    if failures:
        get_logger("dryrun").error(f"{len(failures)} FAILURES:")
        for f_ in failures:
            get_logger("dryrun").error(f"    {f_}")
        sys.exit(1)
    get_logger("dryrun").info(f"all {len(rows)} cells built OK")
    return rows


if __name__ == "__main__":
    main()
