"""End-to-end training launcher (counterpart of ``repro.launch.train``).

Wires every substrate together: config registry → model → params →
AdamW(+schedule) → synthetic data pipeline → train step → checkpoint /
restore → fault-tolerant restart loop → straggler watchdog.

  PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \
      --smoke --steps 50 --batch 8 --seq 128 --ckpt-dir ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b --smoke \
      --steps 20 --simulate-failure 10 --ckpt-dir ckpt   # fault + resume

``--device`` defaults to the card; ``--device cpu`` runs on the CPU.
``--data-parallel`` / ``--model-parallel`` make the (data, model) test
mesh, every part on the one device (its axis sizes reach the MoE
dispatch and the checkpoint's specs); ``--grad-accum`` splits each
batch into that many microbatches.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from ..configs import get_config, get_smoke_config
from ..data import SyntheticLMDataset, make_batch_for
from ..ft import RestartableTrainer
from ..kernels.runtime import resolve_device
from ..launch.mesh import make_test_mesh, mesh_axis_sizes
from ..models import build_model
from ..obs.log import get_logger
from ..parallel.sharding import use_mesh
from ..train import adamw, make_schedule, make_train_step
from ..train.optimizer import AdamWState, moment_specs


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--schedule", default=None,
                    help="constant|cosine|wsd (default: wsd for minicpm, "
                         "cosine otherwise — matching the papers)")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--data-parallel", type=int, default=1)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--simulate-failure", type=int, default=None)
    ap.add_argument("--quantized-optimizer", action="store_true")
    ap.add_argument("--log", default=None, help="write metrics jsonl")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = (get_smoke_config(args.arch) if args.smoke
           else get_config(args.arch))
    model = build_model(cfg)
    schedule_kind = args.schedule or (
        "wsd" if args.arch == "minicpm-2b" else "cosine")
    sched = make_schedule(schedule_kind, args.lr, args.steps)
    opt_init, opt_update = adamw(
        sched, quantize_moments=args.quantized_optimizer)

    mesh = make_test_mesh(args.data_parallel, args.model_parallel,
                          device=dev)
    axes = mesh_axis_sizes(mesh)
    pspecs = model.param_specs(axes)
    params_sds = model.init(device="meta")
    ospec = AdamWState(
        step=(),
        m=moment_specs(pspecs, params_sds, args.quantized_optimizer),
        v=moment_specs(pspecs, params_sds, args.quantized_optimizer))
    shape = {"global_batch": args.batch, "seq_len": args.seq}

    ds = SyntheticLMDataset(cfg.vocab, args.seq, args.batch, seed=0,
                            device=dev)

    def make_batch():
        b = make_batch_for(cfg, shape, "train",
                           seed=ds.step + 1000 * ds.seed, device=dev)
        lm = ds.next_batch()
        if "tokens" in b:
            b["tokens"] = lm["tokens"]
        b["labels"] = lm["labels"]
        return b

    train_step = make_train_step(model, opt_update,
                                 grad_accum=args.grad_accum)

    def init_state():
        params = model.init(0, device=dev)
        return (params, opt_init(params))

    def step_fn(state, step):
        params, opt_state = state
        params, opt_state, metrics = train_step(params, opt_state,
                                                make_batch())
        return (params, opt_state), metrics

    with use_mesh(mesh):
        if args.ckpt_dir:
            trainer = RestartableTrainer(args.ckpt_dir,
                                         ckpt_every=args.ckpt_every,
                                         device=dev)
            report = trainer.run(
                init_state=init_state, step_fn=step_fn,
                data_state=ds.state, restore_data=ds.restore,
                total_steps=args.steps, fail_at=args.simulate_failure,
                mesh=mesh, spec_tree=(pspecs, ospec))
        else:
            state = init_state()
            history = []
            for step in range(args.steps):
                t0 = time.monotonic()
                state, metrics = step_fn(state, step)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                history.append({"step": step,
                                "dt": time.monotonic() - t0,
                                **{k: float(v) for k, v in metrics.items()}})
            report = {"completed": True, "restarts": 0,
                      "history": history, "stragglers": []}

    first = report["history"][0]["loss"] if report["history"] else None
    last = report["history"][-1]["loss"] if report["history"] else None
    get_logger("train").info(
        f"arch={args.arch} completed={report['completed']} "
        f"restarts={report['restarts']} steps={len(report['history'])} "
        f"loss {first:.4f} -> {last:.4f}")
    if args.log:
        with open(args.log, "w") as f:
            for row in report["history"]:
                f.write(json.dumps(row) + "\n")
    return report


if __name__ == "__main__":
    main()
