"""Shared checks of the port's training path against the reference
(``tests/test_torch_{grads,trainstep}.py``): the reference's SMOKE
params, a train batch, its loss and gradients computed once per arch
(one jitted ``value_and_grad``, reused by the gradient check and the
train-step check), carried to the port as numpy.

Gradients are held leaf by leaf to an absolute tolerance scaled by the
global gradient norm, not to a per-leaf relative one: some leaves have a
zero gradient in exact arithmetic (Whisper's key biases ``bk``, since a
softmax is invariant to a per-query shift), and both packages give
rounding noise of ~1e-10 there.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.data import make_batch_for as ref_make_batch_for
from repro.models import build_model as ref_build_model
from repro.train import adamw as ref_adamw
from repro.train import make_schedule as ref_make_schedule
from repro.train import make_train_step as ref_make_train_step
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_arrays
from repro_torch.models import build_model
from repro_torch.pytree import leaves
from repro_torch.train import adamw, make_schedule, make_train_step
from repro_torch.train.optimizer import QTensor
from repro_torch.train.trainstep import value_and_grad

B, S = 2, 32
GRAD_ATOL = 1e-5          # × the global gradient norm, every leaf
STEP_RTOL = 1e-5          # loss (relative) and params (relative L2)
STEPS = 3
CODE_FLIPS = 1e-3         # share of int8 codes allowed to differ


@pytest.fixture(autouse=True)
def one_thread():
    """Each test on one PyTorch thread: the suite runs several test
    workers on the machine's cores, and at these sizes a pool of threads
    a worker only contends with the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _schedule(make):
    return make("cosine", 1e-3, 10, warmup_steps=2)


@functools.lru_cache(maxsize=None)
def reference(arch):
    """The reference's SMOKE params (PRNGKey 0), a B × S train batch
    (seed 3), the jitted value_and_grad, and its loss and gradients."""
    cfg = ref_get_smoke_config(arch)
    model = ref_build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    batch = ref_make_batch_for(cfg, {"global_batch": B, "seq_len": S},
                               "train", seed=3)
    vg = jax.jit(jax.value_and_grad(model.loss, has_aux=True))
    (loss, _), grads = vg(params, batch)
    return {"params": params, "batch": batch, "vg": vg,
            "np_params": jax.tree.map(np.asarray, params),
            "np_batch": {k: np.asarray(v) for k, v in batch.items()},
            "loss": float(loss), "grads": jax.tree.map(np.asarray, grads)}


@functools.lru_cache(maxsize=None)
def reference_steps(arch, quant=False, grad_accum=1):
    """STEPS reference AdamW steps from ``reference(arch)``'s params on
    its batch: each step's loss and the params after it (numpy). At
    grad_accum 1 the steps reuse the jitted value_and_grad (the first
    its cached gradients) under a jitted update; above it they are the
    reference's own ``make_train_step``."""
    r = reference(arch)
    opt_init, opt_update = ref_adamw(_schedule(ref_make_schedule),
                                     quantize_moments=quant)
    params, opt = r["params"], opt_init(r["params"])
    out = []
    if grad_accum > 1:
        step = ref_make_train_step(ref_build_model(ref_get_smoke_config(arch)),
                                   opt_update, grad_accum=grad_accum,
                                   donate=False)
        for _ in range(STEPS):
            params, opt, metrics = step(params, opt, r["batch"])
            out.append((float(metrics["loss"]),
                        jax.tree.map(np.asarray, params)))
        return out
    upd = jax.jit(opt_update)
    for i in range(STEPS):
        if i == 0:
            loss, grads = r["loss"], r["grads"]
        else:
            (loss, _), grads = r["vg"](params, r["batch"])
        params, opt, _ = upd(grads, opt, params)
        out.append((float(loss), jax.tree.map(np.asarray, params)))
    return out


def port_model(arch, **kw):
    return build_model(get_smoke_config(arch).replace(**kw))


def check_grads(arch):
    """The port's loss within 1e-5 (relative) and every gradient leaf
    within GRAD_ATOL × the global gradient norm of the reference's."""
    r = reference(arch)
    model = port_model(arch)
    params = params_from_arrays(r["np_params"], "cpu")
    loss, _, grads = value_and_grad(model, params, port_batch(r["np_batch"]))
    np.testing.assert_allclose(float(loss), r["loss"], rtol=STEP_RTOL)
    want = jax.tree.leaves(r["grads"])
    got = leaves(grads)
    assert len(got) == len(want)
    norm = float(np.sqrt(sum(np.sum(np.square(w.astype(np.float64)))
                             for w in want)))
    for i, (g, w) in enumerate(zip(got, want)):
        assert tuple(g.shape) == w.shape, (arch, i)
        err = float(np.abs(g.double().numpy() - w).max())
        assert err <= GRAD_ATOL * norm, (arch, i, err, norm)


def rel_l2_tree(got, want, keep=None) -> float:
    """Relative L2 of the port's tree against the reference's, over the
    leaves ``keep`` marks (all of them by default)."""
    got, want = leaves(got), jax.tree.leaves(want)
    keep = keep or [True] * len(got)
    a = np.concatenate([t.float().numpy().ravel()
                        for t, k in zip(got, keep) if k])
    b = np.concatenate([np.asarray(w, np.float32).ravel()
                        for w, k in zip(want, keep) if k])
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def check_steps(arch, quant=False, grad_accum=1):
    """STEPS of the port's ``make_train_step`` (donated, in place) from
    the reference's params: each step's loss within STEP_RTOL and the
    params after it within STEP_RTOL relative L2 of the reference's.

    With int8 moments the params whose moments are quantized are left
    out of the comparison: each package's gradients differ from the
    other's by ~1e-7 of rounding, and a moment that rounds to the other
    side of a code boundary moves by a whole quantum (absmax / 127); where
    v rounds to 0 the update is m / eps (ROADMAP C-ref-15), so those
    params part from the second step on. The optimizer alone is held on
    the same gradients (``check_int8_optimizer_steps``)."""
    r = reference(arch)
    want = reference_steps(arch, quant, grad_accum)
    model = port_model(arch)
    opt_init, opt_update = adamw(_schedule(make_schedule),
                                 quantize_moments=quant)
    step = make_train_step(model, opt_update, grad_accum=grad_accum)
    params = params_from_arrays(r["np_params"], "cpu")
    opt = opt_init(params)
    keep = [not isinstance(m, QTensor) for m in leaves(opt.m, _is_q)]
    assert (not all(keep)) == quant
    batch = port_batch(r["np_batch"])
    for i, (loss_w, params_w) in enumerate(want):
        params, opt, metrics = step(params, opt, batch)
        np.testing.assert_allclose(float(metrics["loss"]), loss_w,
                                   rtol=STEP_RTOL, err_msg=f"{arch} {i}")
        rel = rel_l2_tree(params, params_w, keep)
        assert rel <= STEP_RTOL, (arch, i, rel)
    assert int(opt.step) == STEPS


def _is_q(x) -> bool:
    return isinstance(x, QTensor)


def check_int8_optimizer_steps(arch):
    """STEPS of the port's AdamW with int8 moments fed the reference's
    gradients of each step (at the reference's params): params within
    STEP_RTOL relative L2 of the reference's after every step, and the
    moments' codes equal but for at most CODE_FLIPS of the entries."""
    r = reference(arch)
    ref_init, ref_update = ref_adamw(_schedule(ref_make_schedule),
                                     quantize_moments=True)
    ref_update = jax.jit(ref_update)
    opt_init, opt_update = adamw(_schedule(make_schedule),
                                 quantize_moments=True)
    ref_p, ref_o = r["params"], ref_init(r["params"])
    params = params_from_arrays(r["np_params"], "cpu")
    opt = opt_init(params)
    for i in range(STEPS):
        grads = r["grads"] if i == 0 else r["vg"](ref_p, r["batch"])[1]
        ref_p, ref_o, _ = ref_update(grads, ref_o, ref_p)
        params, opt, _ = opt_update(
            params_from_arrays(jax.tree.map(np.asarray, grads), "cpu"),
            opt, params)
        rel = rel_l2_tree(params, jax.tree.map(np.asarray, ref_p))
        assert rel <= STEP_RTOL, (arch, i, rel)
        for got, want in ((opt.m, ref_o.m), (opt.v, ref_o.v)):
            pairs = [(g.codes.numpy().astype(int), np.asarray(w.codes))
                     for g, w in zip(leaves(got, _is_q), jax.tree.leaves(
                         want, is_leaf=lambda x: hasattr(x, "codes")))
                     if isinstance(g, QTensor)]
            assert pairs
            flips = sum(int((a != b).sum()) for a, b in pairs)
            assert flips <= CODE_FLIPS * sum(a.size for a, _ in pairs)
