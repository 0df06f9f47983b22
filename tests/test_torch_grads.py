"""The port's gradients of the SMOKE loss against the reference's for
the archs ``test_torch_trainstep*.py`` do not step (every leaf within
1e-5 × the global gradient norm); ``remat`` "none", "dots" and "full"
giving bit-equal loss and gradients; and ``maybe_scan``'s ``unbind``
walk giving the gradients that indexing each layer gives, bit for
bit."""
import numpy as np
import pytest
import torch

from _torch_train import one_thread  # noqa: F401 (autouse)
from _torch_train import B, S, check_grads, port_model
from repro_torch.data import make_batch_for
from repro_torch.models import api
from repro_torch.pytree import leaves
from repro_torch.train.trainstep import value_and_grad

GRAD_ARCHS = ("qwen3-moe-235b-a22b", "yi-6b", "llama3-405b", "starcoder2-15b",
              "qwen2-vl-2b")
REMAT_ARCHS = ("minicpm-2b", "qwen3-moe-235b-a22b", "mamba2-780m",
               "zamba2-2.7b", "whisper-large-v3")


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_gradients_match_reference(arch):
    check_grads(arch)


def _loss_and_grads(model, seed=0):
    params = model.init(torch.Generator().manual_seed(seed), device="cpu")
    batch = make_batch_for(model.cfg, {"global_batch": B, "seq_len": S},
                           "train", seed=3, device="cpu")
    loss, _, grads = value_and_grad(model, params, batch)
    return loss, leaves(grads)


@pytest.mark.parametrize("arch", REMAT_ARCHS)
def test_remat_is_bit_equal(arch):
    """What a layer's backward recomputes changes no bit of the loss or
    the gradients (the reference's ``_remat`` policies)."""
    loss, grads = _loss_and_grads(port_model(arch))
    for remat in ("dots", "full"):
        l2, g2 = _loss_and_grads(port_model(arch, remat=remat))
        assert torch.equal(l2, loss), (arch, remat)
        assert all(torch.equal(a, b) for a, b in zip(g2, grads)), \
            (arch, remat)


def test_unknown_remat_raises():
    with pytest.raises(ValueError, match="unknown remat"):
        _loss_and_grads(port_model("minicpm-2b", remat="some"))


def test_maybe_scan_unbind_matches_indexing(monkeypatch):
    """The gradients of a stacked-layer loss through ``maybe_scan``'s
    one ``unbind(0)`` per leaf equal those of indexing ``a[i]`` for
    every layer (the walk it replaced), bit for bit."""
    def indexed(body, carry, xs):
        n = int(api.tree_leaves(xs)[0].shape[0])
        ys = []
        for i in range(n):
            carry, y = body(carry, api.tree_map(lambda a: a[i], xs))
            ys.append(y)
        if not ys or ys[0] is None:
            return carry, None
        return carry, api.tree_map(lambda *a: torch.stack(a), *ys)

    model = port_model("qwen3-moe-235b-a22b", n_layers=5)
    loss, grads = _loss_and_grads(model)
    from repro_torch.models import transformer
    monkeypatch.setattr(transformer, "maybe_scan", indexed)
    loss2, grads2 = _loss_and_grads(model)
    assert torch.equal(loss, loss2)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads2))
    assert np.isfinite(float(loss))


def test_a_train_step_leaves_no_reference_cycle():
    """With the collector off, the params and moments of a finished run
    are freed as soon as the last name goes (a cycle through the tree
    helpers once kept a whole MiniCPM-2B state alive on the card)."""
    import gc
    import weakref

    from repro_torch.train import adamw, make_schedule, make_train_step
    model = port_model("kimi-k2-1t-a32b")
    batch = make_batch_for(model.cfg, {"global_batch": B, "seq_len": S},
                           "train", seed=3, device="cpu")
    gc.collect()
    gc.disable()
    try:
        params = model.init(0, device="cpu")
        init, update = adamw(make_schedule("constant", 1e-3, 10),
                             quantize_moments=True)
        step = make_train_step(model, update)
        params, opt, _ = step(params, init(params), batch)
        refs = [weakref.ref(t) for t in leaves((params, opt))]
        del params, opt, step
        assert all(r() is None for r in refs)
    finally:
        gc.enable()
