"""Shared checks of the port's LM families against the reference
(``tests/test_torch_{mamba2,hybrid,encdec}.py``): the reference's params,
prompt, logits, greedy ids and loss computed once per arch and dtype
(its prefill and decode jitted once), carried to the port with
``convert.params_from_arrays``, and the full configs' shape and spec
trees."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.configs import shapes_for as ref_shapes_for
from repro.data import make_batch_for as ref_make_batch_for
from repro.models import build_model as ref_build_model
from repro_torch.configs import get_config, get_smoke_config, shapes_for
from repro_torch.convert import params_from_arrays
from repro_torch.data import make_batch_for
from repro_torch.launch.serve import generate
from repro_torch.models import build_model
from repro_torch.models.api import tree_leaves

# S = 40 puts a ragged tail on the SMOKE configs' 16-token SSD chunks
B, S, GEN, FRAMES = 2, 40, 8, 12
LOGIT_ATOL = 1e-4
LOSS_RTOL = 1e-5
DIRECT_ATOL = 2e-3      # the reference's decode-vs-direct bound
LOSSY_REL = 5e-2        # the reference's bound for a lossy path
AXES = ({"pod": 2, "data": 16, "model": 16}, {"data": 2, "model": 4})
AXES_IDS = ("pod2-data16-model16", "data2-model4")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def prompt(cfg, seed=0) -> dict:
    """The prompt both sides get (numpy): tokens, and for the encdec
    family FRAMES stub frame embeddings."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "encdec":
        out["frames"] = (rng.standard_normal((B, FRAMES, cfg.d_model))
                         * 0.02).astype(np.float32)
    return out


def _bf16(cfg, bf16: bool, dtype):
    return cfg.replace(param_dtype=dtype, compute_dtype=dtype) if bf16 \
        else cfg


def ref_smoke_config(arch, bf16=False, **kw):
    return _bf16(ref_get_smoke_config(arch), bf16, jnp.bfloat16).replace(**kw)


def smoke_config(arch, bf16=False, **kw):
    return _bf16(get_smoke_config(arch), bf16, torch.bfloat16).replace(**kw)


def _ref_inputs(p, cfg):
    return {k: jnp.asarray(v, cfg.compute_dtype if k == "frames" else None)
            for k, v in p.items()}


@functools.lru_cache(maxsize=None)
def reference(arch, bf16=False, max_cache_len=None):
    """The reference's params (numpy), prompt, prefill / decode logits
    (fp32) and greedy ids over GEN tokens, and (fp32 only) its loss on a
    train batch."""
    kw = {} if max_cache_len is None else {"max_cache_len": max_cache_len}
    cfg = ref_smoke_config(arch, bf16, **kw)
    model = ref_build_model(cfg)
    params = model.init(jax.random.PRNGKey(1))
    p = prompt(cfg)
    prefill = jax.jit(functools.partial(model.prefill, cache_len=S + GEN))
    decode = jax.jit(model.decode_step)
    lg, cache = prefill(params, _ref_inputs(p, cfg))
    logits = [np.asarray(lg[:, -1], np.float32)]
    ids = [np.asarray(jnp.argmax(lg[:, -1], -1)).astype(np.int32)]
    for _ in range(GEN - 1):
        lg, cache = decode(params, cache,
                           {"tokens": jnp.asarray(ids[-1][:, None])})
        logits.append(np.asarray(lg[:, -1], np.float32))
        ids.append(np.asarray(jnp.argmax(lg[:, -1], -1)).astype(np.int32))
    out = {"params": _np_tree(params), "prompt": p,
           "logits": np.stack(logits, 1), "ids": np.stack(ids, 1)}
    if not bf16 and max_cache_len is None:
        batch = ref_make_batch_for(cfg, {"global_batch": B,
                                         "seq_len": 2 * S}, "train", seed=3)
        loss, metrics = jax.jit(model.loss)(params, batch)
        out["loss"] = float(loss)
        out["metrics"] = {k: float(v) for k, v in metrics.items()}
    return out


def port_inputs(p, cfg) -> dict:
    return {k: torch.from_numpy(v).to(cfg.compute_dtype if k == "frames"
                                      else torch.int32)
            for k, v in p.items()}


def port_pair(arch, bf16=False, **kw):
    """(the reference's run, the port's model, the reference's params
    carried to the CPU)."""
    ref = reference(arch, bf16, kw.get("max_cache_len"))
    model = build_model(smoke_config(arch, bf16, **kw))
    return ref, model, params_from_arrays(ref["params"], "cpu")


def port_logits(model, params, ref):
    """The port's greedy run from the reference's prompt: its prefill
    and decode logits (B, GEN, Vp) fp32 and its ids."""
    ids, logits = generate(model, params, port_inputs(ref["prompt"],
                                                      model.cfg),
                           GEN, cache_len=S + GEN)
    return logits.float().numpy(), ids.numpy()


def check_logits(arch):
    """Prefill and every decode step's logits within LOGIT_ATOL of the
    reference's; greedy ids equal."""
    ref, model, params = port_pair(arch)
    logits, ids = port_logits(model, params, ref)
    assert logits.shape == ref["logits"].shape
    err = np.abs(logits - ref["logits"]).max(axis=(0, 2))
    assert err.max() < LOGIT_ATOL, (arch, err)
    np.testing.assert_array_equal(ids, ref["ids"], err_msg=arch)


def rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def bf16_rel_l2(arch) -> float:
    """The relative L2 of the port's logits against the reference's at
    the bf16 variant of SMOKE, teacher-forced on the reference's ids (a
    greedy id that flips on a near-tie would otherwise fork the two
    runs)."""
    ref, model, params = port_pair(arch, bf16=True)
    lg, cache = model.prefill(params, port_inputs(ref["prompt"], model.cfg),
                              cache_len=S + GEN)
    got = [lg[:, -1].float()]
    for i in range(GEN - 1):
        lg, cache = model.decode_step(
            params, cache, {"tokens": torch.from_numpy(ref["ids"][:, i:i + 1])})
        got.append(lg[:, -1].float())
    return rel_l2(torch.stack(got, 1).numpy(), ref["logits"])


def check_cache_len(arch):
    ref, model, params = port_pair(arch)
    _, cache = model.prefill(params, port_inputs(ref["prompt"], model.cfg),
                             cache_len=S + GEN)
    assert cache["len"].shape == () and cache["len"].dtype == torch.int32
    _, cache2 = model.decode_step(
        params, cache, {"tokens": torch.zeros((B, 1), dtype=torch.int32)})
    assert int(cache2["len"]) == int(cache["len"]) + 1 == S + 1
    return cache2


def check_loss(arch):
    ref, model, params = port_pair(arch)
    batch = make_batch_for(model.cfg, {"global_batch": B, "seq_len": 2 * S},
                           "train", seed=3, device="cpu")
    loss, metrics = model.loss(params, batch)
    np.testing.assert_allclose(float(loss), ref["loss"], rtol=LOSS_RTOL,
                               err_msg=arch)
    assert sorted(metrics) == sorted(ref["metrics"])


def check_decode_matches_direct(arch):
    """The port's twin of ``test_models_smoke.py::test_decode_matches_
    direct``: prefill S, decode one token, against a prefill of S + 1,
    within the reference's 2e-3, on the port's own init."""
    cfg = get_smoke_config(arch)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(1), device="cpu")
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S + 1))
                            .astype(np.int32))
    extra = {}
    if cfg.family == "encdec":
        extra["frames"] = torch.from_numpy(
            rng.standard_normal((B, 16, cfg.d_model)).astype(np.float32))
    _, cache = model.prefill(params, {**extra, "tokens": toks[:, :S]},
                             cache_len=S + 4)
    lg2, _ = model.decode_step(params, cache, {"tokens": toks[:, S:S + 1]})
    lgd, _ = model.prefill(params, {**extra, "tokens": toks})
    err = float((lg2 - lgd).abs().max())
    assert err < DIRECT_ATOL, (arch, err)


# ---- the full configs, on meta ---------------------------------------------

@functools.lru_cache(maxsize=None)
def _ref_shapes(arch):
    sds = jax.eval_shape(ref_build_model(ref_get_config(arch)).init,
                         jax.random.PRNGKey(0))
    return jax.tree.map(lambda x: (tuple(x.shape), np.dtype(x.dtype).name),
                        sds)


def shape_tree(params):
    return jax.tree.map(lambda x: (tuple(x.shape),
                                   str(x.dtype).replace("torch.", "")),
                        params)


def check_full_config_on_meta(arch):
    """Every leaf's path, shape and dtype equal the reference's
    ``eval_shape`` tree; the param count and the active count equal."""
    model = build_model(get_config(arch))
    params = model.init(device="meta")
    assert all(x.device.type == "meta" for x in tree_leaves(params))
    want = _ref_shapes(arch)
    assert shape_tree(params) == want
    n = sum(int(np.prod(s)) for s, _ in jax.tree.leaves(
        want, is_leaf=lambda x: isinstance(x, tuple)
        and isinstance(x[1], str)))
    assert model.param_count(params) == n > 1e8
    ref_model = ref_build_model(ref_get_config(arch))
    assert model.active_param_count() == ref_model.active_param_count()


def check_input_specs(arch):
    model = build_model(get_config(arch))
    ref_model = ref_build_model(ref_get_config(arch))
    shapes = shapes_for(model.cfg)
    assert shapes == ref_shapes_for(ref_model.cfg)
    for name, shp in shapes.items():
        got = model.input_specs(shp, shp["kind"])
        want = ref_model.input_specs(shp, shp["kind"])
        assert sorted(got) == sorted(want), (arch, name)
        for k, v in got.items():
            assert v.device.type == "meta"
            assert tuple(v.shape) == tuple(want[k].shape), (arch, name, k)
            assert str(v.dtype).replace("torch.", "") == \
                np.dtype(want[k].dtype).name, (arch, name, k)


def _spec_tuples(tree):
    return jax.tree.map(tuple, tree, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))


def check_specs(arch, axes, **kw):
    """param_specs and cache_specs equal the reference's, the configs
    replaced by ``kw`` (the quantization flags) on both sides."""
    model = build_model(get_config(arch).replace(**kw))
    ref_model = ref_build_model(ref_get_config(arch).replace(**kw))
    assert model.param_specs(axes) == _spec_tuples(
        ref_model.param_specs(axes))
    assert model.cache_specs(axes) == _spec_tuples(
        ref_model.cache_specs(axes))
