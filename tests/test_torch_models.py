"""The port's LM models against the reference at the SMOKE configs (fp32,
B = 2): the reference's initialized params carried across with
``convert.params_from_arrays``, the same prompts, and prefill's last
logits, every decode step's logits, the greedy ids of an 8-step loop and
the loss compared; the full configs built on ``meta`` (param counts,
leaf shapes and dtypes, input specs) and the spec trees compared with
the reference's ``PartitionSpec``s."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_lm as T

from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.data import make_batch_for as ref_make_batch_for
from repro.models import build_model as ref_build_model
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.convert import params_from_arrays
from repro_torch.data import make_batch_for
from repro_torch.launch.serve import generate
from repro_torch.models import build_model
from repro_torch.models.api import tree_leaves

# the seven archs of the dense / moe / vlm families; the ssm, hybrid and
# encdec archs have files of their own (tests/test_torch_{mamba2,hybrid,
# encdec}.py)
ARCHS = tuple(a for a in ARCH_IDS
              if ref_get_config(a).family in ("dense", "moe", "vlm"))
B, S, GEN = 2, 16, 8
LOGIT_ATOL = 1e-4
LOSS_RTOL = 1e-5


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _prompt(cfg, seed=0):
    """The prompt batch both sides get: tokens, or for the vlm family
    input embeddings with 3-D positions (its stub frontend)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    if cfg.family != "vlm":
        return {"tokens": toks}
    emb = (rng.standard_normal((B, S, cfg.d_model)) * 0.02).astype(np.float32)
    pos = np.stack([np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)),
                    np.broadcast_to(np.arange(S, dtype=np.int32) // 4,
                                    (B, S)),
                    np.broadcast_to(np.arange(S, dtype=np.int32) % 4,
                                    (B, S))])
    return {"input_embeds": emb, "positions": pos}


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The reference's params (numpy), its prefill / decode logits and
    greedy ids over GEN tokens, and its loss on a train batch."""
    cfg = ref_get_smoke_config(arch)
    model = ref_build_model(cfg)
    params = model.init(jax.random.PRNGKey(1))
    prompt = _prompt(cfg)
    prefill = jax.jit(functools.partial(model.prefill, cache_len=S + GEN))
    decode = jax.jit(model.decode_step)
    lg, cache = prefill(params, {k: jnp.asarray(v)
                                 for k, v in prompt.items()})
    logits = [np.asarray(lg[:, -1])]
    ids = [np.asarray(jnp.argmax(lg[:, -1], -1)).astype(np.int32)]
    for _ in range(GEN - 1):
        lg, cache = decode(params, cache,
                           {"tokens": jnp.asarray(ids[-1][:, None])})
        logits.append(np.asarray(lg[:, -1]))
        ids.append(np.asarray(jnp.argmax(lg[:, -1], -1)).astype(np.int32))
    batch = ref_make_batch_for(cfg, {"global_batch": B, "seq_len": 2 * S},
                               "train", seed=3)
    loss, metrics = jax.jit(model.loss)(params, batch)
    return {"params": _np_tree(params), "prompt": prompt,
            "logits": np.stack(logits, 1), "ids": np.stack(ids, 1),
            "cache_len": int(cache["len"]),
            "loss": float(loss),
            "metrics": {k: float(v) for k, v in metrics.items()}}


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    arch = request.param
    ref = _reference(arch)
    model = build_model(get_smoke_config(arch))
    return arch, ref, model, params_from_arrays(ref["params"], "cpu")


def test_prefill_and_decode_logits_match_reference(pair):
    arch, ref, model, params = pair
    prompt = {k: _t(v) for k, v in ref["prompt"].items()}
    ids, logits = generate(model, params, prompt, GEN, cache_len=S + GEN)
    assert logits.shape == ref["logits"].shape
    err = np.abs(logits.numpy() - ref["logits"]).max(axis=(0, 2))
    assert err.max() < LOGIT_ATOL, (arch, err)
    np.testing.assert_array_equal(ids.numpy(), ref["ids"], err_msg=arch)
    assert ids.dtype == torch.int32


def test_cache_len_is_a_device_scalar(pair):
    arch, ref, model, params = pair
    prompt = {k: _t(v) for k, v in ref["prompt"].items()}
    _, cache = model.prefill(params, prompt, cache_len=S + GEN)
    assert cache["len"].shape == () and cache["len"].dtype == torch.int32
    _, cache2 = model.decode_step(
        params, cache, {"tokens": torch.zeros((B, 1), dtype=torch.int32)})
    assert int(cache2["len"]) == int(cache["len"]) + 1 == S + 1
    assert cache2["k"].shape == (model.cfg.n_layers, B, S + GEN,
                                 model.cfg.n_kv_heads, model.cfg.hd)


def test_loss_matches_reference(pair):
    arch, ref, model, params = pair
    batch = make_batch_for(model.cfg, {"global_batch": B, "seq_len": 2 * S},
                           "train", seed=3, device="cpu")
    loss, metrics = model.loss(params, batch)
    np.testing.assert_allclose(float(loss), ref["loss"], rtol=LOSS_RTOL,
                               err_msg=arch)
    for k, v in ref["metrics"].items():
        np.testing.assert_allclose(float(metrics[k]), v, rtol=LOSS_RTOL,
                                   atol=1e-7, err_msg=f"{arch} {k}")


@pytest.mark.parametrize("arch", [a for a in ARCHS if a != "qwen2-vl-2b"])
def test_decode_matches_direct(arch):
    """The port's twin of the reference's own bound: prefill S, decode
    one token, against a prefill of S + 1 (MoE drop-free)."""
    cfg = get_smoke_config(arch)
    if cfg.is_moe:
        cfg = cfg.replace(capacity_factor=8.0)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(1), device="cpu")
    rng = np.random.default_rng(0)
    toks = _t(rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32))
    _, cache = model.prefill(params, {"tokens": toks[:, :S]},
                             cache_len=S + 4)
    lg2, _ = model.decode_step(params, cache, {"tokens": toks[:, S:S + 1]})
    lgd, _ = model.prefill(params, {"tokens": toks})
    assert float((lg2 - lgd).abs().max()) < 2e-3, arch


def test_vlm_mrope_positions_affect_output():
    cfg = get_smoke_config("qwen2-vl-2b")
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    batch = make_batch_for(cfg, {"global_batch": B, "seq_len": 32}, "train",
                           device="cpu")
    l1, _ = model.loss(params, batch)
    l2, _ = model.loss(params, {**batch, "positions": batch["positions"] * 3})
    assert not np.isclose(float(l1), float(l2))


# ---- the full configs, on meta ---------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_on_meta_matches_reference(arch):
    """Every leaf's path, shape and dtype equal the reference's
    ``eval_shape`` tree; param counts and active counts equal; nothing
    is allocated (Kimi K2 has ~1e12 params)."""
    T.check_full_config_on_meta(arch)


def test_yi_param_count_matches_billing():
    model = build_model(get_config("yi-6b"))
    total = model.param_count(model.init(device="meta"))
    assert abs(total - model.active_param_count()) / total < 0.01


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(arch):
    T.check_input_specs(arch)


@pytest.mark.parametrize("axes", T.AXES, ids=T.AXES_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_cache_specs_match_reference(arch, axes):
    for quant in (False, True):
        T.check_specs(arch, axes, weight_quant=quant, kv_quant=quant)


# ---- the port's own init -------------------------------------------------

def _scales(cfg):
    """The truncated normals' scales by leaf name (ones and zeros: 0)."""
    d = cfg.d_model
    inner = cfg.d_expert if cfg.is_moe else cfg.d_ff
    return {"table": 0.02, "lm_head": d ** -0.5, "wq": d ** -0.5,
            "wk": d ** -0.5, "wv": d ** -0.5, "router": d ** -0.5,
            "wo": d ** -0.5, "w1": d ** -0.5, "w3": d ** -0.5,
            "w2": inner ** -0.5}


@pytest.mark.parametrize("arch", ARCHS)
def test_port_init_matches_reference_tree(arch):
    """The port's draw: the reference's keys, shapes and dtypes, normals
    within ±2·scale with the truncated normal's spread, ones and zeros
    where the reference has them."""
    ref = _reference(arch)
    cfg = get_smoke_config(arch)
    params = build_model(cfg).init(torch.Generator().manual_seed(0),
                                   device="cpu")
    assert T.shape_tree(params) == jax.tree.map(
        lambda x: (x.shape, x.dtype.name), ref["params"])
    scales = _scales(cfg)
    flat, _ = jax.tree_util.tree_flatten_with_path(ref["params"])
    got = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda x: x.numpy(), params))[0])
    for path, want in flat:
        mine = got[path]
        name = path[-1].key
        if np.all(want == 1.0) or np.all(want == 0.0):
            np.testing.assert_array_equal(mine, want, err_msg=str(path))
            continue
        scale = scales[name]
        assert np.abs(mine).max() <= 2 * scale * (1 + 1e-6), path
        # the unit normal truncated to [-2, 2] has std 0.8796
        assert abs(mine.std() / scale - 0.8796) < 0.1, path


def test_init_generator_reproducible_and_seeded():
    model = build_model(get_smoke_config("minicpm-2b"))
    a = model.init(7, device="cpu")
    b = model.init(torch.Generator().manual_seed(7), device="cpu")
    c = model.init(8, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))
    assert not torch.equal(a["embed"]["table"], c["embed"]["table"])


# ---- the layers, one by one ------------------------------------------------

def _layer_cases():
    from repro.models import layers as RL
    from repro_torch.models import layers as TL
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 12, 4, 16)).astype(np.float32)
    h = rng.standard_normal((2, 12, 64)).astype(np.float32)
    pos = rng.integers(0, 500, (2, 12)).astype(np.int32)
    pos3 = rng.integers(0, 500, (3, 2, 12)).astype(np.int32)
    scale = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(64)).astype(np.float32)
    w1 = rng.standard_normal((64, 96)).astype(np.float32) / 8
    w2 = rng.standard_normal((96, 64)).astype(np.float32) / 10
    b1 = rng.standard_normal(96).astype(np.float32)
    table = rng.standard_normal((40, 64)).astype(np.float32)
    j, t = jnp.asarray, torch.from_numpy
    return {
        "rmsnorm": (lambda: RL.rmsnorm({"scale": j(scale)}, j(h), 1e-5),
                    lambda: TL.rmsnorm({"scale": t(scale)}, t(h), 1e-5)),
        "layernorm": (
            lambda: RL.layernorm({"scale": j(scale), "bias": j(bias)}, j(h)),
            lambda: TL.layernorm({"scale": t(scale), "bias": t(bias)}, t(h))),
        "rope": (lambda: RL.apply_rope(j(x), j(pos), 5e5),
                 lambda: TL.apply_rope(t(x), t(pos), 5e5)),
        "mrope": (lambda: RL.apply_mrope(j(x), j(pos3), (2, 3, 3), 1e6),
                  lambda: TL.apply_mrope(t(x), t(pos3), (2, 3, 3), 1e6)),
        "sinusoidal": (lambda: RL.sinusoidal_positions(50, 64),
                       lambda: TL.sinusoidal_positions(50, 64)),
        "gelu_mlp": (
            lambda: RL.gelu_mlp({"w1": j(w1), "b1": j(b1), "w2": j(w2),
                                 "b2": j(bias)}, j(h)),
            lambda: TL.gelu_mlp({"w1": t(w1), "b1": t(b1), "w2": t(w2),
                                 "b2": t(bias)}, t(h))),
        "swiglu": (
            lambda: RL.swiglu({"w1": j(w1), "w3": j(w1[:, ::-1].copy()),
                               "w2": j(w2)}, j(h)),
            lambda: TL.swiglu({"w1": t(w1), "w3": t(w1[:, ::-1].copy()),
                               "w2": t(w2)}, t(h))),
        "unembed": (lambda: RL.unembed({}, j(h), j(table.T.copy())),
                    lambda: TL.unembed({}, t(h), t(table.T.copy()))),
        "embed": (lambda: RL.embed({"table": j(table)}, j(pos % 40),
                                   jnp.float32),
                  lambda: TL.embed({"table": t(table)}, t(pos % 40),
                                   torch.float32)),
    }


@pytest.mark.parametrize("name", ["rmsnorm", "layernorm", "rope", "mrope",
                                  "sinusoidal", "gelu_mlp", "swiglu",
                                  "unembed", "embed"])
def test_layer_matches_reference(name):
    ref, port = _layer_cases()[name]
    want, got = np.asarray(ref()), port().numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_sdpa_masks_rows_with_no_key_uniformly():
    """The reference's -1e30 mask: a row that sees no key gets a uniform
    softmax (the mean of v), not NaN; long queries run in blocks."""
    from repro.models import layers as RL
    from repro_torch.models import layers as TL
    rng = np.random.default_rng(12)
    q = rng.standard_normal((1, 1100, 2, 8)).astype(np.float32)
    k = rng.standard_normal((1, 1100, 2, 8)).astype(np.float32)
    v = rng.standard_normal((1, 1100, 2, 8)).astype(np.float32)
    want = np.asarray(RL._sdpa(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), True))
    got = TL._sdpa(torch.from_numpy(q), torch.from_numpy(k),
                   torch.from_numpy(v), True).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    blank = TL._sdpa(torch.from_numpy(q[:, :3]), torch.from_numpy(k[:, :4]),
                     torch.from_numpy(v[:, :4]), True, q_offset=0,
                     kmask_len=0)
    np.testing.assert_allclose(blank.numpy()[0, 0],
                               v[0, :4].mean(axis=0), rtol=1e-5, atol=1e-6)
