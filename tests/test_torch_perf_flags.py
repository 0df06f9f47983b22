"""The opt-in performance flags of the port against the reference's
(``tests/test_perf_flags.py``'s twins): the int8 KV cache (codes within
one step of the reference's, scales to rtol 1e-5, decode against direct
in the port within 2e-3), the int8 MoE weights, sequence-sharded
activation checkpoints (the loss unchanged), and the weight-quantized
spec trees."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.models import build_model as ref_build_model
from repro.models import layers as RL
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_arrays
from repro_torch.models import build_model
from repro_torch.models import layers as TL
from repro_torch.models.api import tree_map

B, S = 2, 16


def _tree_keys(tree):
    if isinstance(tree, dict):
        return {k: _tree_keys(v) for k, v in tree.items()}
    return None


def test_kv_quantize_matches_reference():
    x = np.random.default_rng(0).standard_normal((2, 16, 4, 16)).astype(
        np.float32)
    x[0, 0, 0] = 0.0                     # an all-zero row: scale floored
    codes, scale = RL._kv_quantize(jnp.asarray(x))
    tcodes, tscale = TL._kv_quantize(torch.from_numpy(x))
    assert tcodes.dtype == torch.int8
    assert np.abs(tcodes.numpy().astype(np.int32)
                  - np.asarray(codes).astype(np.int32)).max() <= 1
    np.testing.assert_allclose(tscale.numpy(), np.asarray(scale), rtol=1e-5)
    np.testing.assert_allclose(
        TL._kv_dequantize(tcodes, tscale, torch.float32).numpy(),
        np.asarray(RL._kv_dequantize(codes, scale, jnp.float32)),
        rtol=1e-5, atol=1e-6)


def test_kv_quant_prefill_cache_matches_reference():
    ref_cfg = ref_get_smoke_config("yi-6b").replace(kv_quant=True)
    ref_model = ref_build_model(ref_cfg)
    params = ref_model.init(jax.random.PRNGKey(1))
    toks = np.random.default_rng(0).integers(0, ref_cfg.vocab, (B, S)).astype(
        np.int32)
    lg, cache = jax.jit(functools.partial(ref_model.prefill,
                                          cache_len=S + 4))(
        params, {"tokens": jnp.asarray(toks)})
    model = build_model(get_smoke_config("yi-6b").replace(kv_quant=True))
    tp = params_from_arrays(jax.tree.map(np.asarray, params), "cpu")
    tlg, tcache = model.prefill(tp, {"tokens": torch.from_numpy(toks)},
                                cache_len=S + 4)
    for k in ("k", "v"):
        assert tcache[k].dtype == torch.int8
        assert np.abs(tcache[k].numpy().astype(np.int32)
                      - np.asarray(cache[k]).astype(np.int32)).max() <= 1
        np.testing.assert_allclose(tcache[f"{k}_scale"].numpy(),
                                   np.asarray(cache[f"{k}_scale"]),
                                   rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tlg.numpy(), np.asarray(lg), atol=1e-4)


def test_kv_quant_decode_consistency():
    cfg = get_smoke_config("yi-6b").replace(kv_quant=True)
    model = build_model(cfg)
    params = model.init(1, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (B, S + 1)).astype(np.int32))
    _, cache = model.prefill(params, {"tokens": toks[:, :S]},
                             cache_len=S + 4)
    assert cache["k"].dtype == torch.int8
    lg2, _ = model.decode_step(params, cache, {"tokens": toks[:, S:S + 1]})
    lgd, _ = model.prefill(params, {"tokens": toks})
    # both paths quantize identically => tight match
    assert float((lg2 - lgd).abs().max()) < 2e-3


def test_kv_quant_close_to_plain_cache():
    cfg = get_smoke_config("yi-6b")
    model = build_model(cfg)
    model_q = build_model(cfg.replace(kv_quant=True))
    params = model.init(1, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (B, S)).astype(np.int32))
    lg, _ = model.prefill(params, {"tokens": toks})
    lgq, _ = model_q.prefill(params, {"tokens": toks})
    rel = float(torch.linalg.norm(lg - lgq) / torch.linalg.norm(lg))
    assert rel < 0.05, rel


def test_weight_quant_moe_model_matches_reference():
    """A whole weight-quantized MoE model: the reference's int8 params
    carried across, prefill logits within 1e-4."""
    ref_cfg = ref_get_smoke_config("qwen3-moe-235b-a22b").replace(
        weight_quant=True)
    ref_model = ref_build_model(ref_cfg)
    params = ref_model.init(jax.random.PRNGKey(0))
    toks = np.random.default_rng(2).integers(0, ref_cfg.vocab, (B, S)).astype(
        np.int32)
    lg, _ = jax.jit(ref_model.prefill)(params, {"tokens": jnp.asarray(toks)})
    model = build_model(get_smoke_config("qwen3-moe-235b-a22b").replace(
        weight_quant=True))
    tp = params_from_arrays(jax.tree.map(np.asarray, params), "cpu")
    assert tp["layers"]["moe"]["w1"].dtype == torch.int8
    tlg, _ = model.prefill(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tlg.numpy(), np.asarray(lg), atol=1e-4)


def test_weight_quant_param_specs_cover_scales():
    cfg = get_smoke_config("qwen3-moe-235b-a22b").replace(weight_quant=True)
    model = build_model(cfg)
    params = model.init(device="meta")
    specs = model.param_specs({"data": 2, "model": 4})
    # the spec tree matches the quantized param tree, leaf for leaf
    assert _tree_keys(specs) == _tree_keys(params)
    assert "w1_scale" in specs["layers"]["moe"]
    tree_map(lambda p, s: None, params, specs)


def test_seq_shard_acts_semantics_unchanged():
    """The reference's loss under seq_shard_acts and full remat equals
    its plain loss and the port's, which has neither knob: on one card
    both are placements and recomputations, not numerics."""
    ref_cfg = ref_get_smoke_config("yi-6b")
    ref_params = ref_build_model(ref_cfg).init(jax.random.PRNGKey(2))
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, ref_cfg.vocab, (B, 32)).astype(
        np.int32), "labels": rng.integers(0, ref_cfg.vocab, (B, 32)).astype(
        np.int32)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    ref_plain, _ = jax.jit(ref_build_model(ref_cfg).loss)(ref_params, jb)
    ref_loss, _ = jax.jit(ref_build_model(ref_cfg.replace(
        seq_shard_acts=True, remat="full")).loss)(ref_params, jb)
    assert np.isclose(float(ref_plain), float(ref_loss), rtol=1e-5)
    params = params_from_arrays(jax.tree.map(np.asarray, ref_params), "cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, _ = build_model(get_smoke_config("yi-6b")).loss(params, tb)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
