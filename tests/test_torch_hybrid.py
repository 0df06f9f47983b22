"""The port's Zamba2-style hybrid (``repro_torch.models.hybrid``) against
the reference's: the hybrid family at its SMOKE config (fp32) and at a
bf16 variant, its grouped tree and one shared block, and the full
Zamba2-2.7B config on ``meta``."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_lm as T

from repro.models import hybrid as RH
from repro_torch.models import hybrid as TH
from repro_torch.models import layers as L
from repro_torch.models import transformer as TT

ARCH = "zamba2-2.7b"


def test_prefill_and_decode_logits_match_reference():
    T.check_logits(ARCH)


def test_cache_holds_every_group_and_a_device_scalar_len():
    cache = T.check_cache_len(ARCH)
    cfg = T.smoke_config(ARCH)
    g, k = cfg.n_layers // cfg.attn_every, cfg.attn_every
    assert cache["ssm"].shape[:3] == (g, k, T.B)
    assert cache["ssm"].dtype == torch.float32
    assert cache["conv"].shape[:3] == (g, k, T.B)
    assert cache["kv_k"].shape == cache["kv_v"].shape == (
        g, T.B, T.S + T.GEN, cfg.n_kv_heads, cfg.hd)


def test_loss_matches_reference():
    T.check_loss(ARCH)


def test_decode_matches_direct():
    T.check_decode_matches_direct(ARCH)


def test_bf16_smoke_variant_matches_reference():
    """param and compute dtype bf16: logits within a relative L2 of
    LOSSY_REL (measured 1.6e-2 on the CPU)."""
    assert T.bf16_rel_l2(ARCH) < T.LOSSY_REL


def test_init_regroups_the_stacked_layers():
    """The port's own init: the L Mamba2 layers drawn stacked and
    regrouped (L, ...) -> (G, k, ...) in layer order; one shared block."""
    cfg = T.smoke_config(ARCH)
    gen = torch.Generator().manual_seed(0)
    params = TH.init_hybrid(cfg, gen, "cpu")
    ref = jax.eval_shape(RH.make_hybrid_model(T.ref_smoke_config(ARCH)).init,
                         jax.random.PRNGKey(0))
    assert T.shape_tree(params) == jax.tree.map(
        lambda x: (tuple(x.shape), np.dtype(x.dtype).name), ref)
    g, k = TH._groups(cfg), cfg.attn_every
    from repro_torch.models.mamba2 import mamba2_layer_init
    stacked = mamba2_layer_init(torch.Generator().manual_seed(0), cfg,
                                cfg.param_dtype, device="cpu",
                                lead=(cfg.n_layers,))
    assert torch.equal(params["mamba"]["in_proj"].reshape(
        cfg.n_layers, *stacked["in_proj"].shape[1:]), stacked["in_proj"])
    assert params["mamba"]["in_proj"].shape[:2] == (g, k)
    assert params["shared"]["attn"]["wq"].dim() == 2


def test_groups_refuse_a_ragged_split():
    with pytest.raises(ValueError, match="attn_every"):
        TH._groups(T.smoke_config(ARCH, attn_every=3))


def test_shared_block_matches_reference():
    """The shared attention + SwiGLU block on the reference's params,
    with the port's RoPE table built once from the positions."""
    cfg_r = T.ref_smoke_config(ARCH)
    params = T.reference(ARCH)["params"]["shared"]
    x = np.random.default_rng(9).standard_normal((2, 12, 64)).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12))
    block = jax.jit(functools.partial(RH._shared_block, cfg_r))
    want, _ = block(jax.tree.map(jnp.asarray, params), jnp.asarray(x),
                    jnp.asarray(pos), None, None)
    cfg_t = T.smoke_config(ARCH)
    rope = TT._rope(cfg_t, torch.from_numpy(pos.copy()))
    got, _ = TH._shared_block(cfg_t, T.params_from_arrays(params, "cpu"),
                              torch.from_numpy(x), rope, None, None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_decode_positions_follow_the_cache_length():
    """A decode step's RoPE rows are those of positions len .. len+S-1
    (a 0-d tensor start): the table equals the one built from the
    explicit positions."""
    cfg = T.smoke_config(ARCH)
    start = torch.tensor(T.S, dtype=torch.int32)
    pos = TT._default_positions(cfg, T.B, 1, torch.device("cpu"),
                                start=start)
    sin, cos = TT._rope(cfg, pos)
    want = L.rope_table(torch.full((T.B, 1), T.S, dtype=torch.int32),
                        cfg.hd, cfg.rope_theta)
    assert torch.equal(sin, want[0]) and torch.equal(cos, want[1])


# ---- the full config, on meta -----------------------------------------------

def test_full_config_on_meta_matches_reference():
    T.check_full_config_on_meta(ARCH)


def test_input_specs_match_reference():
    T.check_input_specs(ARCH)


@pytest.mark.parametrize("axes", T.AXES, ids=T.AXES_IDS)
def test_param_and_cache_specs_match_reference(axes):
    T.check_specs(ARCH, axes)
