"""The port's Whisper-style encoder-decoder (``repro_torch.models.encdec``)
against the reference's: the encdec family at its SMOKE config (fp32)
and at a bf16 variant, cross-attention through ``kv_override``, the
decoder's position row and its clamp, the serve launcher's frames, and the
full Whisper-large-v3 config on ``meta``."""
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_lm as T

import repro.launch.serve as RS
from repro.models import encdec as RE
from repro.models import layers as RL
from repro_torch.launch import serve as TS
from repro_torch.models import encdec as TE
from repro_torch.models import layers as L

ARCH = "whisper-large-v3"
SAMPLE = re.compile(r"sample output ids: (\[[0-9, ]*\])")


def test_prefill_and_decode_logits_match_reference():
    T.check_logits(ARCH)


def test_cache_holds_cross_kv_and_a_device_scalar_len():
    cache = T.check_cache_len(ARCH)
    cfg = T.smoke_config(ARCH)
    assert cache["k"].shape == (cfg.n_dec_layers, T.B, T.S + T.GEN,
                                cfg.n_kv_heads, cfg.hd)
    assert cache["cross_k"].shape == cache["cross_v"].shape == (
        cfg.n_dec_layers, T.B, T.FRAMES, cfg.n_kv_heads, cfg.hd)


def test_loss_matches_reference():
    T.check_loss(ARCH)


def test_decode_matches_direct():
    T.check_decode_matches_direct(ARCH)


def test_bf16_smoke_variant_matches_reference():
    """param and compute dtype bf16: logits within a relative L2 of
    LOSSY_REL (measured 6.3e-3 on the CPU)."""
    assert T.bf16_rel_l2(ARCH) < T.LOSSY_REL


def test_position_clamp_matches_reference():
    """max_cache_len below the decode positions (S .. S+GEN-2 against a
    table of 10 rows): the reference's dynamic_slice clamps the row
    index, and the port's clamped row gives its logits."""
    ref, model, params = T.port_pair(ARCH, max_cache_len=10)
    logits, ids = T.port_logits(model, params, ref)
    err = np.abs(logits - ref["logits"]).max()
    assert err < T.LOGIT_ATOL
    np.testing.assert_array_equal(ids, ref["ids"])
    unclamped = T.reference(ARCH)["logits"]
    assert np.abs(unclamped[:, 1:] - ref["logits"][:, 1:]).max() > 1e-3


@pytest.mark.parametrize("d", [64, 1280])
def test_sinusoidal_rows_equal_the_table_rows(d):
    """A decode step's one row, computed alone, is the table's row bit
    for bit, at SMOKE's width and Whisper's."""
    n = 2048
    table = L.sinusoidal_positions(n, d)
    for p in (0, 1, 17, 1499, n - 1):
        row = L.sinusoidal_rows(torch.tensor([p], dtype=torch.int32), d)
        assert torch.equal(row[0], table[p]), p


def test_encode_matches_reference():
    """The bidirectional encoder over 32 frames on the reference's
    params (sinusoidal positions, layernorm, GELU)."""
    params = T.reference(ARCH)["params"]
    frames = (np.random.default_rng(4).standard_normal((2, 32, 64))
              * 0.02).astype(np.float32)
    want = jax.jit(functools.partial(RE.encode, T.ref_smoke_config(ARCH)))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(frames))
    got = TE.encode(T.smoke_config(ARCH), T.params_from_arrays(params, "cpu"),
                    torch.from_numpy(frames))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_attention_kv_override_matches_reference():
    """Cross-attention: keys and values taken from the tuple, q projected
    with its bias, no rotation; 1,100 queries run in ATTN_CHUNK blocks."""
    rng = np.random.default_rng(5)
    d, h, hd = 32, 4, 8
    p = {n: (rng.standard_normal(shape) * 0.2).astype(np.float32)
         for n, shape in (("wq", (d, h * hd)), ("wk", (d, h * hd)),
                          ("wv", (d, h * hd)), ("wo", (h * hd, d)),
                          ("bq", (h * hd,)), ("bk", (h * hd,)),
                          ("bv", (h * hd,)))}
    x = rng.standard_normal((2, 1100, d)).astype(np.float32)
    k = rng.standard_normal((2, 30, h, hd)).astype(np.float32)
    v = rng.standard_normal((2, 30, h, hd)).astype(np.float32)
    want, _ = RL.attention(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                           n_heads=h, n_kv_heads=h, head_dim=hd,
                           causal=False, use_rope=False,
                           kv_override=(jnp.asarray(k), jnp.asarray(v)))
    got, cache = L.attention({n: torch.from_numpy(a) for n, a in p.items()},
                             torch.from_numpy(x), n_heads=h, n_kv_heads=h,
                             head_dim=hd, causal=False,
                             kv_override=(torch.from_numpy(k),
                                          torch.from_numpy(v)))
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_serve_equals_reference_serve(capsys, monkeypatch):
    """The reference's serve CLI on whisper at SMOKE, its params
    recorded, then the port's ``serve`` on those params from the same
    seed: the tokens and then the 32 frames drawn in the reference's
    order, the same sample ids a batch."""
    seen = {}
    build = RS.build_model

    def spy_build(cfg):
        model = build(cfg)
        init = model.init

        def recording_init(key):
            seen["params"] = init(key)
            return seen["params"]

        model.init = recording_init
        return model

    monkeypatch.setattr(RS, "build_model", spy_build)
    args = ["--requests", "4", "--batch", "2", "--prompt-len", "8",
            "--gen-len", "6", "--seed", "5"]
    RS.main(["--arch", ARCH, "--smoke", *args])
    want = SAMPLE.findall(capsys.readouterr().out)
    model = TS.build_model(T.smoke_config(ARCH))
    params = T.params_from_arrays(jax.tree.map(np.asarray, seen["params"]),
                                  "cpu")
    report = TS.serve(model, params, requests=4, batch=2, prompt_len=8,
                      gen_len=6, seed=5, device=torch.device("cpu"))
    got = SAMPLE.findall(capsys.readouterr().out)
    assert len(want) == 2 and got == want
    assert report["tokens"] == 24


def test_prompt_batch_draws_frames_after_tokens():
    cfg = T.smoke_config(ARCH)
    batch = TS.prompt_batch(cfg, np.random.default_rng(3), 2, 8, "cpu")
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab, (2, 8))
    frames = rng.standard_normal((2, 32, cfg.d_model)) * 0.02
    assert torch.equal(batch["tokens"], torch.from_numpy(toks).int())
    assert batch["frames"].dtype == cfg.compute_dtype
    np.testing.assert_array_equal(batch["frames"].numpy(),
                                  frames.astype(np.float32))


# ---- the full config, on meta -----------------------------------------------

def test_full_config_on_meta_matches_reference():
    T.check_full_config_on_meta(ARCH)


def test_input_specs_match_reference():
    T.check_input_specs(ARCH)


@pytest.mark.parametrize("axes", T.AXES, ids=T.AXES_IDS)
def test_param_and_cache_specs_match_reference(axes):
    T.check_specs(ARCH, axes)
