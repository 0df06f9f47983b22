"""The port's Mamba2 (``repro_torch.models.mamba2``) against the
reference's: the SSD pieces on the same numpy inputs, the port's own SSD
properties (twins of ``tests/test_mamba2.py``), the ssm family at its
SMOKE config (fp32) and at a bf16 variant, and the full Mamba2-780m
config on ``meta``."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _hyp import given, settings, st
import _torch_lm as T

from repro.models import mamba2 as RM
from repro_torch.models import mamba2 as TM

ARCH = "mamba2-780m"
PIECE_TOL = 1e-5
ORACLE_TOL = 1e-4


def _inputs(seed, b=2, s=24, h=3, p=8, n=5):
    """numpy SSD inputs: x, softplus'd dt, negative A, B, C."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = -np.exp(rng.standard_normal((h,))).astype(np.float32)
    Bm = rng.standard_normal((b, s, n)).astype(np.float32)
    Cm = rng.standard_normal((b, s, n)).astype(np.float32)
    return x, dt, A, Bm, Cm


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _close(got, want, tol=PIECE_TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


# ---- the SSD pieces against the reference's ---------------------------------

@pytest.mark.parametrize("s,chunk,with_h0", [(24, 8, False), (33, 16, False),
                                            (7, 16, True), (40, 16, True)])
def test_ssd_chunked_matches_reference(s, chunk, with_h0):
    x, dt, A, Bm, Cm = _inputs(1, s=s)
    h0 = (np.random.default_rng(2).standard_normal((2, 3, 5, 8))
          .astype(np.float32) if with_h0 else None)
    yr, hr = jax.jit(RM.ssd_chunked, static_argnums=5)(
        *_j(x, dt, A, Bm, Cm), chunk,
        h0=None if h0 is None else jnp.asarray(h0))
    yt, ht = TM.ssd_chunked(*_t(x, dt, A, Bm, Cm), chunk,
                            h0=None if h0 is None else torch.from_numpy(h0))
    assert yt.dtype == torch.float32 and ht.dtype == torch.float32
    _close(yt, yr)
    _close(ht, hr)


def test_ssd_decode_matches_reference():
    x, dt, A, Bm, Cm = _inputs(3, s=1)
    h = np.random.default_rng(4).standard_normal((2, 3, 5, 8)).astype(
        np.float32)
    yr, hr = RM.ssd_decode(*_j(x, dt, A, Bm, Cm, h))
    yt, ht = TM.ssd_decode(*_t(x, dt, A, Bm, Cm, h))
    _close(yt, yr)
    _close(ht, hr)


@pytest.mark.parametrize("s,with_state", [(10, False), (10, True),
                                          (1, True), (2, True), (2, False)])
def test_causal_conv_matches_reference(s, with_state):
    """Both of the reference's state branches: S >= K-1 and S < K-1."""
    rng = np.random.default_rng(5)
    xbc = rng.standard_normal((2, s, 6)).astype(np.float32)
    w = (rng.standard_normal((4, 6)) * 0.3).astype(np.float32)
    b = rng.standard_normal((6,)).astype(np.float32)
    state = (rng.standard_normal((2, 3, 6)).astype(np.float32)
             if with_state else None)
    opt = (lambda f: None if state is None else f(state))
    outr, str_ = RM._causal_conv(*_j(xbc, w, b), opt(jnp.asarray))
    outt, stt = TM._causal_conv(*_t(xbc, w, b), opt(torch.from_numpy))
    _close(outt, outr)
    _close(stt, str_)
    assert stt.shape == (2, 3, 6)


def test_segsum_matches_reference():
    x = np.random.default_rng(6).standard_normal((2, 3, 9)).astype(np.float32)
    want = np.asarray(RM._segsum(jnp.asarray(x)))
    got = TM._segsum(torch.from_numpy(x)).numpy()
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    _close(got[fin], want[fin])


def test_mamba2_block_matches_reference_in_both_modes():
    """One layer at SMOKE: the chunked prefill, then a decode step from
    its states, on the reference's params."""
    cfg_r = T.ref_smoke_config(ARCH)
    params = jax.tree.map(np.asarray, RM.mamba2_layer_init(
        jax.random.PRNGKey(2), cfg_r, jnp.float32))
    x = np.random.default_rng(7).standard_normal((2, 20, 64)).astype(
        np.float32)
    cfg_t = T.smoke_config(ARCH)
    lp_t = T.params_from_arrays(params, "cpu")
    block = jax.jit(functools.partial(RM.mamba2_block, cfg_r),
                    static_argnames="decode")
    outr, hr, cr = block(params, jnp.asarray(x))
    outt, ht, ct = TM.mamba2_block(cfg_t, lp_t, torch.from_numpy(x))
    for got, want in ((outt, outr), (ht, hr), (ct, cr)):
        _close(got, want)
    step = x[:, :1] * 0.5
    outr, hr, cr = block(params, jnp.asarray(step), hr, cr, decode=True)
    outt, ht, ct = TM.mamba2_block(cfg_t, lp_t, torch.from_numpy(step), ht,
                                   ct, decode=True)
    for got, want in ((outt, outr), (ht, hr), (ct, cr)):
        _close(got, want)


# ---- the port's own SSD properties (twins of tests/test_mamba2.py) ----------

def _recurrent(x, dt, A, Bm, Cm, h0=None):
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    hs = torch.zeros((b, h, n, p)) if h0 is None else h0
    ys = []
    for t in range(s):
        y, hs = TM.ssd_decode(x[:, t:t + 1], dt[:, t:t + 1], A,
                              Bm[:, t:t + 1], Cm[:, t:t + 1], hs)
        ys.append(y)
    return torch.cat(ys, dim=1), hs


@given(st.integers(1, 4), st.sampled_from([1, 7, 16, 24, 33]))
@settings(max_examples=10)
def test_chunked_equals_recurrent(chunk_pow, s):
    x, dt, A, Bm, Cm = _t(*_inputs(3, s=s))
    y1, h1 = TM.ssd_chunked(x, dt, A, Bm, Cm, 2 ** chunk_pow)
    y2, h2 = _recurrent(x, dt, A, Bm, Cm)
    _close(y1, y2.numpy(), ORACLE_TOL)
    _close(h1, h2.numpy(), ORACLE_TOL)


def test_chunked_h0_chaining():
    """[first half | second half] with the state handed over equals one
    pass — the prefill/decode state contract."""
    x, dt, A, Bm, Cm = _t(*_inputs(3, s=32))
    y_full, h_full = TM.ssd_chunked(x, dt, A, Bm, Cm, 8)
    y1, h1 = TM.ssd_chunked(x[:, :16], dt[:, :16], A, Bm[:, :16],
                            Cm[:, :16], 8)
    y2, h2 = TM.ssd_chunked(x[:, 16:], dt[:, 16:], A, Bm[:, 16:],
                            Cm[:, 16:], 8, h0=h1)
    _close(torch.cat([y1, y2], 1), y_full.numpy(), ORACLE_TOL)
    _close(h2, h_full.numpy(), ORACLE_TOL)


def test_causal_conv_streaming():
    """Streaming 1-token conv with state == full-sequence conv."""
    rng = np.random.default_rng(3)
    b, s, c, k = 2, 10, 6, 4
    xbc = torch.from_numpy(rng.standard_normal((b, s, c)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((k, c)) * 0.3).astype(
        np.float32))
    bias = torch.zeros((c,))
    full, _ = TM._causal_conv(xbc, w, bias)
    state = torch.zeros((b, k - 1, c))
    outs = []
    for t in range(s):
        o, state = TM._causal_conv(xbc[:, t:t + 1], w, bias, state)
        outs.append(o)
    _close(torch.cat(outs, 1), full.numpy())


def test_decay_stability_long_sequence():
    """No NaN/overflow at s = 512: decays are exp of negative numbers
    only."""
    x, dt, A, Bm, Cm = _t(*_inputs(3, s=512))
    y, h = TM.ssd_chunked(x, dt, A, Bm, Cm, 64)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())


def test_ssd_mixes_bf16_streams_with_f32_state():
    """x, B and C in bf16 with f32 dt / A / state (the bf16 configs'
    mix): the chunked form returns bf16 y and an f32 state, within a
    bf16 rounding of the f32 computation on the same values."""
    x, dt, A, Bm, Cm = _t(*_inputs(8, s=40))
    xb, bb, cb = (a.to(torch.bfloat16) for a in (x, Bm, Cm))
    y16, h16 = TM.ssd_chunked(xb, dt, A, bb, cb, 16)
    y32, h32 = TM.ssd_chunked(xb.float(), dt, A, bb.float(), cb.float(), 16)
    assert y16.dtype == torch.bfloat16 and h16.dtype == torch.float32
    assert T.rel_l2(h16.numpy(), h32.numpy()) < 1e-2
    assert T.rel_l2(y16.float().numpy(), y32.numpy()) < 1e-2
    y1, h1 = TM.ssd_decode(xb[:, :1], dt[:, :1], A, bb[:, :1], cb[:, :1],
                           h32)
    assert y1.dtype == torch.bfloat16 and h1.dtype == torch.float32


# ---- the ssm family at SMOKE ------------------------------------------------

def test_prefill_and_decode_logits_match_reference():
    T.check_logits(ARCH)


def test_cache_is_f32_state_and_device_scalar_len():
    cache = T.check_cache_len(ARCH)
    cfg = T.smoke_config(ARCH)
    d_inner, nh, ds, conv_dim = TM._dims(cfg)
    assert cache["ssm"].shape == (cfg.n_layers, T.B, nh, ds,
                                  cfg.ssm_head_dim)
    assert cache["ssm"].dtype == torch.float32
    assert cache["conv"].shape == (cfg.n_layers, T.B, cfg.ssm_conv - 1,
                                   conv_dim)


def test_loss_matches_reference():
    T.check_loss(ARCH)


def test_decode_matches_direct():
    T.check_decode_matches_direct(ARCH)


def test_bf16_smoke_variant_matches_reference():
    """param and compute dtype bf16: logits within a relative L2 of
    LOSSY_REL (measured 7.4e-3 on the CPU)."""
    assert T.bf16_rel_l2(ARCH) < T.LOSSY_REL


def test_init_draws_the_reference_constants():
    """The port's own init: A_log = log(linspace(1, 16, H)), D ones,
    dt_bias zeros, f32 under bf16 params; the conv and projections in
    the param dtype."""
    cfg = T.smoke_config(ARCH, bf16=True)
    params = TM.init_mamba2(cfg, torch.Generator().manual_seed(0), "cpu")
    ref = jax.tree.map(np.asarray, RM.mamba2_layer_init(
        jax.random.PRNGKey(0), T.ref_smoke_config(ARCH, True),
        jnp.bfloat16))
    lp = params["layers"]
    for name in ("A_log", "D", "dt_bias"):
        assert lp[name].dtype == torch.float32
        for i in range(cfg.n_layers):
            _close(lp[name][i], ref[name])
    assert lp["in_proj"].dtype == lp["conv_w"].dtype == torch.bfloat16
    assert float(lp["conv_w"].float().abs().max()) <= 1.0


# ---- the full config, on meta -----------------------------------------------

def test_full_config_on_meta_matches_reference():
    T.check_full_config_on_meta(ARCH)


def test_input_specs_match_reference():
    T.check_input_specs(ARCH)


@pytest.mark.parametrize("axes", T.AXES, ids=T.AXES_IDS)
def test_param_and_cache_specs_match_reference(axes):
    T.check_specs(ARCH, axes)


def test_softplus_matches_reference_across_its_threshold():
    """F.softplus against jax.nn.softplus around its linear switch-over
    (20) and far below it: the dt path of every layer."""
    x = np.array([-30.0, -5.0, 0.0, 3.0, 19.9, 20.0, 20.1, 40.0],
                 np.float32)
    _close(F.softplus(torch.from_numpy(x)),
           np.asarray(jax.nn.softplus(jnp.asarray(x))))
