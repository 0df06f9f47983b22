"""The port's MoE dispatch against the reference's (``models/moe.py``) at
the SMOKE config in fp32: the routed experts, the slot table and the
capacity filter equal, the output within the reference's own 1e-5, the
drop fraction exact and the aux loss to rtol 1e-6 — drop-free, with
drops (capacity factor 0.1) and with a shared expert; ``_capacity`` on
a sweep; the combine's fixed order and top-k's tie rule."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as RM
from repro.configs import get_smoke_config as ref_get_smoke_config
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_arrays
from repro_torch.models import moe as TM

Y_ATOL = 1e-5          # tests/test_moe.py's bound
AUX_RTOL = 1e-6
CASES = {"dropfree": dict(cf=8.0, b=2, s=8, shared=0),
         "drops": dict(cf=0.1, b=4, s=32, shared=0),
         "shared": dict(cf=8.0, b=2, s=8, shared=1),
         "default": dict(cf=1.25, b=2, s=16, shared=0)}


def _cfgs(case):
    kw = dict(capacity_factor=case["cf"], n_shared_experts=case["shared"])
    return (ref_get_smoke_config("qwen3-moe-235b-a22b").replace(**kw),
            get_smoke_config("qwen3-moe-235b-a22b").replace(**kw))


def _reference_run(cfg, params, x):
    """The reference's moe_ffn, eagerly, with the routed experts (its
    ``lax.top_k``) and the slot table (its ``constrain`` on slot_tok)
    recorded on the way."""
    seen = {}
    top_k, constrain = jax.lax.top_k, RM.constrain

    def spy_top_k(a, k):
        out = top_k(a, k)
        seen["expert"] = np.asarray(out[1])
        return out

    def spy_constrain(t, *spec):
        if t.dtype == jnp.int32 and t.ndim == 3:
            seen["slot_tok"] = np.asarray(t)
        return constrain(t, *spec)

    RM.constrain = spy_constrain
    jax.lax.top_k = spy_top_k
    try:
        y, aux = RM.moe_ffn(params, x, cfg)
    finally:
        RM.constrain, jax.lax.top_k = constrain, top_k
    return np.asarray(y), {k: float(v) for k, v in aux.items()}, seen


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    c = CASES[request.param]
    ref_cfg, cfg = _cfgs(c)
    params = RM.moe_init(jax.random.PRNGKey(0), ref_cfg, jnp.float32)
    x = np.random.default_rng(0).standard_normal(
        (c["b"], c["s"], cfg.d_model)).astype(np.float32)
    y, aux, seen = _reference_run(ref_cfg, params, jnp.asarray(x))
    tparams = params_from_arrays(jax.tree.map(np.asarray, params), "cpu")
    return request.param, cfg, tparams, torch.from_numpy(x), y, aux, seen


def test_moe_output_and_aux_match_reference(case):
    name, cfg, params, x, y, aux, _ = case
    ty, taux = TM.moe_ffn(params, x, cfg)
    np.testing.assert_allclose(ty.numpy(), y, atol=Y_ATOL, err_msg=name)
    assert float(taux["moe_drop_frac"]) == aux["moe_drop_frac"], name
    np.testing.assert_allclose(float(taux["moe_aux_loss"]),
                               aux["moe_aux_loss"], rtol=AUX_RTOL)
    if name == "drops":
        assert aux["moe_drop_frac"] > 0.0
    if name in ("dropfree", "shared"):
        assert aux["moe_drop_frac"] == 0.0


def test_moe_routing_equals_reference(case):
    """The experts, the slot table (which token fills which slot, -1 for
    an empty one) and the kept pairs equal the reference's, exactly."""
    name, cfg, params, x, _, _, seen = case
    t = x.shape[0] * x.shape[1]
    cap = TM._capacity(t, cfg)
    x3 = x.reshape(1, t, cfg.d_model)
    _, flat_e, pair_slot, keep, slot_tok, _ = TM.route(params, x3, cfg, cap)
    np.testing.assert_array_equal(
        flat_e.reshape(1, t, cfg.top_k).numpy(), seen["expert"])
    np.testing.assert_array_equal(
        slot_tok.reshape(1, cfg.n_experts, cap).numpy(), seen["slot_tok"])
    # the kept pairs: (expert, token) of every filled reference slot
    want = {(e, int(tok)) for e, row in enumerate(seen["slot_tok"][0])
            for tok in row if tok >= 0}
    e_of = flat_e.reshape(-1).numpy()
    kept = pair_slot.reshape(-1).numpy() < cfg.n_experts * cap
    got = {(int(e_of[i]), i // cfg.top_k) for i in np.flatnonzero(kept)}
    assert got == want
    assert int(keep.sum(dtype=torch.int32)) == len(want)


def test_capacity_equals_reference():
    for arch in ("qwen3-moe-235b-a22b", "kimi-k2-1t-a32b"):
        ref_cfg = ref_get_smoke_config(arch)
        cfg = get_smoke_config(arch)
        for cf in (0.1, 1.0, 1.25, 8.0):
            for t in list(range(1, 70)) + [127, 128, 1000, 1024, 8192]:
                assert TM._capacity(t, cfg.replace(capacity_factor=cf)) == \
                    RM._capacity(t, ref_cfg.replace(capacity_factor=cf))


def test_moe_exact_vs_dense_reference():
    """The port's twin of the reference's own: drop-free dispatch equals
    a per-token dense computation."""
    cfg = get_smoke_config("qwen3-moe-235b-a22b").replace(capacity_factor=8.0)
    params = TM.moe_init(torch.Generator().manual_seed(0), cfg,
                         torch.float32, device="cpu")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 8, cfg.d_model)).astype(np.float32))
    y, aux = TM.moe_ffn(params, x, cfg)
    assert float(aux["moe_drop_frac"]) == 0.0
    x2 = x.reshape(-1, cfg.d_model)
    probs = torch.softmax(x2 @ params["router"], -1)
    gate, expert = TM._top_k(probs, cfg.top_k)
    gate = gate / gate.sum(-1, keepdim=True)
    yref = torch.zeros_like(x2)
    for i in range(x2.shape[0]):
        for j in range(cfg.top_k):
            e = int(expert[i, j])
            h = torch.nn.functional.silu(x2[i] @ params["w1"][e]) \
                * (x2[i] @ params["w3"][e])
            yref[i] += gate[i, j] * (h @ params["w2"][e])
    np.testing.assert_allclose(y.reshape(-1, cfg.d_model).numpy(),
                               yref.numpy(), atol=Y_ATOL)


def test_combine_adds_in_ascending_slot_order():
    """Each token's output is ((0 + eo[s1]) + eo[s2]) + … over its kept
    slots in ascending order — bit for bit, the order the reference's
    scatter-add takes."""
    cfg = get_smoke_config("kimi-k2-1t-a32b").replace(capacity_factor=0.5)
    params = TM.moe_init(torch.Generator().manual_seed(3), cfg,
                         torch.float32, device="cpu")
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32))
    y, _ = TM.moe_ffn(params, x, cfg)
    t, e = 32, cfg.n_experts
    cap = TM._capacity(t, cfg)
    _, _, _, _, slot_tok, slot_gate = TM.route(
        params, x.reshape(1, t, -1), cfg, cap)
    st = slot_tok.reshape(e, cap)
    xin = torch.where((st >= 0)[..., None], x.reshape(t, -1)[st.clamp(min=0)],
                      torch.zeros(()))
    h = torch.nn.functional.silu(torch.einsum("ecd,edf->ecf", xin,
                                              params["w1"])) \
        * torch.einsum("ecd,edf->ecf", xin, params["w3"])
    eo = torch.einsum("ecf,efd->ecd", h, params["w2"]) \
        * slot_gate.reshape(e, cap)[..., None]
    want = torch.zeros((t, cfg.d_model))
    flat = st.reshape(-1)
    for s in range(e * cap):                 # ascending slot order
        if flat[s] >= 0:
            want[flat[s]] = want[flat[s]] + eo.reshape(e * cap, -1)[s]
    assert torch.equal(y.reshape(t, -1), want)


def test_top_k_takes_the_lower_index_among_ties():
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.2, 0.3, 0.2]])
    vals, idx = TM._top_k(probs, 4)
    assert idx.tolist() == [[1, 2, 4, 3]]
    rv, ri = jax.lax.top_k(jnp.asarray(probs.numpy()), 4)
    assert np.asarray(ri).tolist() == idx.tolist()
    assert np.asarray(rv).tolist() == vals.tolist()


def test_weight_quant_moe_matches_reference_on_its_int8_params():
    ref_cfg, cfg = _cfgs(CASES["dropfree"])
    ref_cfg = ref_cfg.replace(weight_quant=True)
    cfg = cfg.replace(weight_quant=True)
    p = RM.moe_init(jax.random.PRNGKey(0), ref_cfg, jnp.float32)
    assert p["w1"].dtype == jnp.int8
    x = np.random.default_rng(4).standard_normal(
        (2, 8, cfg.d_model)).astype(np.float32)
    y, aux = RM.moe_ffn(p, jnp.asarray(x), ref_cfg)
    tp = params_from_arrays(jax.tree.map(np.asarray, p), "cpu")
    assert tp["w1"].dtype == torch.int8
    ty, taux = TM.moe_ffn(tp, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), atol=Y_ATOL)
    assert float(taux["moe_drop_frac"]) == float(aux["moe_drop_frac"])


def test_port_weight_quant_codes_follow_the_reference_rule():
    """The port's own int8 init: codes = round(w / scale), scale =
    max|w| / 127 per (expert, out column), as the reference quantizes."""
    cfg = get_smoke_config("qwen3-moe-235b-a22b")
    full = TM.moe_init(torch.Generator().manual_seed(5), cfg, torch.float32,
                       device="cpu")
    quant = TM.moe_init(torch.Generator().manual_seed(5),
                        cfg.replace(weight_quant=True), torch.float32,
                        device="cpu")
    for w in ("w1", "w3", "w2"):
        f = jnp.asarray(full[w].numpy())
        scale = jnp.max(jnp.abs(f), axis=1) / 127.0
        codes = jnp.round(f / jnp.maximum(scale[:, None, :], 1e-12)).astype(
            jnp.int8)
        np.testing.assert_array_equal(quant[w].numpy(), np.asarray(codes))
        np.testing.assert_allclose(quant[f"{w}_scale"].numpy(),
                                   np.asarray(scale), rtol=1e-6)
