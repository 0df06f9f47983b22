"""The port's optimizer (``repro_torch.train.optimizer``) against the
reference's on the same numpy inputs: int8 block quantization bit for
bit, the three schedules at every step, one AdamW update with fp32 and
with int8 moments, and the twins of ``tests/test_optimizer.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train import one_thread  # noqa: F401 (autouse)
from _hyp import given, settings, st
from repro.train import optimizer as RO
from repro_torch.convert import opt_state_from_arrays, opt_state_to_arrays
from repro_torch.train.optimizer import (QBLOCK, AdamWState, QTensor, adamw,
                                         dequantize_blockwise, global_norm,
                                         make_schedule, moment_specs,
                                         quantizable, quantize_blockwise)

SCHED_RTOL = 1e-6
UPDATE_RTOL = 1e-6
CODE_FLIP_SHARE = 1e-3      # int8 codes off by one, at most this share


def _x(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


@pytest.mark.parametrize("shape", [(8, 512), (3, 2, 256), (1, 1024)])
def test_quantize_blockwise_is_bit_equal_to_reference(shape):
    x = _x(shape, seed=len(shape))
    x[0, ..., :QBLOCK] = 0.0               # an all-zero block: scale 0
    codes, scale = quantize_blockwise(torch.from_numpy(x))
    rc, rs = RO.quantize_blockwise(jnp.asarray(x))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(rc))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(rs))
    back = dequantize_blockwise(codes, scale, shape, torch.float32)
    rback = RO.dequantize_blockwise(rc, rs, shape, jnp.float32)
    np.testing.assert_array_equal(back.numpy(), np.asarray(rback))


def test_quantize_roundtrip_error_bound():
    x = torch.from_numpy(_x((8, 512)))
    codes, scale = quantize_blockwise(x)
    assert codes.shape == x.shape and codes.dtype == torch.int8
    assert scale.shape == (8, 2)
    back = dequantize_blockwise(codes, scale, x.shape, torch.float32)
    err = (back - x).abs().numpy()
    bound = x.abs().numpy().reshape(8, 2, QBLOCK).max(-1) / 127.0
    assert np.all(err.reshape(8, 2, QBLOCK) <= bound[..., None] * 0.5 + 1e-7)


@given(st.integers(1, 4), st.integers(1, 3))
@settings(max_examples=10)
def test_quantize_shapes(rows, blocks):
    codes, scale = quantize_blockwise(torch.ones((rows, blocks * QBLOCK)))
    assert codes.shape == (rows, blocks * QBLOCK)
    assert scale.shape == (rows, blocks)


def test_quantizable_predicate():
    for shape in ((4, 512), (512,), (4, 100), (2, 3, 256)):
        assert quantizable(shape) == RO.quantizable(shape)
    assert quantizable((4, 512)) and not quantizable((512,))


@pytest.mark.parametrize("kind", ["constant", "cosine", "wsd"])
def test_schedules_match_reference_at_every_step(kind):
    total = 300
    for warmup in (1, 20):
        got = make_schedule(kind, 3e-3, total, warmup_steps=warmup)
        want = RO.make_schedule(kind, 3e-3, total, warmup_steps=warmup)
        steps = np.arange(0, total + 5, dtype=np.int32)
        g = np.array([float(got(torch.tensor(s))) for s in steps])
        w = np.asarray(jax.vmap(want)(jnp.asarray(steps)))
        np.testing.assert_allclose(g, w, rtol=SCHED_RTOL, atol=0,
                                   err_msg=f"{kind} warmup {warmup}")
        assert got(torch.tensor(5, dtype=torch.int32)).dtype == torch.float32


def test_schedules_shapes():
    total = 1000
    for kind in ("constant", "cosine", "wsd"):
        s = make_schedule(kind, 1e-3, total, warmup_steps=100)
        assert float(s(0)) < 1e-3 * 0.02
        assert np.isclose(float(s(100)), 1e-3, rtol=1e-2)
    wsd = make_schedule("wsd", 1e-3, total, warmup_steps=100,
                        stable_frac=0.9)
    assert np.isclose(float(wsd(500)), 1e-3)
    assert np.isclose(float(wsd(880)), 1e-3)
    assert float(wsd(total)) < 1.2e-4
    assert float(make_schedule("cosine", 1e-3, total,
                               warmup_steps=100)(total)) < 1.2e-4


# ---- one AdamW update against the reference's --------------------------

def _problem(quant):
    """Params (a 2-D bf16 matrix, a stacked (L, d) fp32 norm scale, a 1-D
    bias, a quantizable fp32 matrix, a stacked (L, r, c) bf16 weight),
    grads, and a mid-run state with
    random moments (quantized by the reference when ``quant``)."""
    shapes = {"w": ((4, 512), jnp.bfloat16), "norm": ((3, 256), jnp.float32),
              "b": ((7,), jnp.float32), "m2": ((2, 768), jnp.float32),
              "stack": ((3, 4, 512), jnp.bfloat16)}
    params = {k: jnp.asarray(_x(s, i), dt)
              for i, (k, (s, dt)) in enumerate(shapes.items())}
    grads = {k: jnp.asarray(_x(s, 10 + i, 0.3), dt)
             for i, (k, (s, dt)) in enumerate(shapes.items())}

    def moment(k, seed, positive):
        a = _x(shapes[k][0], seed, 0.01)
        a = np.abs(a) * 0.01 if positive else a
        a = jnp.asarray(a)
        if quant and RO.quantizable(a.shape):
            return RO.QTensor(*RO.quantize_blockwise(a))
        return a

    state = RO.AdamWState(
        step=jnp.asarray(4, jnp.int32),
        m={k: moment(k, 20 + i, False) for i, k in enumerate(shapes)},
        v={k: moment(k, 30 + i, True) for i, k in enumerate(shapes)})
    return params, grads, state


def _port(tree):
    from repro_torch.convert import params_from_arrays
    return params_from_arrays(jax.tree.map(np.asarray, tree), "cpu")


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_adamw_update_matches_reference(quant):
    params, grads, state = _problem(quant)
    _, rupd = RO.adamw(RO.make_schedule("cosine", 1e-3, 10, warmup_steps=2),
                       quantize_moments=quant)
    want_p, want_s, want_m = jax.jit(rupd)(grads, state, params)
    _, upd = adamw(make_schedule("cosine", 1e-3, 10, warmup_steps=2),
                   quantize_moments=quant)
    tstate = opt_state_from_arrays(jax.tree.map(np.asarray, state), "cpu")
    got_p, got_s, got_m = upd(_port(grads), tstate, _port(params))
    assert int(got_s.step) == 5
    for k, w in want_p.items():
        assert got_p[k].dtype == _port({k: w})[k].dtype
        assert _rel(got_p[k].float().numpy(),
                    np.asarray(w, np.float32)) <= UPDATE_RTOL, k
    for name in ("m", "v"):
        got, want = getattr(got_s, name), getattr(want_s, name)
        for k, w in want.items():
            if isinstance(w, RO.QTensor):
                assert isinstance(got[k], QTensor)
                c, wc = got[k].codes.numpy().astype(int), np.asarray(
                    w.codes).astype(int)
                assert np.abs(c - wc).max() <= 1
                assert np.mean(c != wc) < CODE_FLIP_SHARE
                assert _rel(got[k].scale.numpy(), w.scale) <= UPDATE_RTOL
            else:
                assert _rel(got[k].numpy(), w) <= UPDATE_RTOL, (name, k)
    assert _rel(got_m["lr"].numpy(), want_m["lr"]) <= SCHED_RTOL
    assert _rel(got_m["grad_norm"].numpy(),
                want_m["grad_norm"]) <= UPDATE_RTOL


@pytest.mark.parametrize("piece", [1 << 24, 600], ids=["whole", "rows"])
@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_donated_update_is_bit_equal_and_in_place(monkeypatch, quant, piece):
    """The update writes the given params and state, and gives the same
    bits whole leaves or a few rows at a time."""
    from repro_torch.train import optimizer
    params, grads, state = _problem(quant)
    _, upd = adamw(make_schedule("constant", 1e-3, 10, warmup_steps=2),
                   quantize_moments=quant)
    arrays = jax.tree.map(np.asarray, state)
    monkeypatch.setattr(optimizer, "PIECE", 1 << 30)
    p1, s1, _ = upd(_port(grads), opt_state_from_arrays(arrays, "cpu"),
                    _port(params))
    monkeypatch.setattr(optimizer, "PIECE", piece)
    p0, s0 = _port(params), opt_state_from_arrays(arrays, "cpu")
    p2, s2, _ = upd(_port(grads), s0, p0)
    assert all(a is b for a, b in zip(p2.values(), p0.values()))
    assert s2.step is s0.step and int(s0.step) == 5
    for a, b in zip(jax.tree.leaves(opt_state_to_arrays(s1)),
                    jax.tree.leaves(opt_state_to_arrays(s2))):
        np.testing.assert_array_equal(a, b)
    for k in p1:
        assert torch.equal(p1[k], p2[k])


def test_weight_decay_reaches_stacked_norm_scales():
    """C-ref-14: decay applies wherever p.ndim >= 2 — a stacked (L, d)
    norm scale decays, a 1-D bias does not (zero grads, zero moments)."""
    _, upd = adamw(make_schedule("constant", 0.1, 10, warmup_steps=1),
                   weight_decay=0.5)
    init, _ = adamw(make_schedule("constant", 0.1, 10))
    params = {"norm": torch.ones((3, 4)), "bias": torch.ones((4,))}
    grads = {k: torch.zeros_like(v) for k, v in params.items()}
    new, _, _ = upd(grads, init(params), params)
    assert torch.allclose(new["norm"], torch.full((3, 4), 0.95))
    assert torch.equal(new["bias"], torch.ones((4,)))


def test_train_step_without_donation_leaves_its_inputs():
    """make_train_step(donate=False) clones params and state and runs the
    same in-place update: the given trees stay as they were, and the
    result has the bits of the donated step."""
    from types import SimpleNamespace

    from repro_torch.pytree import leaves
    from repro_torch.train.trainstep import make_train_step
    model = SimpleNamespace(loss=lambda p, b: (
        (b["x"] @ p["w"] + p["b"] - 1.0).square().mean(), {}))
    g = torch.Generator().manual_seed(0)
    params = {"w": torch.randn((4, 512), generator=g),
              "b": torch.randn((512,), generator=g)}
    batch = {"x": torch.randn((3, 4), generator=g)}
    init, upd = adamw(make_schedule("constant", 0.1, 10),
                      quantize_moments=True)
    state = init(params)
    before = [t.clone() for t in leaves((params, state))]
    p1, s1, _ = make_train_step(model, upd, donate=False)(params, state,
                                                          batch)
    assert all(torch.equal(a, b) for a, b in zip(
        before, leaves((params, state))))
    assert int(s1.step) == 1 and not torch.equal(p1["w"], params["w"])
    p2, s2, _ = make_train_step(model, upd)(params, state, batch)
    assert p2 is params and s2 is state
    assert all(torch.equal(a, b) for a, b in zip(leaves((p1, s1)),
                                                 leaves((p2, s2))))


def test_adamw_converges_quadratic():
    for q in (False, True):
        init, upd = adamw(make_schedule("constant", 0.05, 100,
                                        warmup_steps=1),
                          quantize_moments=q, weight_decay=0.0)
        params = {"w": torch.full((2, 512), 3.0)}
        state = init(params)
        for _ in range(80):
            g = {"w": 2.0 * (params["w"] - 1.0)}
            params, state, _ = upd(g, state, params)
        assert float((params["w"] - 1.0).abs().max()) < 0.1, q


def test_quantized_state_structure():
    init, _ = adamw(make_schedule("constant", 0.1, 10),
                    quantize_moments=True)
    state = init({"big": torch.zeros((4, 512)), "small": torch.zeros((7,))})
    assert isinstance(state.m["big"], QTensor)
    assert not isinstance(state.m["small"], QTensor)
    assert state.step.dtype == torch.int32 and state.step.shape == ()


def test_grad_clipping():
    init, upd = adamw(make_schedule("constant", 0.1, 10), clip_norm=1.0)
    params = {"w": torch.zeros((3,))}
    _, _, m = upd({"w": torch.full((3,), 100.0)}, init(params), params)
    assert float(m["grad_norm"]) > 1.0            # reported pre-clip


def test_global_norm():
    t = {"a": torch.tensor([3.0]), "b": torch.tensor([4.0])}
    assert np.isclose(float(global_norm(t)), 5.0)


def test_moment_specs_structure():
    pspecs = {"big": ("data", "model"), "small": (None,)}
    sds = {"big": torch.empty((4, 512), device="meta"),
           "small": torch.empty((7,), device="meta")}
    ms = moment_specs(pspecs, sds, quantize_moments=True)
    assert isinstance(ms["big"], QTensor)
    assert ms["big"].codes == ("data", "model")
    assert ms["small"] == (None,)
    assert moment_specs(pspecs) is pspecs
    with pytest.raises(ValueError):
        moment_specs(pspecs, quantize_moments=True)


def test_opt_state_carrier_round_trips():
    _, _, state = _problem(True)
    arrays = jax.tree.map(np.asarray, state)
    back = opt_state_to_arrays(opt_state_from_arrays(arrays, "cpu"))
    assert isinstance(back, AdamWState)
    for a, b in zip(jax.tree.leaves(arrays), jax.tree.leaves(back)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_int8_second_moment_rounding_to_zero_matches_reference():
    """C-ref-15: v is quantized linearly in its block, so a small entry's
    v rounds to code 0 while its m keeps a code; an update that then sees
    a zero gradient there moves it by m / eps (here ~2e6 × lr), where
    fp32 moments move it by < lr. Both packages do the same."""
    g1 = np.zeros((1, 256), np.float32)
    g1[0, 0], g1[0, 1] = 1.0, 0.05
    grads = [g1, np.zeros_like(g1)]
    moved = {}
    for quant in (False, True):
        init, upd = adamw(make_schedule("constant", 1e-3, 10,
                                        warmup_steps=1),
                          weight_decay=0.0, clip_norm=None,
                          quantize_moments=quant)
        rinit, rupd = RO.adamw(RO.make_schedule("constant", 1e-3, 10,
                                                warmup_steps=1),
                               weight_decay=0.0, clip_norm=None,
                               quantize_moments=quant)
        p, s = {"w": torch.zeros((1, 256))}, None
        rp, rs = {"w": jnp.zeros((1, 256))}, None
        s, rs = init(p), rinit(rp)
        for g in grads:
            p, s, _ = upd({"w": torch.from_numpy(g)}, s, p)
            rp, rs, _ = rupd({"w": jnp.asarray(g)}, rs, rp)
        np.testing.assert_allclose(p["w"].numpy(), np.asarray(rp["w"]),
                                   rtol=1e-6)
        moved[quant] = abs(float(p["w"][0, 1]))
    assert moved[False] < 2e-3 and moved[True] > 1e3
