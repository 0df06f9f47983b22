"""The port's kernel API (``repro_torch.kernels.ops``: lb_expand,
flash_attention, moe_gather) on CPU tensors, where each wrapper runs its
plain version, against the reference's kernel API (``repro.kernels.ops``,
the Pallas kernels in interpret mode, as tests/test_kernels.py runs
them) and its oracles (``repro.kernels.ref``). Inputs are made with
numpy from a seed and handed to both.

Tolerances: lb_expand and moe_gather are exact (bit-equal on every
slot, the invalid ones too); flash_attention 3e-5 for fp32 inputs and
2e-2 for bf16, the reference's own limits (tests/test_kernels.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hyp import given, settings, st

from repro.kernels import ops as JK
from repro.kernels import ref as JR
from repro_torch.kernels import ops as K
from repro_torch.kernels import ref as P


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _expand_pair(sizes: np.ndarray, cap_out: int):
    got = K.lb_expand(torch.from_numpy(sizes), cap_out)
    offsets = jnp.concatenate([jnp.zeros(1, jnp.int32),
                               jnp.cumsum(jnp.asarray(sizes), dtype=jnp.int32)])
    return got, offsets


# ---- K6 lb_expand ---------------------------------------------------------

@pytest.mark.parametrize("cap_in,cap_out", [(1, 8), (17, 100), (64, 2048),
                                            (500, 513), (0, 5), (40, 7)])
def test_lb_expand_matches_reference_kernel_on_every_slot(cap_in, cap_out):
    rng = np.random.default_rng(cap_in * 1000 + cap_out)
    sizes = rng.integers(0, 9, cap_in).astype(np.int32)
    got, offsets = _expand_pair(sizes, cap_out)
    want = JK.lb_expand(jnp.asarray(sizes), cap_out)
    oracle = JR.lb_expand_ref(offsets, cap_out)
    for name, a, b, c in zip(("in_pos", "rank", "valid"), got[:3],
                             want[:3], oracle):
        assert got.in_pos.dtype == torch.int32 and got.valid.dtype == torch.bool
        assert np.array_equal(_np(a), _np(b)), name
        assert np.array_equal(_np(a).astype(np.int32), _np(c)), name
    assert int(got.total) == int(want.total) == int(sizes.sum())


def test_lb_expand_zero_size_segments_and_short_total():
    sizes = np.array([0, 3, 0, 0, 2, 0, 1, 0], np.int32)
    got, offsets = _expand_pair(sizes, 11)
    ip, rk, vd = JR.lb_expand_ref(offsets, 11)
    assert got.in_pos.tolist() == np.asarray(ip).tolist()
    assert got.rank.tolist() == np.asarray(rk).tolist()
    assert got.valid.tolist() == (np.asarray(vd) > 0).tolist()
    assert got.in_pos[:6].tolist() == [1, 1, 1, 4, 4, 6]
    assert got.rank[:6].tolist() == [0, 1, 2, 0, 1, 0]


@settings(max_examples=60, deadline=None)
@given(st.lists(st.integers(0, 12), min_size=0, max_size=40),
       st.integers(0, 130))
def test_lb_expand_property(sizes_l, cap_out):
    sizes = np.asarray(sizes_l, np.int32).reshape(-1)
    got, offsets = _expand_pair(sizes, cap_out)
    ip, rk, vd = JR.lb_expand_ref(offsets, cap_out)
    assert np.array_equal(got.in_pos.numpy(), np.asarray(ip))
    assert np.array_equal(got.rank.numpy(), np.asarray(rk))
    assert np.array_equal(got.valid.numpy(), np.asarray(vd) > 0)
    v = got.valid.numpy()
    assert v.sum() == min(sum(sizes_l), cap_out)
    for p, r in zip(got.in_pos.numpy()[v], got.rank.numpy()[v]):
        assert 0 <= r < sizes_l[p]


# ---- K8 moe_gather --------------------------------------------------------

@pytest.mark.parametrize("t,d,s", [(10, 8, 30), (128, 64, 128), (50, 16, 7),
                                   (9, 7, 40)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_gather_matches_reference_bitwise(t, d, s, dtype):
    rng = np.random.default_rng(t + d + s)
    x = rng.standard_normal((t, d)).astype(np.float32)
    slot = rng.integers(-1, t, s).astype(np.int32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = K.moe_gather(tx, torch.from_numpy(slot))
    assert got.dtype == tx.dtype and got.shape == (s, d)
    for want in (JK.moe_gather(jx, jnp.asarray(slot)),
                 JR.moe_gather_ref(jx, jnp.asarray(slot))):
        # compare bits: bf16 through its uint16 view
        a = got.view(torch.int16 if dtype == "bfloat16" else torch.int32)
        b = np.asarray(want).view(np.int16 if dtype == "bfloat16"
                                  else np.int32)
        assert np.array_equal(a.numpy(), b)


def test_moe_gather_all_empty_and_clamped_slots():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((6, 5)).astype(np.float32)
    for slot in (np.full(9, -1, np.int32),
                 np.array([0, 5, 6, 40, -1, -7, 2], np.int32)):
        got = K.moe_gather(torch.from_numpy(x), torch.from_numpy(slot))
        want = JK.moe_gather(jnp.asarray(x), jnp.asarray(slot))
        assert np.array_equal(got.numpy(), np.asarray(want))
        assert np.array_equal(got.numpy(),
                              np.asarray(JR.moe_gather_ref(
                                  jnp.asarray(x), jnp.asarray(slot))))
    assert not K.moe_gather(torch.from_numpy(x),
                            torch.full((4,), -1, dtype=torch.int32)).any()


# ---- K7 flash_attention ---------------------------------------------------

@pytest.mark.parametrize("sq,sk,d,causal,dtype", [
    (64, 64, 32, True, "float32"),
    (128, 128, 64, True, "float32"),
    (100, 37, 16, True, "float32"),
    (16, 256, 64, False, "float32"),
    (64, 64, 32, True, "bfloat16"),
    (96, 160, 112, True, "float32"),
    (96, 160, 112, True, "bfloat16"),
])
def test_flash_attention_matches_reference(sq, sk, d, causal, dtype):
    rng = np.random.default_rng(sq + sk + d)
    q, k, v = (rng.standard_normal((n, d)).astype(np.float32)
               for n in (sq, sk, sk))
    jq, jk, jv = (jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype))
                  for a in (q, k, v))
    got = K.flash_attention(tq, tk, tv, causal=causal, bq=32, bk=32)
    assert got.dtype == tq.dtype and got.shape == (sq, d)
    tol = 2e-2 if dtype == "bfloat16" else 3e-5
    for want in (JK.flash_attention(jq, jk, jv, causal=causal, bq=32, bk=32),
                 JR.flash_attention_ref(jq, jk, jv, causal=causal)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), atol=tol,
                                   rtol=tol)


def test_flash_attention_masked_rows_are_exactly_zero():
    """Sq > Sk, causal: query i sees keys j <= i - 63, so rows 0-62 see
    none and are 0 (not NaN), in the port and in the reference kernel."""
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((n, 16)).astype(np.float32)
               for n in (100, 37, 37))
    got = K.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    want = np.asarray(JK.flash_attention(*(jnp.asarray(a)
                                           for a in (q, k, v))))
    assert np.isfinite(got.numpy()).all()
    assert (got[:63] == 0).all() and (want[:63] == 0).all()
    assert (got[63:] != 0).any(dim=1).all()


def test_plain_versions_are_the_wrappers_on_the_cpu():
    rng = np.random.default_rng(9)
    q = torch.from_numpy(rng.standard_normal((20, 8)).astype(np.float32))
    assert torch.equal(K.flash_attention(q, q, q, causal=False),
                       P.flash_attention(q, q, q, causal=False))
    sizes = torch.tensor([3, 0, 2], dtype=torch.int32)
    offsets = torch.tensor([0, 3, 3, 5], dtype=torch.int32)
    assert all(torch.equal(a, b) for a, b in
               zip(K.lb_expand(sizes, 9)[:3], P.lb_expand(offsets, 9)))
    for name in ("lb_expand", "flash_attention", "attention_combine",
                 "moe_gather"):
        assert name in K.KERNELS
    assert len(K.KERNELS) == 10


def test_spmv_heavy_rows_follow_inplace_edits():
    """K4's schedule is keyed on the offsets' version as well as the
    tensor: an in-place edit of the offsets gets a fresh heavy-row list,
    an unchanged tensor its cached one."""
    deg = np.array([40, 3, 0, 25, 2, 40], np.int64)
    offsets = torch.from_numpy(np.concatenate([[0], np.cumsum(deg)])
                               .astype(np.int32))
    heavy, nvery = K.spmv_heavy_rows(offsets, 8)
    assert heavy.tolist() == [0, 5, 3] and nvery == 0
    assert K.spmv_heavy_rows(offsets, 8)[0] is heavy
    offsets[1] = 0                  # row 0 empties into row 1
    fresh, _ = K.spmv_heavy_rows(offsets, 8)
    assert fresh is not heavy
    assert fresh.tolist() == [1, 5, 3]


def test_kernel_column_operands_by_plan():
    """K1's and K3's column operand for each store (the reference's
    ``_split_store``): a dense array at its index dtype, an escape-free
    delta stream as (deltas, anchors), an escaped one as its decoded
    int32 view, decoded once into the given cache."""
    from repro_torch.core import graph as TG
    cpu = torch.device("cpu")
    for kw, kind, variant in (({}, 1, "int16"),
                              ({"index_dtype": "int32"}, 0, "int32"),
                              ({"index_dtype": "int64"}, 2, "int64"),
                              ({"encoding": "delta"}, 3, "delta")):
        g = TG.grid2d(12, device="cpu", **kw)
        c = K._kernel_cols(g.row_offsets, g.col_store, g.cache, cpu)
        assert (c.kind, c.variant, c.m) == (kind, variant, g.num_edges)
        assert c.encoding == ("delta" if variant == "delta" else "dense")
        assert (c.anchor is None) == (variant != "delta")
    n = 70_000
    g = TG.from_edge_list([0, 0, 1], [1, n - 1, 2], n=n, encoding="delta",
                          device="cpu")
    c = K._kernel_cols(g.row_offsets, g.col_store, g.cache, cpu)
    assert (c.kind, c.variant) == (0, "dense_fallback")
    assert c.cols.dtype == torch.int32
    assert torch.equal(c.cols, g.cols())
    assert K._kernel_cols(g.row_offsets, g.col_store, g.cache,
                          cpu).cols is c.cols
    with pytest.raises(ValueError, match="int16, int32 or int64"):
        K._kernel_cols(g.row_offsets, g.cols().float(), None, cpu)
