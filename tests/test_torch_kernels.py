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


# ---- the reference's other kernel-API names and its oracle names -----------

def _graph_pair():
    from repro.core import graph as JG
    from repro_torch import convert
    from repro_torch.core.graph import TENSOR_FIELDS
    jg = JG.rmat(6, 4, seed=1, weighted=True)
    tg = convert.graph_from_arrays(
        {f: np.asarray(getattr(jg, f)) for f in TENSOR_FIELDS},
        ell_width=jg.ell_width, csc_ell_width=jg.csc_ell_width,
        device="cpu")
    return jg, tg


def _lanes(tg, b, cap, seed):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, tg.num_vertices, (b, cap)).astype(np.int32)
    deg = np.diff(tg.row_offsets.numpy())
    sizes = np.where(rng.random((b, cap)) < 0.8, deg[base], 0).astype(
        np.int32)
    return base, sizes


def test_advance_fused_names_match_reference_kernels():
    """advance_fused(_batch) and advance_filter_fused(_batch) against the
    reference's Pallas kernels (interpret mode), every output equal."""
    jg, tg = _graph_pair()
    base, sizes = _lanes(tg, 2, 12, seed=40)
    visited = (np.random.default_rng(41).random((2, tg.num_vertices))
               < 0.3).astype(np.int32)
    jargs = (jg.row_offsets, jg.col_indices)
    targs = (tg.row_offsets, tg.col_indices)
    for cap in (64, 512):
        want = JK.advance_fused_batch(*jargs, jnp.asarray(base),
                                      jnp.asarray(sizes), cap)
        got = K.advance_fused_batch(*targs, torch.from_numpy(base),
                                    torch.from_numpy(sizes), cap)
        for a, b in zip(want, got):
            assert np.array_equal(_np(a), _np(b))
        want = JK.advance_fused(*jargs, jnp.asarray(base[1]),
                                jnp.asarray(sizes[1]), cap)
        got = K.advance_fused(*targs, torch.from_numpy(base[1]),
                              torch.from_numpy(sizes[1]), cap)
        for a, b in zip(want, got):
            assert np.array_equal(_np(a), _np(b))
        want = JK.advance_filter_fused_batch(
            *jargs, jnp.asarray(base), jnp.asarray(sizes),
            jnp.asarray(visited), cap, 20)
        got = K.advance_filter_fused_batch(
            *targs, torch.from_numpy(base), torch.from_numpy(sizes),
            torch.from_numpy(visited), cap, 20)
        for a, b in zip(want, got):
            assert np.array_equal(_np(a), _np(b))
        want = JK.advance_filter_fused(
            *jargs, jnp.asarray(base[0]), jnp.asarray(sizes[0]),
            jnp.asarray(visited[0]), cap, 20)
        got = K.advance_filter_fused(
            *targs, torch.from_numpy(base[0]), torch.from_numpy(sizes[0]),
            torch.from_numpy(visited[0]), cap, 20)
        for a, b in zip(want, got):
            assert np.array_equal(_np(a), _np(b))


@pytest.mark.parametrize("cap", [1, 37, 300])
def test_filter_compact_names_match_reference(cap):
    rng = np.random.default_rng(cap)
    ids = rng.integers(0, 1000, cap).astype(np.int32)
    keep = rng.random(cap) < 0.4
    want = JK.filter_compact(jnp.asarray(ids), jnp.asarray(keep))
    got = K.filter_compact(torch.from_numpy(ids), torch.from_numpy(keep))
    oracle = P.filter_compact_ref(torch.from_numpy(ids),
                                  torch.from_numpy(keep.astype(np.int32)))
    jo = JR.filter_compact_ref(jnp.asarray(ids), jnp.asarray(keep))
    for w, g, o, j in zip(want, got, oracle, jo):
        assert np.array_equal(_np(w), _np(g))
        assert np.array_equal(_np(j), _np(o))
    assert got[1].dtype == torch.int32


@pytest.mark.parametrize("sr", ["plus_times", "min_plus", "or_and",
                                "max_min"])
def test_semiring_names_match_reference_kernels(sr):
    """semiring_spmv / semiring_spmm against the reference's (its ELL
    kernel in interpret mode) on integer-valued x (0 / 1 under or_and,
    its domain): equal; the masks are int32, as the reference takes
    them."""
    from repro.linalg import semiring as JS
    from repro_torch.linalg import semiring as TS
    jg, tg = _graph_pair()
    n = tg.num_vertices
    rng = np.random.default_rng(42)
    x = rng.integers(0, 2 if sr == "or_and" else 4, (n, 5)).astype(
        np.float32)
    mask = (rng.random(n) < 0.6).astype(np.int32)
    for m in (None, mask):
        jm = None if m is None else jnp.asarray(m)
        tm = None if m is None else torch.from_numpy(m)
        want = JK.semiring_spmm(jg.row_offsets, jg.col_indices,
                                jg.edge_values, jnp.asarray(x), JS.get(sr),
                                jg.ell_width, jm, jg.row_seg)
        got = K.semiring_spmm(tg.row_offsets, tg.col_indices,
                              tg.edge_values, torch.from_numpy(x),
                              TS.get(sr), tg.ell_width, tm, tg.row_seg)
        assert np.array_equal(np.asarray(want), got.numpy())
        want = JK.semiring_spmv(jg.row_offsets, jg.col_indices, None,
                                jnp.asarray(x[:, 0]), JS.get(sr),
                                jg.ell_width, jm, jg.row_seg)
        got = K.semiring_spmv(tg.row_offsets, tg.col_indices, None,
                              torch.from_numpy(x[:, 0]), TS.get(sr),
                              tg.ell_width, tm, tg.row_seg, tg.over_pos,
                              tg.over_row)
        assert np.array_equal(np.asarray(want), got.numpy())


def test_oracle_is_the_plain_module():
    assert K.oracle is P


# each reference name → the registry-named wrapper it is one call of
_TWINS = {"advance_fused": "advance", "advance_fused_batch": "advance_batch",
          "advance_filter_fused": "advance_filter",
          "advance_filter_fused_batch": "advance_filter_batch",
          "filter_compact": "compact", "semiring_spmv": "spmv",
          "semiring_spmm": "spmm"}


@pytest.mark.parametrize("name", sorted(_TWINS))
def test_reference_names_call_their_registry_wrapper(name, monkeypatch):
    """Each of the reference's kernel-API names makes exactly one call of
    its registry-named wrapper (the one that launches the kernel on CUDA
    tensors) and returns what that call returns."""
    from repro_torch.linalg import semiring as TS
    _, tg = _graph_pair()
    n = tg.num_vertices
    base, sizes = (torch.from_numpy(a) for a in _lanes(tg, 2, 12, seed=43))
    rng = np.random.default_rng(44)
    visited = torch.from_numpy((rng.random((2, n)) < 0.3).astype(np.int32))
    x = torch.from_numpy(rng.integers(0, 4, (n, 3)).astype(np.float32))
    mask = torch.from_numpy((rng.random(n) < 0.6).astype(np.int32))
    ro, ci = tg.row_offsets, tg.col_indices
    sr = TS.get("plus_times")
    args = {
        "advance_fused": (ro, ci, base[0], sizes[0], 64),
        "advance_fused_batch": (ro, ci, base, sizes, 64),
        "advance_filter_fused": (ro, ci, base[0], sizes[0], visited[0], 64,
                                 20),
        "advance_filter_fused_batch": (ro, ci, base, sizes, visited, 64, 20),
        "filter_compact": (torch.arange(n, dtype=torch.int32), mask),
        "semiring_spmv": (ro, ci, tg.edge_values, x[:, 0], sr, tg.ell_width,
                          mask, tg.row_seg, tg.over_pos, tg.over_row),
        "semiring_spmm": (ro, ci, tg.edge_values, x, sr, tg.ell_width, mask,
                          tg.row_seg),
    }[name]
    twin = getattr(K, _TWINS[name])
    calls = []

    def record(*a, **kw):
        calls.append(twin(*a, **kw))
        return calls[-1]

    monkeypatch.setattr(K, _TWINS[name], record)
    got = getattr(K, name)(*args)
    assert len(calls) == 1
    if name == "filter_compact":     # row 0 of the (1, cap) compaction
        assert torch.equal(got[0], calls[0][0][0])
        assert torch.equal(got[1], calls[0][1][0])
    else:
        assert got is calls[0]


def test_lb_expand_ref_matches_reference():
    sizes = np.array([0, 3, 0, 2, 5, 0, 1], np.int32)
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    for cap in (0, 6, 11, 20):
        want = JR.lb_expand_ref(jnp.asarray(offsets), cap)
        got = P.lb_expand_ref(torch.from_numpy(offsets), cap)
        for a, b in zip(want, got):
            assert np.array_equal(_np(a), _np(b)) and b.dtype == torch.int32


@pytest.mark.parametrize("sr", ["plus_times", "min_plus", "or_and",
                                "max_min", "plus_and"])
def test_ell_oracles_match_reference(sr):
    """spmv_ell_ref and semiring_ell_ref on integer-valued operands (the
    sums exact in any order), -1 padding and a mask."""
    from repro.linalg import semiring as JS
    from repro_torch.linalg import semiring as TS
    rng = np.random.default_rng(43)
    nbrs = rng.integers(-1, 30, (25, 6)).astype(np.int32)
    vals = rng.integers(0, 5, (25, 6)).astype(np.float32)
    x = rng.integers(0, 7, (30, 3)).astype(np.float32)
    mask = (rng.random(25) < 0.7).astype(np.int32)
    want = JR.semiring_ell_ref(jnp.asarray(nbrs), jnp.asarray(vals),
                               jnp.asarray(x), jnp.asarray(mask),
                               JS.get(sr))
    got = P.semiring_ell_ref(torch.from_numpy(nbrs), torch.from_numpy(vals),
                             torch.from_numpy(x), torch.from_numpy(mask),
                             TS.get(sr))
    assert np.array_equal(np.asarray(want), got.numpy())
    want = JR.spmv_ell_ref(jnp.asarray(nbrs), jnp.asarray(vals),
                           jnp.asarray(x[:, 0]))
    got = P.spmv_ell_ref(torch.from_numpy(nbrs), torch.from_numpy(vals),
                         torch.from_numpy(x[:, 0]))
    assert np.array_equal(np.asarray(want), got.numpy())


def test_segment_search_ref_matches_reference():
    rng = np.random.default_rng(44)
    hay = np.sort(rng.integers(0, 50, 60)).astype(np.int32)
    lo = rng.integers(0, 60, 40).astype(np.int32)
    hi = np.minimum(lo + rng.integers(0, 12, 40), 60).astype(np.int32)
    needles = rng.integers(0, 50, 40).astype(np.int32)
    args = [jnp.asarray(a) for a in (hay, lo, hi, needles)]
    targs = [torch.from_numpy(a) for a in (hay, lo, hi, needles)]
    want = np.asarray(JR.segment_search_ref(*args))
    got = P.segment_search_ref(*targs)
    assert got.dtype == torch.int32 and np.array_equal(want, got.numpy())


@pytest.mark.parametrize("scale", [None, 0.3])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_and_gather_oracles_match_reference(scale, causal):
    rng = np.random.default_rng(45)
    q, k, v = (rng.standard_normal((n, 16)).astype(np.float32)
               for n in (9, 12, 12))
    want = np.asarray(JR.flash_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        scale=scale))
    got = P.flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=causal,
                                scale=scale).numpy()
    np.testing.assert_allclose(got, want, rtol=3e-5, atol=3e-5)
    x = rng.standard_normal((7, 5)).astype(np.float32)
    slots = np.array([3, -1, 0, 6, 6, -1, 2], np.int32)
    assert np.array_equal(
        np.asarray(JR.moe_gather_ref(jnp.asarray(x), jnp.asarray(slots))),
        P.moe_gather_ref(torch.from_numpy(x), torch.from_numpy(slots)).numpy())
