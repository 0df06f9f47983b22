"""Port storage plans against the reference (``repro.core.storage``), on
the CPU: each check gives both packages the same numpy input.

  * the plan ladder and its override errors, message for message;
  * the builders under every plan (int16, int32, int64, delta, bf16
    values), field for field, and the carry-across of a reference graph
    (``convert.graph_from_arrays``) with its plan and encoded parts;
  * the delta round trip, the escape side list and the sorted-rows rule;
  * int64 parity, with the reference run in a subprocess that turns on
    ``jax_enable_x64`` (ROADMAP C-ref-1);
  * bfs / sssp / pagerank bit-equal across the port's plans and equal to
    the reference's same-plan graph: bfs and sssp bit for bit; PageRank
    within the 1e-6 of tests/test_torch_pagerank.py, whose cause is XLA's
    fused multiply-add (C-ref-3) — its SpMV sweep is bit-equal, in fp32
    and in bf16;
  * bf16: the semiring rules, and bf16 PageRank within the reference's
    own bound (1e-2 against fp32, tests/test_storage.py);
  * resident_bytes equal to the reference's dict.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import backend as JB
from repro.core import graph as JG
from repro.core import storage as JS
from repro.core.primitives import bfs as jbfs
from repro.core.primitives import pagerank as jpagerank
from repro.core.primitives import sssp as jsssp
from repro.linalg import ops as JL
from repro.linalg import semiring as JSR
from repro_torch import convert
from repro_torch.core import backend as B
from repro_torch.core import graph as TG
from repro_torch.core import storage as TS
from repro_torch.core.primitives import bfs, pagerank, sssp
from repro_torch.linalg import ops as TL
from repro_torch.linalg import semiring as TSR

ROOT = Path(__file__).resolve().parents[1]
PLANS = {"int16": {}, "int32": {"index_dtype": "int32"},
         "delta": {"encoding": "delta"}, "bf16": {"value_dtype": "bf16"}}
# the two fixtures and the directed rmat, whose CSC differs from its CSR
FIXTURES = {
    "rmat": (lambda m, **kw: m.rmat(9, 8, seed=7, weighted=True, **kw)),
    "grid": (lambda m, **kw: m.grid2d(20, weighted=True, seed=3, **kw)),
    "directed": (lambda m, **kw: m.rmat(8, 8, seed=3, undirected=False,
                                        weighted=True, **kw)),
}


def _build(kind, plan):
    jg = FIXTURES[kind](JG, **PLANS[plan])
    tg = FIXTURES[kind](TG, device="cpu", **PLANS[plan])
    return jg, tg


def _np(t):
    """A port tensor as numpy (bfloat16 as its bits)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    if t.dtype == torch.uint16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _ref_np(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def carry(jg):
    """The reference graph as the port's (``convert.graph_from_arrays``)."""
    enc = {side: (None if getattr(jg, side) is None else
                  {k: np.asarray(v) for k, v in
                   getattr(jg, side)._asdict().items()})
           for side in ("col_enc", "csc_enc")}
    return convert.graph_from_arrays(
        {f: (None if getattr(jg, f) is None else np.asarray(getattr(jg, f)))
         for f in TG.TENSOR_FIELDS},
        ell_width=jg.ell_width, csc_ell_width=jg.csc_ell_width,
        plan=jg.plan.__dict__, device="cpu", **enc)


def _assert_same_graph(jg, tg):
    assert tg.plan == TS.StoragePlan(**jg.plan.__dict__)
    for f in TG.TENSOR_FIELDS:
        want, got = getattr(jg, f), getattr(tg, f)
        if want is None:
            assert got is None, f
            continue
        want = _ref_np(want)
        assert _np(got).dtype == want.dtype, f
        assert np.array_equal(_np(got), want), f
    for side in ("col_enc", "csc_enc"):
        want, got = getattr(jg, side), getattr(tg, side)
        assert (want is None) == (got is None), side
        if want is not None:
            for k in want._fields:
                w, t = _ref_np(getattr(want, k)), _np(getattr(got, k))
                assert t.dtype == w.dtype and np.array_equal(t, w), (side, k)
    assert (tg.ell_width, tg.csc_ell_width) == (jg.ell_width,
                                                jg.csc_ell_width)
    assert tg.num_edges == jg.num_edges


# ---------------------------------------------------------------------------
# the plan ladder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [0, 100, 2**15, 2**15 + 1, 2**31, 2**31 + 1])
def test_plan_ladder_matches_reference(n):
    assert TS.plan_for(n).__dict__ == JS.plan_for(n).__dict__


@pytest.mark.parametrize("n,kw", [
    (100, {"index_dtype": "int64"}), (10**6, {"index_dtype": "int16"}),
    (100, {"index_dtype": "int8"}), (100, {"encoding": "rle"}),
    (100, {"value_dtype": "fp16"}), (70_000, {"encoding": "delta"})])
def test_plan_overrides_and_errors_match_reference(n, kw):
    try:
        want = JS.plan_for(n, **kw).__dict__
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            TS.plan_for(n, **kw)
        assert str(got.value) == str(exc)
    else:
        assert TS.plan_for(n, **kw).__dict__ == want


def test_validate_csr_overflow_message_matches_reference():
    # n = 40,001 vertices: ids past int16
    ro, ci = np.concatenate([[0], np.full(40_001, 2)]), [1, 40_000]
    with pytest.raises(TG.GraphValidationError) as got:
        TG.validate_csr(ro, ci, plan=TS.StoragePlan("int16"))
    with pytest.raises(JG.GraphValidationError) as want:
        JG.validate_csr(ro, ci, plan=JS.StoragePlan("int16"))
    assert str(got.value) == str(want.value)
    assert "index dtype overflow" in str(got.value)
    # the builder refuses the plan itself first, as the reference's does
    for mod, kw in ((TG, {"device": "cpu"}), (JG, {})):
        with pytest.raises(ValueError, match="cannot hold"):
            mod.Graph.from_csr(ro, ci, index_dtype="int16", validate=True,
                               **kw)


# ---------------------------------------------------------------------------
# the builders and the carry-across
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("plan", sorted(PLANS))
@pytest.mark.parametrize("kind", sorted(FIXTURES))
def test_builders_match_reference_under_every_plan(kind, plan):
    jg, tg = _build(kind, plan)
    _assert_same_graph(jg, tg)


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_graph_from_arrays_carries_the_plan(plan):
    jg, tg = _build("rmat", plan)
    cg = carry(jg)
    _assert_same_graph(jg, cg)
    # without an explicit plan it is read off the arrays
    fields = {f: (None if getattr(jg, f) is None
                  else np.asarray(getattr(jg, f))) for f in TG.TENSOR_FIELDS}
    if plan != "delta":
        assert convert.graph_from_arrays(
            fields, ell_width=jg.ell_width, csc_ell_width=jg.csc_ell_width,
            device="cpu").plan == tg.plan


# ---------------------------------------------------------------------------
# delta encoding
# ---------------------------------------------------------------------------


def test_delta_roundtrip_matches_reference():
    jg, tg = _build("directed", "delta")
    g32 = TG.rmat(8, 8, seed=3, undirected=False, weighted=True,
                  index_dtype="int32", device="cpu")
    st = tg.col_store
    assert isinstance(st, TS.EncodedCols) and st.delta.dtype == torch.uint16
    assert torch.equal(TS.decode_cols(st), g32.col_indices)
    assert torch.equal(tg.csc_cols(), g32.csc_indices)
    assert np.array_equal(TS.decode_cols(st).numpy(),
                          np.asarray(JS.decode_cols(jg.col_store)))
    eid = np.random.default_rng(0).integers(0, tg.num_edges, 64)
    row = tg.row_seg.numpy()[eid]
    want = np.asarray(JS.gather_cols(jg.col_store, jnp.asarray(eid)))
    for src in (None, torch.from_numpy(row)):
        got = TS.gather_cols(st, torch.from_numpy(eid), src)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want)
    # 2-D positions keep their shape
    got = TS.gather_cols(st, torch.from_numpy(eid.reshape(8, 8)))
    assert np.array_equal(got.numpy().ravel(), want)


def test_delta_escape_side_list_matches_reference():
    """One row spanning > 0xFFFE ids: the sentinel slot reads the side
    list, the traversal still reaches the far vertex."""
    n = 70_000
    src = np.array([0, 0, 0, 1], np.int64)
    dst = np.array([1, 2, n - 1, 2], np.int64)
    jg = JG.from_edge_list(src, dst, n=n, encoding="delta")
    tg = TG.from_edge_list(src, dst, n=n, encoding="delta", device="cpu")
    _assert_same_graph(jg, tg)
    st = tg.col_store
    assert st.num_escapes == jg.col_store.num_escapes >= 1
    dense = TG.from_edge_list(src, dst, n=n, device="cpu").col_indices
    assert torch.equal(TS.decode_cols(st), dense)
    eid = torch.arange(tg.num_edges)
    assert torch.equal(TS.gather_cols(st, eid), dense)
    labels = bfs(tg, 0).labels.numpy()
    assert labels[n - 1] == 1
    assert np.array_equal(labels, np.asarray(jbfs(jg, 0,
                                                  backend="xla").labels))


def test_delta_requires_sorted_rows():
    ro = np.array([0, 2], np.int64)
    cols = np.array([5, 1], np.int64)
    with pytest.raises(ValueError, match="sorted") as got:
        TS.encode_delta(ro, cols, np.zeros(2, np.int64))
    with pytest.raises(ValueError) as want:
        JS.encode_delta(ro, cols, np.zeros(2, np.int64))
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="sort_neighbors"):
        TG.from_edge_list([0], [1], n=2, encoding="delta",
                          sort_neighbors=False, device="cpu")


@pytest.mark.parametrize("enc", ["dense", "delta"])
def test_gather_cols_edgeless_store(enc):
    e = np.zeros(0, np.int64)
    g = TG.from_edge_list(e, e, n=4, encoding=enc, device="cpu")
    assert g.num_edges == 0
    out = TS.gather_cols(g.col_store, torch.zeros(3, dtype=torch.int32))
    assert out.shape == (3,) and out.dtype == torch.int32
    assert not out.any()


# ---------------------------------------------------------------------------
# the registry's encoding dimension
# ---------------------------------------------------------------------------


def test_registry_declares_and_coerces_encodings():
    _, tg = _build("rmat", "delta")
    assert B.declared_encodings("advance", "torch") == ("dense", "delta")
    assert B.declared_encodings("advance_filter_batch", "cuda") == (
        "dense", "delta")
    assert B.declared_encodings("spmv", "cuda") == ("dense", "delta")
    assert B.declared_encodings("segment_search", "torch") == ("dense",)
    assert B.declared_encodings("mxm", "cuda") == ("dense",)
    assert B.storage_arg("advance", "torch", graph=tg) is tg.col_store
    dense = B.storage_arg("segment_search", "torch", graph=tg)
    assert dense.dtype == torch.int32
    assert torch.equal(dense, tg.cols())
    # decoded once per graph, kept in its cache
    assert B.storage_arg("segment_search", "torch", graph=tg) is dense
    # a dense store at any index dtype passes through unchanged
    _, t16 = _build("rmat", "int16")
    assert B.coerce_store("mxm", "torch", store=t16.col_store) is (
        t16.col_indices)
    assert t16.col_indices.dtype == torch.int16
    with pytest.raises(ValueError, match="unknown storage encoding"):
        B.register("advance", "torch", encodings=("rle",))


# ---------------------------------------------------------------------------
# int64 (the reference needs jax_enable_x64: run it in a subprocess)
# ---------------------------------------------------------------------------

_X64_SCRIPT = textwrap.dedent("""
    import sys
    import jax
    jax.config.update("jax_enable_x64", True)
    import numpy as np
    from repro.core import graph as G
    from repro.core.primitives import bfs, pagerank, sssp
    g = G.rmat(9, 8, seed=7, weighted=True, index_dtype="int64")
    src = int(np.argmax(np.diff(np.asarray(g.row_offsets))))
    np.savez(sys.argv[1], col=np.asarray(g.col_indices),
             csc=np.asarray(g.csc_indices), src=src,
             labels=np.asarray(bfs(g, src, backend="xla").labels),
             preds=np.asarray(bfs(g, src, backend="xla").preds),
             dist=np.asarray(sssp(g, src, backend="xla").dist),
             rank=np.asarray(pagerank(g, max_iter=10, backend="xla").rank))
""")


def test_int64_parity_with_reference_under_x64(tmp_path):
    out = tmp_path / "x64.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _X64_SCRIPT, str(out)],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    want = np.load(out)
    tg = TG.rmat(9, 8, seed=7, weighted=True, index_dtype="int64",
                 device="cpu")
    assert tg.plan.index_dtype == "int64"
    assert tg.col_indices.dtype == torch.int64 == tg.csc_indices.dtype
    assert want["col"].dtype == np.int64
    assert np.array_equal(tg.col_indices.numpy(), want["col"])
    assert np.array_equal(tg.csc_indices.numpy(), want["csc"])
    src = int(want["src"])
    r = bfs(tg, src)
    assert r.labels.dtype == torch.int32
    assert np.array_equal(r.labels.numpy(), want["labels"])
    assert np.array_equal(r.preds.numpy(), want["preds"])
    assert np.array_equal(sssp(tg, src).dist.numpy(), want["dist"])
    np.testing.assert_allclose(pagerank(tg, max_iter=10).rank.numpy(),
                               want["rank"], rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# end-to-end parity across plans and against the reference
# ---------------------------------------------------------------------------


def _runs(g, src, bk):
    return {"bfs": lambda: (bfs(g, src, backend=bk).labels,
                            bfs(g, src, backend=bk).preds),
            "sssp": lambda: (sssp(g, src, backend=bk).dist,),
            "pagerank": lambda: (pagerank(g, max_iter=10,
                                          backend=bk).rank,)}


@pytest.mark.parametrize("plan", ["int16", "delta", "bf16"])
@pytest.mark.parametrize("kind", sorted(FIXTURES))
def test_traversal_parity_across_storage(kind, plan):
    """The port's bfs / sssp / pagerank on every plan equal its int32
    graph's bit for bit, and the reference's same-plan graph: bfs and
    sssp bit for bit, pagerank within C-ref-3's 1e-6."""
    jg, tg = _build(kind, plan)
    _, t32 = _build(kind, "int32")
    src = int(np.argmax(np.diff(t32.row_offsets.numpy())))
    for name, run in _runs(tg, src, "torch").items():
        got = run()
        want = _runs(t32, src, "torch")[name]()
        assert all(torch.equal(a, b) for a, b in zip(got, want)), name
    jr = jbfs(jg, src, backend="xla")
    assert np.array_equal(bfs(tg, src).labels.numpy(), np.asarray(jr.labels))
    assert np.array_equal(bfs(tg, src).preds.numpy(), np.asarray(jr.preds))
    assert np.array_equal(sssp(tg, src).dist.numpy(),
                          np.asarray(jsssp(jg, src, backend="xla").dist))
    np.testing.assert_allclose(
        pagerank(tg, max_iter=10).rank.numpy(),
        np.asarray(jpagerank(jg, max_iter=10, backend="xla").rank),
        rtol=0, atol=1e-6)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("plan", sorted(PLANS))
def test_spmv_spmm_bitwise_with_reference_under_every_plan(plan, precision):
    """The sweep PageRank runs (and its weighted and k-column forms) is
    bit-equal to the reference's xla provider, bf16 rounding included."""
    jg, tg = _build("directed", plan)
    x = np.random.default_rng(1).random(tg.num_vertices).astype(np.float32)
    xk = np.stack([x, 2 * x, x * x], axis=1)
    for transpose in (False, True):
        for structural in (False, True):
            kw = dict(transpose=transpose, structural=structural,
                      precision=precision)
            assert np.array_equal(
                TL.spmv(tg, torch.from_numpy(x), **kw).numpy(),
                np.asarray(JL.spmv(jg, x, backend="xla", **kw)))
            assert np.array_equal(
                TL.spmm(tg, torch.from_numpy(xk), **kw).numpy(),
                np.asarray(JL.spmm(jg, xk, backend="xla", **kw)))


# ---------------------------------------------------------------------------
# bf16
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", sorted(FIXTURES))
def test_bf16_pagerank_against_reference(kind):
    """bf16 PageRank within the reference's own bound of fp32 (1e-2), on
    both packages, and within 1e-6 of the reference's bf16 ranks (C-ref-3's
    fused multiply-add; ROADMAP C-ref-9 records the difference)."""
    jg, tg = _build(kind, "delta")
    full = pagerank(tg, max_iter=10).rank
    half = pagerank(tg, max_iter=10, precision="bf16").rank
    assert half.dtype == torch.float32
    assert float((full - half).abs().max()) < 1e-2
    assert not torch.equal(full, half)            # the rounding shows
    jhalf = np.asarray(jpagerank(jg, max_iter=10, backend="xla",
                                 precision="bf16").rank)
    assert float(np.abs(np.asarray(jpagerank(
        jg, max_iter=10, backend="xla").rank) - jhalf).max()) < 1e-2
    np.testing.assert_allclose(half.numpy(), jhalf, rtol=0, atol=1e-6)


def test_bf16_only_for_plus_accumulation():
    sr = TSR.with_precision(TSR.plus_times, "bf16")
    assert sr.precision == "bf16" and sr.code == 5
    assert TSR.with_precision("plus_and", "bf16").code == 6
    assert TSR.with_precision(sr, "fp32").precision == "fp32"
    assert TSR.with_precision(sr, "fp32").code == 0
    for name in ("min_plus", "or_and", "max_min"):
        with pytest.raises(ValueError, match="plus") as got:
            TSR.with_precision(name, "bf16")
        with pytest.raises(ValueError) as want:
            JSR.with_precision(name, "bf16")
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError):
        TSR.with_precision(TSR.plus_times, "fp8")


@pytest.mark.parametrize("name", ["plus_times", "plus_and"])
def test_bf16_mul_and_round_match_reference(name):
    rng = np.random.default_rng(3)
    a = (rng.standard_normal(4096) * 7).astype(np.float32)
    b = (rng.standard_normal(4096) * 7).astype(np.float32)
    a[:4] = [1.0 + 2.0**-12, 3.0, -0.0, 65504.5]
    ts = TSR.with_precision(name, "bf16")
    js = JSR.with_precision(name, "bf16")
    got = ts.mul_op(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), np.asarray(js.mul_op(a, b)))
    assert np.array_equal(ts.round_prod(torch.from_numpy(a)).numpy(),
                          np.asarray(js.round_prod(jnp.asarray(a))))
    assert float(ts.round_prod(torch.tensor(1.0 + 2.0**-12))) == 1.0
    assert float(TSR.plus_times.round_prod(torch.tensor(1.0 + 2.0**-12))) \
        == 1.0 + 2.0**-12


def test_bf16_values_sssp_matches_reference():
    jg, tg = _build("rmat", "bf16")
    assert tg.edge_values.dtype == torch.bfloat16
    src = 5
    got = sssp(tg, src, delta=40.0).dist
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), np.asarray(
        jsssp(jg, src, delta=40.0, backend="xla").dist))


# ---------------------------------------------------------------------------
# resident bytes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("plan", sorted(PLANS))
@pytest.mark.parametrize("kind", sorted(FIXTURES))
def test_resident_bytes_matches_reference(kind, plan):
    jg, tg = _build(kind, plan)
    assert TS.resident_bytes(tg) == JS.resident_bytes(jg)
    assert TS.resident_bytes(carry(jg)) == JS.resident_bytes(jg)


def test_resident_bytes_accounting():
    rb = {p: TS.resident_bytes(_build("rmat", p)[1]) for p in PLANS}
    _, t32 = _build("rmat", "int32")
    m, n = t32.num_edges, t32.num_vertices
    assert rb["int16"]["arrays"]["col_storage"] == 2 * m
    assert rb["int32"]["arrays"]["col_storage"] == 4 * m
    assert rb["delta"]["arrays"]["col_storage"] == 2 * m + 4 * n
    assert rb["bf16"]["arrays"]["edge_values"] == 2 * m
    assert rb["delta"]["column_bytes"] < rb["int32"]["column_bytes"]
    assert rb["int16"]["total_bytes"] == sum(rb["int16"]["arrays"].values())
    assert JB.declared_encodings("advance", "xla") == ("dense", "delta")
