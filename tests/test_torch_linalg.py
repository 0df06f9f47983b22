"""Port SpMV against the reference for all five semirings: bit for bit
with the xla provider (both replay the same fixed-grouping fold), and
within 1e-5 of the Pallas kernel (interpret mode), the tolerance the
reference's own tests give its two providers (tests/test_linalg.py).
SpMM bit for bit with the xla provider for every semiring and any
float input (both fold each row in ascending edge order on the CPU),
and with the Pallas provider on integer-valued inputs, whose sums
float32 holds exactly in any order; on float inputs plus_times within
the same 1e-5 (the Pallas kernel sums a row's ELL lanes as one
reduction and merges the overflow after, another grouping). SpMSpV
bit for bit with the xla provider. The masked SpGEMM (mxm) bit for bit
with the reference's xla provider: its sums add small integers
(counts, or products of integer weights), which float32 holds exactly
in any order."""
import numpy as np
import pytest
import torch

from repro import linalg as JL
from repro.core import graph as JG
from repro.linalg import semiring as JS
from repro_torch import convert
from repro_torch.core import backend as TB
from repro_torch.core import graph as TG
from repro_torch.core.graph import TENSOR_FIELDS
from repro_torch.kernels import ops as K
from repro_torch.linalg import ops as TL
from repro_torch.linalg import semiring as TS

SEMIRINGS = sorted(TS.SEMIRINGS)


def _pair(jg):
    return jg, convert.graph_from_arrays(
        {f: np.asarray(getattr(jg, f)) for f in TENSOR_FIELDS},
        ell_width=jg.ell_width, csc_ell_width=jg.csc_ell_width,
        device="cpu")


@pytest.fixture(scope="module", params=["rmat", "grid"])
def pair(request):
    return _pair(JG.rmat(9, 8, seed=7, weighted=True)
                 if request.param == "rmat"
                 else JG.grid2d(20, weighted=True, seed=3))


@pytest.mark.parametrize("sr", SEMIRINGS)
@pytest.mark.parametrize("masked", ["unmasked", "masked", "complemented"])
def test_spmv_matches_reference_bitwise(pair, sr, masked):
    jg, tg = pair
    n = tg.num_vertices
    rng = np.random.default_rng(3)
    x = rng.random(n).astype(np.float32)
    mask = rng.random(n) < 0.5 if masked != "unmasked" else None
    kw = dict(mask=mask, complement=masked == "complemented")
    # every (transpose, structural) variant unmasked; the masks on the
    # PageRank direction
    variants = ([(False, False), (False, True), (True, False), (True, True)]
                if mask is None else [(True, False)])
    for transpose, structural in variants:
        want = np.asarray(JL.spmv(jg, x, semiring=JS.get(sr), backend="xla",
                                  transpose=transpose,
                                  structural=structural, **kw))
        got = TL.spmv(tg, x, semiring=sr, transpose=transpose,
                      structural=structural, **kw).numpy()
        assert np.array_equal(want, got), (transpose, structural)


def test_spmv_kernel_wrapper_on_cpu_is_the_plain_version(pair):
    _, tg = pair
    x = torch.from_numpy(np.random.default_rng(4).random(
        tg.num_vertices).astype(np.float32))
    before = K.KERNELS["spmv"].launches
    args = (tg.csc_offsets, tg.csc_indices, None, x, TS.plus_times,
            tg.csc_ell_width, None, tg.csc_row_seg, tg.csc_over_pos,
            tg.csc_over_row)
    assert torch.equal(K.spmv(*args), TL._spmv_torch(*args))
    assert K.KERNELS["spmv"].launches == before


@pytest.mark.parametrize("sr", SEMIRINGS)
def test_spmv_matches_pallas_kernel(sr):
    jg, tg = _pair(JG.rmat(6, 4, seed=1, weighted=True))
    x = np.random.default_rng(5).random(tg.num_vertices).astype(np.float32)
    want = np.asarray(JL.spmv(jg, x, semiring=JS.get(sr), backend="pallas",
                              transpose=True))
    got = TL.spmv(tg, x, semiring=sr, transpose=True).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_semiring_table_matches_reference():
    for name, s in TS.SEMIRINGS.items():
        r = JS.get(name)
        assert (s.add, s.mul) == (r.add, r.mul)
        assert np.float32(s.zero) == np.float32(r.zero)
        assert np.float32(s.one) == np.float32(r.one)
        assert TS.get(name) is s
    # the codes the CUDA kernel's template instances are selected by
    order = ("plus_times", "min_plus", "or_and", "max_min", "plus_and")
    assert [TS.SEMIRINGS[k].code for k in order] == [0, 1, 2, 3, 4]
    with pytest.raises(ValueError):
        TS.get("bogus")


# --- masked SpGEMM (mxm) --------------------------------------------------


def _edges(g):
    ro = g.row_offsets.numpy()
    src = np.repeat(np.arange(len(ro) - 1, dtype=np.int32), np.diff(ro))
    return src, g.col_indices.numpy()


def test_mxm_plus_and_structural_matches_reference(pair):
    """C⟨A⟩ = A ⊗ Aᵀ over ⟨plus, and⟩ with the SmallLarge swap: per-edge
    common-neighbour counts, the triangle-counting product."""
    jg, tg = pair
    mask = _edges(tg)
    want = np.asarray(JL.mxm(jg, jg, mask, semiring=JS.plus_and,
                             b_transpose=True, structural=True,
                             backend="xla"))
    got = TL.mxm(tg, tg, mask, semiring="plus_and", b_transpose=True,
                 structural=True)
    assert got.dtype == torch.float32
    assert np.array_equal(want, got.numpy())
    # the kernel provider on CPU tensors is the plain one, no launch
    before = {k: v.launches for k, v in K.KERNELS.items()}
    a, bt, base, probe, cap = TL.mxm_plan(tg, tg, mask, b_transpose=True)
    args = (*a[:2], None, *bt[:2], None, base, probe, TS.plus_and, cap)
    assert torch.equal(TB.dispatch("mxm", "cuda")(*args), got)
    assert {k: v.launches for k, v in K.KERNELS.items()} == before


@pytest.mark.parametrize("sr", SEMIRINGS)
def test_mxm_weighted_through_csc_matches_reference(pair, sr):
    """C⟨M⟩ = A ⊗ A over random vertex pairs, B's columns through the CSC
    mirror (no swap), stored weights on both sides."""
    jg, tg = pair
    rng = np.random.default_rng(31)
    n = tg.num_vertices
    mask = (rng.integers(0, n, 600).astype(np.int32),
            rng.integers(0, n, 600).astype(np.int32))
    want = np.asarray(JL.mxm(jg, jg, mask, semiring=JS.get(sr),
                             backend="xla"))
    got = TL.mxm(tg, tg, mask, semiring=sr)
    assert np.array_equal(want, got.numpy())


def test_mxm_refusals(pair):
    _, tg = pair
    mask = _edges(tg)
    with pytest.raises(ValueError, match="beyond the int32"):
        TL.mxm(tg, tg, mask, b_transpose=True, cap_out=2 ** 31)
    with pytest.raises(TypeError, match="expected a Graph"):
        TL.mxm((tg.row_offsets, tg.col_indices, None), tg, mask)
    no_csc = TG.Graph.from_csr(tg.row_offsets.numpy(),
                               tg.col_indices.numpy(), build_csc=False,
                               device="cpu")
    with pytest.raises(ValueError, match="CSC mirror"):
        TL.mxm(no_csc, no_csc, mask)


# --- SpMM and SpMSpV ------------------------------------------------------


@pytest.mark.parametrize("sr", SEMIRINGS)
@pytest.mark.parametrize("k", [1, 5, 32])
@pytest.mark.parametrize("masked", ["unmasked", "masked", "complemented"])
def test_spmm_matches_reference_bitwise(pair, sr, k, masked):
    jg, tg = pair
    n = tg.num_vertices
    rng = np.random.default_rng(17 + k)
    x = rng.random((n, k)).astype(np.float32)
    mask = rng.random(n) < 0.5 if masked != "unmasked" else None
    kw = dict(mask=mask, complement=masked == "complemented")
    for transpose in (False, True):
        for structural in (False, True):
            want = np.asarray(JL.spmm(jg, x, semiring=JS.get(sr),
                                      backend="xla", transpose=transpose,
                                      structural=structural, **kw))
            got = TL.spmm(tg, x, semiring=sr, transpose=transpose,
                          structural=structural, **kw)
            assert got.shape == (n, k) and got.dtype == torch.float32
            assert np.array_equal(want, got.numpy()), (transpose,
                                                       structural)


@pytest.mark.parametrize("sr", SEMIRINGS)
@pytest.mark.parametrize("k", [1, 5, 32])
def test_spmm_matches_pallas_kernel(sr, k):
    jg, tg = _pair(JG.rmat(6, 4, seed=1, weighted=True))
    n = tg.num_vertices
    rng = np.random.default_rng(23)
    ints = rng.integers(0, 4, (n, k)).astype(np.float32)
    mask = rng.random(n) < 0.6
    for m in (None, mask):
        want = np.asarray(JL.spmm(jg, ints, semiring=JS.get(sr),
                                  backend="pallas", transpose=True,
                                  mask=m))
        got = TL.spmm(tg, ints, semiring=sr, transpose=True, mask=m)
        assert np.array_equal(want, got.numpy())
    if sr == "plus_times":
        x = rng.random((n, k)).astype(np.float32)
        want = np.asarray(JL.spmm(jg, x, backend="pallas", mask=mask))
        got = TL.spmm(tg, x, mask=mask).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_spmm_kernel_wrapper_on_cpu_is_the_plain_version(pair):
    _, tg = pair
    x = torch.from_numpy(np.random.default_rng(4).random(
        (tg.num_vertices, 4)).astype(np.float32))
    mask = torch.arange(tg.num_vertices) % 3 > 0
    before = K.KERNELS["spmm"].launches
    args = (tg.csc_offsets, tg.csc_indices, None, x, TS.or_and,
            tg.csc_ell_width, mask, tg.csc_row_seg)
    assert torch.equal(K.spmm(*args), TL._spmm_torch(*args))
    assert torch.equal(TB.dispatch("spmm", "cuda")(*args),
                       TB.dispatch("spmm", "torch")(*args))
    assert K.KERNELS["spmm"].launches == before
    # the plain version derives the edge→row map when it is not given
    assert torch.equal(TL._spmm_torch(*args[:-1]), TL._spmm_torch(*args))


def test_spmm_refusals(pair):
    _, tg = pair
    with pytest.raises(ValueError, match=r"dense \(n, k\)"):
        TL.spmm(tg, np.ones(tg.num_vertices, np.float32))
    with pytest.raises(ValueError, match="complement=True requires"):
        TL.spmm(tg, np.ones((tg.num_vertices, 2), np.float32),
                complement=True)


def test_spmm_on_edgeless_graph():
    g = TG.Graph.from_csr(np.zeros(6, np.int32), np.zeros(0, np.int32),
                          device="cpu")
    for sr in SEMIRINGS:
        y = TL.spmm(g, np.ones((5, 3), np.float32), semiring=sr)
        assert torch.equal(y, torch.full((5, 3), TS.get(sr).zero))


@pytest.mark.parametrize("sr", SEMIRINGS)
@pytest.mark.parametrize("xvals", [False, True])
def test_spmsv_matches_reference_bitwise(pair, sr, xvals):
    """Dead lanes (-1) and duplicate ids (each expands its row once per
    lane), with and without per-lane values, masked and unmasked."""
    jg, tg = pair
    n = tg.num_vertices
    rng = np.random.default_rng(29)
    ids = rng.integers(0, n, 40).astype(np.int32)
    ids[[3, 17]] = -1
    ids[20] = ids[21]
    xv = rng.random(40).astype(np.float32) if xvals else None
    mask = rng.random(n) < 0.5
    for kw in (dict(), dict(mask=mask), dict(mask=mask, complement=True),
               dict(structural=True)):
        want = np.asarray(JL.spmsv(jg, ids, xv, semiring=JS.get(sr),
                                   backend="xla", **kw))
        got = TL.spmsv(tg, ids, xv, semiring=sr, **kw)
        assert np.array_equal(want, got.numpy()), kw


def test_spmsv_explicit_capacity_truncates_as_reference(pair):
    jg, tg = pair
    ids = np.array([0, 5, 9], np.int32)
    for cap in (1, 7):
        want = np.asarray(JL.spmsv(jg, ids, semiring=JS.get("plus_times"),
                                   backend="xla", cap_out=cap))
        got = TL.spmsv(tg, ids, cap_out=cap)
        assert np.array_equal(want, got.numpy())
