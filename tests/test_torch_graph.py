"""Port graph builders against the reference: every Graph field equal on
the reference's two fixtures, the carry-across of a reference graph,
and structural validation."""
import numpy as np
import pytest
import torch

from repro.core import graph as JG
from repro_torch import convert
from repro_torch.core import graph as TG

FIXTURES = {
    "rmat": (lambda: JG.rmat(9, 8, seed=7, weighted=True),
             lambda: TG.rmat(9, 8, seed=7, weighted=True, device="cpu")),
    "grid": (lambda: JG.grid2d(20, weighted=True, seed=3),
             lambda: TG.grid2d(20, weighted=True, seed=3, device="cpu")),
}


def _fields(jg):
    return {f: np.asarray(getattr(jg, f)) for f in TG.TENSOR_FIELDS}


def _assert_graph_equal(fields, ell, csc_ell, tg):
    for name in TG.TENSOR_FIELDS:
        want, got = fields[name], getattr(tg, name)
        if want is None or want.shape == ():
            assert got is None, name
            continue
        got = got.cpu().numpy()
        assert got.shape == want.shape, name
        assert np.array_equal(got, want), name
    assert tg.ell_width == ell
    assert tg.csc_ell_width == csc_ell


@pytest.mark.parametrize("kind", sorted(FIXTURES))
def test_builder_fields_equal_reference(kind):
    jg = FIXTURES[kind][0]()
    tg = FIXTURES[kind][1]()
    _assert_graph_equal(_fields(jg), jg.ell_width, jg.csc_ell_width, tg)
    assert tg.num_vertices == jg.num_vertices
    assert tg.num_edges == jg.num_edges
    assert tg.device.type == "cpu"
    # the reference's default plan sizes the ids: both fixtures are int16
    assert tg.plan.index_dtype == jg.plan.index_dtype == "int16"
    assert tg.col_indices.dtype == torch.int16


@pytest.mark.parametrize("kind", sorted(FIXTURES))
def test_graph_from_arrays_round_trip(kind):
    jg = FIXTURES[kind][0]()
    fields = _fields(jg)
    tg = convert.graph_from_arrays(fields, ell_width=jg.ell_width,
                                   csc_ell_width=jg.csc_ell_width,
                                   device="cpu")
    _assert_graph_equal(fields, jg.ell_width, jg.csc_ell_width, tg)
    # the carried-across graph equals the port's own build
    assert all(torch.equal(getattr(tg, f), getattr(FIXTURES[kind][1](), f))
               for f in TG.TENSOR_FIELDS)


def test_graph_from_arrays_rejects_unknown_and_missing():
    with pytest.raises(ValueError, match="unknown"):
        convert.graph_from_arrays({"row_offsets": np.zeros(1),
                                   "col_indices": np.zeros(0),
                                   "bogus": np.zeros(1)},
                                  ell_width=1, csc_ell_width=None,
                                  device="cpu")
    with pytest.raises(ValueError, match="col_indices"):
        convert.graph_from_arrays({"row_offsets": np.zeros(1)},
                                  ell_width=1, csc_ell_width=None,
                                  device="cpu")


def test_from_edge_list_directed_matches_reference():
    rng = np.random.default_rng(11)
    src = rng.integers(0, 50, 300)
    dst = rng.integers(0, 50, 300)
    vals = rng.random(300).astype(np.float32)
    jg = JG.from_edge_list(src, dst, n=50, values=vals)
    tg = TG.from_edge_list(src, dst, n=50, values=vals, device="cpu")
    _assert_graph_equal(_fields(jg), jg.ell_width, jg.csc_ell_width, tg)


def test_from_csr_sorts_rows_like_reference():
    ro = np.array([0, 3, 3, 5])
    ci = np.array([2, 0, 1, 1, 0])
    vals = np.array([1, 2, 3, 4, 5], np.float32)
    jg = JG.Graph.from_csr(ro, ci, vals)
    tg = TG.Graph.from_csr(ro, ci, vals, device="cpu")
    _assert_graph_equal(_fields(jg), jg.ell_width, jg.csc_ell_width, tg)


@pytest.mark.parametrize("ro, ci, vals, match", [
    ([1, 2], [0], None, r"row_offsets\[0\]"),
    ([0, 2, 1], [0, 1], None, "non-monotone"),
    ([0, 2], [0], None, "edge-count"),
    ([0, 1], [5], None, "out of range"),
    ([0, 1], [0], [np.inf], "non-finite"),
])
def test_validate_csr_names_the_fault(ro, ci, vals, match):
    with pytest.raises(TG.GraphValidationError, match=match):
        TG.validate_csr(ro, ci, vals)
    with pytest.raises(JG.GraphValidationError, match=match):
        JG.validate_csr(ro, ci, vals)


def test_validate_graph_accepts_built_graph():
    tg = FIXTURES["rmat"][1]()
    assert TG.validate_graph(tg) == (tg.num_vertices, tg.num_edges)


GENERATORS = {
    "rgg-small": (lambda M, **kw: M.random_geometric(300, 0.09, seed=4,
                                                     weighted=True, **kw)),
    "rgg-unweighted": (lambda M, **kw: M.random_geometric(
        512, (8.0 / 512) ** 0.5, seed=0, **kw)),
    "rgg-int32-delta": (lambda M, **kw: M.random_geometric(
        1000, 0.05, seed=9, weighted=True, index_dtype="int32",
        encoding="delta", **kw)),
    "rgg-tiny-radius": (lambda M, **kw: M.random_geometric(64, 1e-4,
                                                           seed=2, **kw)),
    "bipartite": (lambda M, **kw: M.bipartite_random(200, 80, 6, seed=3,
                                                     **kw)),
    "bipartite-seed0": (lambda M, **kw: M.bipartite_random(50, 500, 3,
                                                           **kw)),
    "demo": (lambda M, **kw: M.demo_graph(**kw)),
}


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generators_equal_reference(name):
    """random_geometric, bipartite_random and demo_graph draw the
    reference's numbers in its order: every array equal, bit for bit."""
    make = GENERATORS[name]
    jg = make(JG)
    tg = make(TG, device="cpu")
    _assert_graph_equal(_fields(jg), jg.ell_width, jg.csc_ell_width, tg)
    assert tg.plan == jg.plan or (
        tg.plan.index_dtype, tg.plan.encoding, tg.plan.value_dtype) == (
        jg.plan.index_dtype, jg.plan.encoding, jg.plan.value_dtype)
    TG.validate_graph(tg)


def test_demo_graph_is_built_once_per_device():
    assert TG.demo_graph("cpu") is TG.demo_graph(torch.device("cpu"))
    assert TG.demo_graph("cpu").num_edges == 15
