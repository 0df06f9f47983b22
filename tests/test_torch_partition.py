"""The port's partitions (``core/partition.py``) and the registry's
placement dimension against the reference. The partitions are host
numpy and must equal the reference's field by field — padding, rebased
offsets, ``edge_pos``, ``chunk_emax``, ``balance()`` — whatever the
source graph's storage plan; the shard views hold one tensor per part,
each the reference's row of its stacked array."""
import numpy as np
import pytest
import torch

from repro.core import backend as JB
from repro.core import graph as JG
from repro.core.partition import partition_1d as j_partition_1d
from repro.core.partition import partition_2d as j_partition_2d
from repro_torch.core import backend as TB
from repro_torch.core import graph as TG
from repro_torch.core.partition import (Mesh, partition_1d, partition_2d,
                                        check_mesh_axes, check_mesh_axis)


def _padded(G, **kw):
    """rmat(7, 8, seed=3) re-built at n = 263: a padded tail part and
    isolated vertices [128, 263) (the reference's sharded fixture)."""
    base = G.rmat(7, 8, seed=3, weighted=True, **kw)
    se, de = G.edge_list(base)
    vals = np.asarray(base.edge_values.cpu() if hasattr(
        base.edge_values, "cpu") else base.edge_values)
    return G.from_edge_list(se, de, n=base.num_vertices * 2 + 7,
                            values=vals, **kw)


FIXTURES = {
    "padded": _padded,
    "directed": lambda G, **kw: G.rmat(8, 8, seed=3, undirected=False,
                                       weighted=True, **kw),
    "int16": lambda G, **kw: G.rmat(7, 8, seed=5, weighted=True,
                                    index_dtype="int16", **kw),
    "delta": lambda G, **kw: G.rmat(7, 8, seed=5, weighted=True,
                                    encoding="delta", **kw),
}


def _build(kind):
    return FIXTURES[kind](JG), FIXTURES[kind](TG, device="cpu")


FIELDS_1D = ("row_offsets", "col_indices", "edge_values", "vertex_base",
             "csc_row_offsets", "csc_col_indices", "csc_edge_values")
FIELDS_2D = ("row_offsets", "col_indices", "edge_values", "edge_pos",
             "chunk_offsets", "row_base", "col_base", "block_edges",
             "block_ell_width", "mirrors", "csc_row_offsets",
             "csc_col_indices", "csc_edge_values", "csc_edge_pos",
             "csc_chunk_offsets")


def _same(a, b, fields):
    for f in fields:
        want, got = getattr(a, f), getattr(b, f)
        if want is None:
            assert got is None, f
            continue
        want = np.asarray(want)
        assert got.dtype == want.dtype and np.array_equal(got, want), f


@pytest.mark.parametrize("p", [2, 4, 8])
@pytest.mark.parametrize("kind", sorted(FIXTURES))
def test_partition_1d_equals_reference(kind, p):
    jg, tg = _build(kind)
    a, b = j_partition_1d(jg, p), partition_1d(tg, p)
    _same(a, b, FIELDS_1D)
    assert (b.n, b.m, b.num_parts, b.verts_per_part) == (
        a.n, a.m, a.num_parts, a.verts_per_part)
    assert b.verts_per_part == -(-tg.num_vertices // p)
    assert b.balance() == a.balance()
    assert np.array_equal(b.owner_of(np.arange(b.n)),
                          a.owner_of(np.arange(a.n)))


@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (4, 1)])
@pytest.mark.parametrize("kind", sorted(FIXTURES))
def test_partition_2d_equals_reference(kind, shape):
    jg, tg = _build(kind)
    a, b = j_partition_2d(jg, *shape), partition_2d(tg, *shape)
    _same(a, b, FIELDS_2D)
    assert (b.vpr, b.vpc, b.chunk_emax, b.csc_chunk_emax) == (
        a.vpr, a.vpc, a.chunk_emax, a.csc_chunk_emax)
    assert b.balance() == a.balance()
    v = np.arange(b.n)
    assert all(np.array_equal(x, y)
               for x, y in zip(b.owner_of(v), a.owner_of(v)))


def test_shard_views_stack_to_the_reference_arrays():
    """Each part's tensor is the reference's row of the stacked array;
    views are cached per (mesh, axis); shards always hold dense int32 /
    float32 whatever the source plan."""
    jg, tg = _build("delta")
    pg = partition_1d(tg, 4)
    mesh = Mesh.on("cpu", (4,), ("graph",))
    sg = pg.shard(mesh)
    assert pg.shard(Mesh.on("cpu", (4,), ("graph",))) is sg
    ref = j_partition_1d(jg, 4)
    for f, parts in (("row_offsets", sg.row_offsets),
                     ("col_indices", sg.col_indices),
                     ("edge_values", sg.edge_values),
                     ("csc_row_offsets", sg.csc_offsets),
                     ("csc_col_indices", sg.csc_indices)):
        assert np.array_equal(torch.stack(parts).numpy(),
                              np.asarray(getattr(ref, f))), f
    assert sg.col_indices[0].dtype == torch.int32
    assert sg.plan.index_dtype == "int32" and sg.plan.encoding == "dense"
    assert sg.source_plan == tg.plan and tg.plan.encoding == "delta"
    assert torch.equal(sg.degrees, tg.degrees)
    p2 = partition_2d(tg, 2, 2)
    s2 = p2.shard(Mesh.on("cpu", (2, 2), ("row", "col")))
    r2 = j_partition_2d(jg, 2, 2)
    assert np.array_equal(torch.stack(s2.col_indices).numpy().reshape(
        np.asarray(r2.col_indices).shape), np.asarray(r2.col_indices))
    assert torch.equal(s2.degrees, tg.degrees)
    # a row chunk's offsets are one tensor per device beside its blocks
    assert s2.chunk_offsets[0] is s2.chunk_offsets[1]


def test_mesh_checks_match_reference():
    mesh = Mesh.on("cpu", (4,), ("graph",))
    check_mesh_axis(mesh, "graph", 4)
    with pytest.raises(ValueError, match="must match"):
        check_mesh_axis(mesh, "graph", 2)
    m2 = Mesh.on("cpu", (2, 2), ("row", "col"))
    check_mesh_axes(m2, ("row", "col"), (2, 2))
    with pytest.raises(ValueError, match="2-D partition"):
        check_mesh_axes(m2, ("row", "col"), (1, 4))
    with pytest.raises(ValueError, match="needs 4 devices"):
        Mesh(("cpu",), (2, 2), ("row", "col"))
    spread = Mesh.over(["cpu"], (3,), ("graph",))
    assert spread.devices == (torch.device("cpu"),) * 3
    assert spread.distinct() == (torch.device("cpu"),)


# ---------------------------------------------------------------------------
# the registry's placement dimension (the reference's registry tests,
# minus the environment-variable step: the port reads none)
# ---------------------------------------------------------------------------


def test_placement_resolution_precedence():
    assert TB.resolve_placement() == TB.SINGLE
    with TB.use_placement(TB.SHARDED):
        assert TB.resolve_placement() == TB.SHARDED
        with TB.use_placement(TB.SINGLE):
            assert TB.resolve_placement() == TB.SINGLE   # innermost
            assert TB.resolve_placement(TB.TWOD) == TB.TWOD  # call > ctx
    with pytest.raises(ValueError, match="unknown placement"):
        TB.resolve_placement("mesh")
    assert TB.PLACEMENTS == JB.PLACEMENTS


def test_placement_context_carries_mesh():
    assert TB.placement_mesh() is None
    sentinel = object()
    with TB.use_placement(TB.SHARDED, mesh=sentinel, axis="g"):
        assert TB.placement_mesh() == (sentinel, "g")
        with TB.use_placement(TB.SINGLE):
            assert TB.placement_mesh() == (sentinel, "g")
    assert TB.placement_mesh() is None


@pytest.mark.parametrize("placement,ops", [
    ("sharded", ("advance", "spmv", "spmm", "mxm")),
    ("2d", ("advance", "advance_filter", "spmv", "spmm", "mxm"))])
def test_placement_providers_registered_as_reference(placement, ops):
    for op in ops:
        assert TB.registered(op, TB.TORCH, placement), op
        assert JB.registered(op, JB.XLA, placement), op
        # the cuda backend runs the torch provider of the same placement
        # (the reference's pallas -> xla route under a placement)
        assert TB.dispatch(op, TB.CUDA, placement) is \
            TB.dispatch(op, TB.TORCH, placement)
        assert not TB.registered(op, TB.CUDA, placement)
    for op in ("spmv", "spmm", "mxm"):
        assert TB.registered(op, TB.TORCH) and TB.registered(op, TB.CUDA)


@pytest.mark.parametrize("placement", ["sharded", "2d"])
def test_placement_dispatch_never_falls_back_to_single(placement):
    with pytest.raises(KeyError):
        JB.dispatch("compact", JB.XLA, placement)
    for bk in (TB.TORCH, TB.CUDA):
        with pytest.raises(TB.ProviderMissError, match="never falls back"
                           ) as info:
            TB.dispatch("compact", bk, placement)
        assert info.value.placement == placement
        assert f"placement={placement!r}" in str(info.value)


def test_advance_filter_hole_is_declared_under_sharded():
    TB.registered("advance", TB.TORCH, TB.SHARDED)       # loads providers
    JB.registered("advance", JB.XLA, JB.SHARDED)
    assert TB.declared_fallback("advance_filter", TB.SHARDED) == \
        JB.declared_fallback("advance_filter", JB.SHARDED)
    with pytest.raises(TB.ProviderMissError):
        TB.dispatch("advance_filter", TB.TORCH, TB.SHARDED)


@pytest.mark.parametrize("placement,name", [("sharded", "ShardedGraph"),
                                            ("2d", "Sharded2DGraph")])
def test_plain_graph_under_a_placement_is_an_error(placement, name):
    g = TG.demo_graph(device="cpu")
    with pytest.raises(ValueError, match=name):
        TB.resolve_graph_placement(g, placement)
    with TB.use_placement(placement):
        with pytest.raises(ValueError, match=name):
            TB.resolve_graph_placement(g)


def test_partitioned_operand_implies_its_placement():
    tg = FIXTURES["padded"](TG, device="cpu")
    sg = partition_1d(tg, 2).shard(Mesh.on("cpu", (2,), ("graph",)))
    s2 = partition_2d(tg, 2, 2).shard(Mesh.on("cpu", (2, 2),
                                              ("row", "col")))
    for g, want, axis in ((sg, TB.SHARDED, "graph"),
                          (s2, TB.TWOD, ("row", "col"))):
        pl, ctx = TB.resolve_graph_placement(g)
        assert pl == want
        with ctx:
            assert TB.placement_mesh() == (g.mesh, axis)
        with pytest.raises(ValueError, match="per-part slices"):
            TB.resolve_graph_placement(g, TB.SINGLE)


def test_storage_arg_under_a_placement_is_the_parts_store():
    """A delta source shards into dense parts, so the placement's store
    reaches the provider as it is (no decode step)."""
    tg = FIXTURES["delta"](TG, device="cpu")
    sg = partition_1d(tg, 2).shard(Mesh.on("cpu", (2,), ("graph",)))
    assert TB.storage_arg("spmv", TB.TORCH, TB.SHARDED, graph=sg,
                          side="csc") is sg.csc_indices
    assert TB.declared_encodings("spmv", TB.CUDA, TB.SHARDED) == \
        ("dense",)
