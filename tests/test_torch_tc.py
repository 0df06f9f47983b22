"""Port triangle counting against the reference: per-edge counts,
oriented edges and totals bit for bit with the reference's xla path, and
equal to the port's vectorised oracle and the reference's loop oracle."""
import importlib

import numpy as np
import pytest
import torch

from repro.core import graph as JG
from repro.core.ref import ref_graph as JR
from repro_torch import convert
from repro_torch.core import ref as R
from repro_torch.core.graph import TENSOR_FIELDS, Graph
from repro_torch.core.primitives import triangle_count, triangle_count_full
from repro_torch.linalg import ops as TL

JT = importlib.import_module("repro.core.primitives.tc")
TT = importlib.import_module("repro_torch.core.primitives.tc")


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


def test_triangle_count_matches_reference(pair):
    jg, tg = pair
    jr = JT.triangle_count(jg, backend="xla")
    tr = triangle_count(tg)
    assert tr.per_edge.dtype == torch.int32 and tr.total.dtype == torch.int32
    assert np.array_equal(np.asarray(jr.per_edge), tr.per_edge.numpy())
    assert np.array_equal(jr.edge_src, tr.edge_src)
    assert np.array_equal(jr.edge_dst, tr.edge_dst)
    assert int(jr.total) == int(tr.total) == R.tc_ref(tg) == JR.tc_ref(jg)


def test_triangle_count_full_matches_reference(pair):
    jg, tg = pair
    want = int(JT.triangle_count_full(jg, backend="xla"))
    got = triangle_count_full(tg)
    assert got.dtype == torch.int32
    assert int(got) == want == int(triangle_count(tg).total)


def test_tc_oracle_counts_triangles():
    """K4 has 4 triangles; a 5-cycle none; the oracle's row chunking
    does not change the count."""
    k4 = np.array([(i, j) for i in range(4) for j in range(4) if i < j])
    g = TT.from_edge_list(k4[:, 0], k4[:, 1], n=4, undirected=True,
                          device="cpu")
    assert R.tc_ref(g) == R.tc_ref(g, rows_per_chunk=1) == 4
    assert int(triangle_count(g).total) == 4
    ring = np.arange(5)
    g = TT.from_edge_list(ring, (ring + 1) % 5, n=5, undirected=True,
                          device="cpu")
    assert R.tc_ref(g) == 0 and int(triangle_count(g).total) == 0


def test_mxm_plan_capacity_is_sum_of_min_degrees(pair):
    """TC's expansion is planned once, in mxm_plan: Σ over oriented edges
    of min(deg'(u), deg'(v)), the SmallLarge swap's count."""
    _, tg = pair
    sub, ssrc, sdst = TT._orient(tg)
    cap = TL.mxm_plan(sub, sub, (ssrc, sdst), b_transpose=True)[-1]
    out = np.bincount(ssrc, minlength=tg.num_vertices).astype(np.int64)
    assert cap == int(np.minimum(out[ssrc], out[sdst]).sum()) > 0


def test_triangle_count_on_edgeless_graph():
    g = Graph.from_csr(np.zeros(6, np.int32), np.zeros(0, np.int32),
                       device="cpu")
    r = triangle_count(g)
    assert int(r.total) == 0 and r.per_edge.shape == (0,)
    assert int(triangle_count_full(g)) == 0
    assert R.tc_ref(g) == 0
