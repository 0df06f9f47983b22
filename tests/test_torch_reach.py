"""Port k-hop reach against the reference: reached sets and counts bit
for bit with the reference's xla path (ragged and duplicate source
lanes), and equal to the BFS-depth oracle of both packages."""
import importlib

import numpy as np
import pytest
import torch

from repro.core import graph as JG
from repro.core.ref import ref_graph as JR
from repro_torch import convert
from repro_torch.core import ref as R
from repro_torch.core.graph import TENSOR_FIELDS, Graph
from repro_torch.core.primitives import reach, reach_batch

JReach = importlib.import_module("repro.core.primitives.reach")


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


@pytest.mark.parametrize("k", [0, 1, 3, 6])
def test_reach_batch_matches_reference(pair, k):
    jg, tg = pair
    srcs = [3, 99, 250, 3]                  # ragged + duplicate lanes
    jr = JReach.reach_batch(jg, srcs, k, backend="xla")
    tr = reach_batch(tg, srcs, k)
    assert tr.reached.dtype == torch.bool and tr.counts.dtype == torch.int32
    assert np.array_equal(np.asarray(jr.reached), tr.reached.numpy())
    assert np.array_equal(np.asarray(jr.counts), tr.counts.numpy())
    assert tr.hops == int(jr.hops) == k and tr.converged
    for i, s in enumerate(srcs):
        assert np.array_equal(tr.reached[i].numpy(), R.reach_ref(tg, s, k))
        assert np.array_equal(R.reach_ref(tg, s, k), JR.reach_ref(jg, s, k))


def test_single_source_reach_is_lane_zero(pair):
    jg, tg = pair
    jr = JReach.reach(jg, 7, 2, backend="xla")
    tr = reach(tg, 7, 2)
    assert np.array_equal(np.asarray(jr.reached), tr.reached.numpy())
    assert int(jr.counts) == int(tr.counts)
    assert torch.equal(tr.reached, reach_batch(tg, [7], 2).reached[0])


def test_reach_needs_csc_and_handles_edgeless_graphs():
    g = Graph.from_csr(np.array([0, 1, 2, 2]), np.array([1, 2]),
                       build_csc=False, device="cpu")
    with pytest.raises(ValueError, match="CSC"):
        reach_batch(g, [0], 2)
    empty = Graph.from_csr(np.zeros(5, np.int32), np.zeros(0, np.int32),
                           device="cpu")
    r = reach_batch(empty, [1, 3], 4)
    assert r.counts.tolist() == [1, 1]
    assert r.reached.nonzero().tolist() == [[0, 1], [1, 3]]
