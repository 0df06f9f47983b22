"""Port connected components against the reference: labels, component
count and iteration count bit for bit, and the labels equal to the
vectorised oracle (scipy, each component labelled by its smallest
vertex) and to the reference's union-find oracle."""
import importlib

import numpy as np
import pytest

from repro.core import graph as JG
from repro.core.ref import ref_graph as JR
from repro_torch import convert
from repro_torch.core import ref as R
from repro_torch.core.graph import TENSOR_FIELDS, Graph
from repro_torch.core.primitives import connected_components

JC = importlib.import_module("repro.core.primitives.cc")


def _pair(jg):
    return jg, convert.graph_from_arrays(
        {f: np.asarray(getattr(jg, f)) for f in TENSOR_FIELDS},
        ell_width=jg.ell_width, csc_ell_width=jg.csc_ell_width,
        device="cpu")


@pytest.mark.parametrize("kind", ["rmat", "grid", "forest"])
def test_cc_matches_reference(kind):
    if kind == "rmat":
        jg = JG.rmat(9, 8, seed=7, weighted=True)
    elif kind == "grid":
        jg = JG.grid2d(20, weighted=True, seed=3)
    else:                   # several paths and isolated vertices
        rng = np.random.default_rng(41)
        perm = rng.permutation(300)
        src, dst = perm[:-1], perm[1:]
        cut = rng.random(299) < 0.1
        jg = JG.from_edge_list(src[~cut], dst[~cut], n=320, undirected=True)
    jg, tg = _pair(jg)
    jr = JC.connected_components(jg)
    tr = connected_components(tg)
    assert np.array_equal(np.asarray(jr.labels), tr.labels.numpy())
    assert int(jr.num_components) == int(tr.num_components)
    assert int(jr.iterations) == tr.iterations
    assert np.array_equal(R.cc_ref(tg), tr.labels.numpy())
    assert np.array_equal(JR.cc_ref(jg), tr.labels.numpy())


def test_cc_on_edgeless_graph():
    g = Graph.from_csr(np.zeros(7, np.int32), np.zeros(0, np.int32),
                       device="cpu")
    r = connected_components(g)
    assert np.array_equal(r.labels.numpy(), np.arange(6))
    assert int(r.num_components) == 6 and r.iterations == 0
