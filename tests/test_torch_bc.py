"""Port betweenness centrality against the reference. Depths, sigma
(integer path counts, exact in float32) and the per-level counts bit
for bit; dependencies within rtol 1e-5 (atol 1e-6 for values near 0):
the dependency sums are float32 sums whose order may differ (a batched
pass reproduces the reference's order on the CPU and is bit-equal on
these fixtures; exact and sampled BC also sum their lanes, in another
order, measured up to 1.7e-7 relative)."""
import importlib

import numpy as np
import pytest

from repro.core import graph as JG
from repro.core.ref import ref_graph as JR
from repro_torch import convert
from repro_torch.core import ref as R
from repro_torch.core.graph import TENSOR_FIELDS
from repro_torch.core.primitives import bc, bc_batch

JB = importlib.import_module("repro.core.primitives.bc")
RTOL, ATOL = 1e-5, 1e-6


def _pair(jg):
    return jg, convert.graph_from_arrays(
        {f: np.asarray(getattr(jg, f)) for f in TENSOR_FIELDS},
        ell_width=jg.ell_width, csc_ell_width=jg.csc_ell_width,
        device="cpu")


# the directed rmat's CSC differs from its CSR, so a CSR / CSC mix-up
# shows there (the other two fixtures are symmetric)
FIXTURES = {"rmat": lambda: JG.rmat(9, 8, seed=7, weighted=True),
            "grid": lambda: JG.grid2d(20, weighted=True, seed=3),
            "directed": lambda: JG.rmat(8, 8, seed=3, undirected=False,
                                        weighted=True)}


@pytest.fixture(scope="module", params=sorted(FIXTURES))
def pair(request):
    return _pair(FIXTURES[request.param]())


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def test_bc_batch_matches_reference(pair):
    jg, tg = pair
    deg = np.diff(tg.row_offsets.numpy())
    # a duplicate lane; 350 lies in each graph (the directed one has 256)
    srcs = [int(np.argmax(deg)), 0, 77, 77, 350 % tg.num_vertices]
    weights = np.array([1.0, 0.5, 2.0, 1.0, 0.0], np.float32)
    jr = JB.bc_batch(jg, srcs, weights)
    tr = bc_batch(tg, srcs, weights)
    for f in ("depth", "sigma", "max_level"):
        assert np.array_equal(np.asarray(getattr(jr, f)),
                              getattr(tr, f).numpy()), f
    _close(tr.bc.numpy(), jr.bc)
    for i, s in enumerate(srcs):
        _close(tr.bc[i].numpy(), R.bc_ref(tg, s) * weights[i])
        _close(R.bc_ref(tg, s), JR.bc_ref(jg, s))


def test_bc_single_source_matches_reference(pair):
    jg, tg = pair
    jr = JB.bc(jg, 5)
    tr = bc(tg, 5)
    assert tr.bc.shape == (tg.num_vertices,)
    assert np.array_equal(np.asarray(jr.depth), tr.depth.numpy())
    assert np.array_equal(np.asarray(jr.sigma), tr.sigma.numpy())
    assert int(jr.max_level) == int(tr.max_level)
    _close(tr.bc.numpy(), jr.bc)


def test_bc_exact_matches_reference(pair):
    jg, tg = pair
    jr = JB.bc(jg)
    tr = bc(tg)
    assert tr.chunks == jr.chunks and int(tr.num_sources) == tg.num_vertices
    _close(tr.bc.numpy(), jr.bc)


@pytest.mark.parametrize("samples", [20, 1000])
def test_bc_sampled_matches_reference(pair, samples):
    jg, tg = pair
    jr = JB.bc(jg, samples=samples, seed=3, chunk=16)
    tr = bc(tg, samples=samples, seed=3, chunk=16)
    assert tr.chunks == jr.chunks
    assert int(tr.num_sources) == int(jr.num_sources)
    _close(tr.bc.numpy(), jr.bc)
