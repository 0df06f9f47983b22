"""Port PageRank against the reference. Tolerance 1e-6 absolute, the
reference driver's own (src/repro/launch/graph_run.py:125-127): the SpMV
sweep and the dangling sum have fixed groupings on both sides and agree
bit for bit, but XLA on the CPU contracts ``damping * (acc + dangling)
+ teleport`` into one fused multiply-add while PyTorch rounds the
product first, which moves ranks by a few 1e-9."""
import numpy as np
import pytest
import torch

from repro.core import graph as JG
from repro.core.primitives import pagerank as jpagerank
from repro.core.primitives.pagerank import _fixed_tree_sum as j_tree_sum
from repro_torch import convert
from repro_torch.core import ref as R
from repro_torch.core.graph import TENSOR_FIELDS
from repro_torch.core.primitives import pagerank
from repro_torch.core.primitives.pagerank import _fixed_tree_sum


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


@pytest.mark.parametrize("kind", sorted(FIXTURES))
def test_pagerank_matches_reference(kind):
    jg, tg = _pair(FIXTURES[kind]())
    jr = jpagerank(jg, backend="xla")
    tr = pagerank(tg)
    assert tr.iterations == int(jr.iterations) == 20
    assert tr.converged and bool(jr.converged)
    np.testing.assert_allclose(tr.rank.numpy(), np.asarray(jr.rank),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(tr.rank.numpy(), R.pagerank_ref(tg),
                               rtol=0, atol=1e-6)


def test_pagerank_tol_stops_early_like_reference():
    jg, tg = _pair(JG.rmat(9, 8, seed=7, weighted=True))
    jr = jpagerank(jg, backend="xla", tol=1e-5, max_iter=100)
    tr = pagerank(tg, tol=1e-5, max_iter=100)
    assert tr.iterations == int(jr.iterations) < 100


def test_fixed_tree_sum_bitwise():
    x = np.random.default_rng(2).random(1000).astype(np.float32)
    assert float(_fixed_tree_sum(torch.from_numpy(x))) == float(
        j_tree_sum(x))


def test_pagerank_matches_pallas_reference():
    jg, tg = _pair(JG.rmat(6, 4, seed=1, weighted=True))
    np.testing.assert_allclose(pagerank(tg).rank.numpy(),
                               np.asarray(jpagerank(jg,
                                                    backend="pallas").rank),
                               rtol=0, atol=1e-5)
