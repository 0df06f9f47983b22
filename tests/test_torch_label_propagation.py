"""Port label propagation against the reference: labels and iteration
counts bit for bit with the reference's xla path (the votes are integer
counts, exact in any order), the vectorised oracle equal to the
reference's loop oracle, and the first-maximum rule of torch.argmax
that the ⟨max count, min label⟩ merge relies on."""
import importlib

import numpy as np
import pytest
import torch

from repro.core import graph as JG
from repro.core.ref import ref_graph as JR
from repro_torch import convert
from repro_torch.core import ref as R
from repro_torch.core.graph import TENSOR_FIELDS, Graph
from repro_torch.core.primitives import label_propagation

JLP = importlib.import_module("repro.core.primitives.label_propagation")


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


@pytest.mark.parametrize("max_iter", [1, 5, 30])
def test_label_propagation_matches_reference(pair, max_iter):
    jg, tg = pair
    jr = JLP.label_propagation(jg, max_iter=max_iter, backend="xla")
    tr = label_propagation(tg, max_iter=max_iter)
    assert tr.labels.dtype == torch.int32
    assert np.array_equal(np.asarray(jr.labels), tr.labels.numpy())
    assert tr.iterations == int(jr.iterations)
    labels, iters = R.label_propagation_ref(tg, max_iter=max_iter)
    assert np.array_equal(labels, tr.labels.numpy())
    assert iters == tr.iterations


def test_label_propagation_with_given_labels_and_blocks(pair):
    """A small label domain swept in blocks that do not divide it."""
    jg, tg = pair
    labels0 = (np.arange(tg.num_vertices) * 7 % 11).astype(np.int32)
    jr = JLP.label_propagation(jg, labels0=labels0, num_labels=11,
                               block=3, backend="xla")
    tr = label_propagation(tg, labels0=labels0, num_labels=11, block=3)
    assert np.array_equal(np.asarray(jr.labels), tr.labels.numpy())
    assert tr.iterations == int(jr.iterations)
    labels, iters = R.label_propagation_ref(tg, labels=labels0)
    assert np.array_equal(labels, tr.labels.numpy())
    assert iters == tr.iterations


@pytest.mark.parametrize("max_iter", [3, 30])
def test_vectorised_oracle_equals_reference_oracle(pair, max_iter):
    jg, tg = pair
    labels, _ = R.label_propagation_ref(tg, max_iter=max_iter)
    assert np.array_equal(labels,
                          JR.label_propagation_ref(jg, max_iter=max_iter))


def test_isolated_vertices_keep_their_labels():
    g = Graph.from_csr(np.array([0, 1, 2, 2, 2]), np.array([1, 0]),
                       device="cpu")
    for max_iter, want in ((3, [1, 0, 2, 3]), (30, [0, 1, 2, 3])):
        r = label_propagation(g, max_iter=max_iter)  # 0 and 1 swap
        assert r.labels.tolist() == want and r.iterations == max_iter
        labels, iters = R.label_propagation_ref(g, max_iter=max_iter)
        assert labels.tolist() == want and iters == max_iter


def test_argmax_returns_the_first_maximum():
    votes = torch.tensor([[0.0, 2.0, 2.0, 1.0], [3.0, 3.0, 3.0, 3.0],
                          [0.0, 0.0, 0.0, 0.0], [1.0, 0.0, 5.0, 5.0]])
    assert torch.argmax(votes, dim=1).tolist() == [1, 0, 0, 2]
    wide = torch.zeros((4, 32))
    wide[:, [5, 9, 30]] = 2.0
    assert torch.argmax(wide, dim=1).tolist() == [5] * 4
