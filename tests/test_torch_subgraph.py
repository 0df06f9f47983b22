"""Port subgraph matching against the reference: embeddings (content and
order), count and truncation bit for bit on the reference's own test
graphs and queries, and the copied brute-force oracle equal to the
reference's."""
import importlib

import numpy as np
import pytest
import torch

from repro.core import graph as JG
from repro_torch import convert
from repro_torch.core import graph as TG
from repro_torch.core import ref as R
from repro_torch.core.graph import TENSOR_FIELDS
from repro_torch.core.primitives import subgraph_match, subgraph_match_ref
from repro_torch.kernels import ops as K

JS = importlib.import_module("repro.core.primitives.subgraph")

TRIANGLE = (3, [(0, 1), (0, 2), (1, 2)])
PATH3 = (3, [(0, 1), (1, 2)])
STAR3 = (4, [(0, 1), (0, 2), (0, 3)])
SQUARE = (4, [(0, 1), (1, 2), (2, 3), (0, 3)])
QUERIES = {"triangle": TRIANGLE, "path3": PATH3, "star3": STAR3,
           "square": SQUARE}


def _pair(jg):
    return jg, convert.graph_from_arrays(
        {f: np.asarray(getattr(jg, f)) for f in TENSOR_FIELDS},
        ell_width=jg.ell_width, csc_ell_width=jg.csc_ell_width,
        device="cpu")


@pytest.fixture(scope="module")
def pair():
    return _pair(JG.rmat(7, 4, seed=11))


@pytest.mark.parametrize("query", sorted(QUERIES))
@pytest.mark.parametrize("cap", [500_000, 1000, 7])
def test_match_equals_reference(pair, query, cap):
    jg, tg = pair
    n_q, q_edges = QUERIES[query]
    jr = JS.subgraph_match(jg, n_q, q_edges, cap=cap)
    tr = subgraph_match(tg, n_q, q_edges, cap=cap)
    assert tr.embeddings.dtype == torch.int32
    assert np.array_equal(np.asarray(jr.embeddings), tr.embeddings.numpy())
    assert tr.count == int(jr.count)
    assert tr.truncated == bool(jr.truncated)


@pytest.mark.parametrize("query", sorted(QUERIES))
def test_brute_force_oracle_equals_reference(pair, query):
    jg, tg = pair
    n_q, q_edges = QUERIES[query]
    want = JS.subgraph_match_ref(jg, n_q, q_edges)
    assert subgraph_match_ref(tg, n_q, q_edges) == want
    r = subgraph_match(tg, n_q, q_edges, cap=500_000)
    assert not r.truncated and r.count == want


def test_triangle_query_equals_tc_times_automorphisms():
    jg, tg = _pair(JG.rmat(7, 4, seed=3))
    r = subgraph_match(tg, *TRIANGLE, cap=200_000)
    assert r.count == 6 * R.tc_ref(tg)
    jr = JS.subgraph_match(jg, *TRIANGLE, cap=200_000)
    assert np.array_equal(np.asarray(jr.embeddings), r.embeddings.numpy())


def test_labels_filter():
    g = TG.from_edge_list([0, 1, 2, 3], [1, 2, 3, 4], n=5, undirected=True,
                          device="cpu")
    r = subgraph_match(g, 3, [(0, 1), (1, 2)], cap=64,
                       labels=torch.tensor([0, 1, 0, 1, 0]),
                       q_labels=[0, 1, 0])
    assert r.count == 4
    emb = r.embeddings[:r.count].tolist()
    assert {tuple(e) for e in emb} == {(0, 1, 2), (2, 1, 0), (2, 3, 4),
                                       (4, 3, 2)}
    assert (r.embeddings[r.count:] == -1).all()


def test_refusals_and_empty_results():
    g = TG.rmat(5, 2, seed=1, device="cpu")
    with pytest.raises(ValueError, match="BFS-ordered"):
        subgraph_match(g, 3, [(0, 1), (2, 1), (0, 2)][1:])
    with pytest.raises(ValueError, match="cap"):
        subgraph_match(g, *TRIANGLE, cap=0)
    empty = TG.Graph.from_csr(np.zeros(5, np.int32), np.zeros(0, np.int32),
                              device="cpu")
    r = subgraph_match(empty, *PATH3, cap=16)
    assert r.count == 0 and not r.truncated
    assert (r.embeddings == -1).all()


def test_cpu_run_launches_no_kernel(pair):
    _, tg = pair
    K.reset_launches()
    subgraph_match(tg, *SQUARE, cap=1000)
    assert all(k.launches == 0 for k in K.KERNELS.values())
