"""The plain reference against hand-made graphs and against scipy."""
import numpy as np
import pytest
import torch

import pbtest_util  # noqa: F401  (puts the benchmark on sys.path)
from reference import traversal as R

INF = float("inf")


def graph(edges, n):
    src, dst, w = zip(*edges)
    return R.undirected(torch.tensor(src), torch.tensor(dst),
                        torch.tensor(w, dtype=torch.float32), n)


# 0-1-2-3 a path of weights 5, 1, 1 with a shortcut 0-3 of weight 9, a
# self loop on 2, a duplicate of 1-2, and 4-5 apart; 6 isolated
G = graph([(0, 1, 5), (1, 2, 1), (2, 3, 1), (0, 3, 9), (2, 2, 4),
           (2, 1, 1), (4, 5, 2)], 7)


def test_undirected_edge_set():
    pairs = set(zip(G["src"].tolist(), G["dst"].tolist()))
    assert pairs == {(0, 1), (1, 0), (1, 2), (2, 1), (2, 3), (3, 2), (0, 3),
                     (3, 0), (4, 5), (5, 4)}


def test_bfs_sssp_reach_by_hand():
    assert R.bfs(G, 0).tolist() == [0, 1, 2, 1, -1, -1, -1]
    assert R.sssp(G, 0).tolist() == [0, 5, 6, 7, INF, INF, INF]
    assert R.sssp(G, 4).tolist() == [INF, INF, INF, INF, 0, 2, INF]
    assert R.reach(G, 0, 1).tolist() == [True, True, False, True, False,
                                         False, False]
    assert R.reach(G, 6, 3).tolist() == [False] * 6 + [True]


def test_one_round_short_differs():
    """The control: stopped one round before convergence."""
    assert R.bfs(G, 0, rounds_short=1).tolist() == [0, 1, -1, 1, -1, -1, -1]
    assert R.sssp(G, 0, rounds_short=1).tolist()[3] == 9
    assert R.reach(G, 0, 2, rounds_short=1).tolist() == R.reach(
        G, 0, 1).tolist()


@pytest.mark.parametrize("seed", [0, 1])
def test_against_scipy(seed):
    sp = pytest.importorskip("scipy.sparse.csgraph")
    from scipy.sparse import coo_matrix
    rng = np.random.default_rng(seed)
    n, m = 60, 150
    s, d = rng.integers(0, n, m), rng.integers(0, n, m)
    lo, hi = np.minimum(s, d), np.maximum(s, d)
    w = (lo * 7 + hi * 13) % 63 + 1.0          # one weight per pair
    g = R.undirected(torch.tensor(s), torch.tensor(d),
                     torch.tensor(w, dtype=torch.float32), n)
    a = coo_matrix((g["weight"].numpy(), (g["src"].numpy(),
                                          g["dst"].numpy())), (n, n)).tocsr()
    for src in range(0, n, 7):
        want = sp.dijkstra(a, indices=src)
        np.testing.assert_array_equal(R.sssp(g, src).numpy(),
                                      want.astype(np.float32))
        hops = sp.shortest_path(a, indices=src, unweighted=True)
        want_bfs = np.where(np.isinf(hops), -1, hops).astype(np.int32)
        np.testing.assert_array_equal(R.bfs(g, src).numpy(), want_bfs)
        np.testing.assert_array_equal(R.reach(g, src, 2).numpy(), hops <= 2)
