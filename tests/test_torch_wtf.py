"""Port who-to-follow against the reference: the circle of trust equal
to the reference's (equal PPR ranks in ascending id order, as
``jax.lax.top_k`` gives them), and PPR, hub and authority scores within
1e-6 of it. The port's segment sums add in the reference's order on the
CPU and were bit-equal on these fixtures; the limit leaves room for the
reference's XLA contracting ``(1 - d) + d * dangling`` into one
multiply-add (ROADMAP C-ref-3), which PyTorch rounds in two steps. The
vectorised PPR and SALSA oracles equal the reference's loop oracles bit
for bit (the same float64 additions in the same order)."""
import importlib

import numpy as np
import pytest
import torch

from repro.core import graph as JG
from repro.core.ref import ref_graph as JR
from repro_torch import convert
from repro_torch.core import graph as TG
from repro_torch.core import ref as R
from repro_torch.core.graph import TENSOR_FIELDS
from repro_torch.core.primitives import who_to_follow

JW = importlib.import_module("repro.core.primitives.wtf")
TOL = 1e-6


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


def _hub_user(tg):
    return int(np.argmax(np.diff(tg.row_offsets.numpy())))


@pytest.mark.parametrize("k,ppr_iters,salsa_iters",
                         [(32, 15, 4), (100, 30, 10)])
def test_wtf_matches_reference(pair, k, ppr_iters, salsa_iters):
    jg, tg = pair
    u = _hub_user(tg)
    jr = JW.who_to_follow(jg, u, k=k, ppr_iters=ppr_iters,
                          salsa_iters=salsa_iters)
    tr = who_to_follow(tg, u, k=k, ppr_iters=ppr_iters,
                       salsa_iters=salsa_iters)
    assert tr.cot.dtype == torch.int32
    assert np.array_equal(np.asarray(jr.cot), tr.cot.numpy())
    for f in ("ppr", "hub_scores", "auth_scores"):
        got = getattr(tr, f)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(jr, f)),
                                   rtol=0, atol=TOL, err_msg=f)
    assert u not in tr.cot.tolist()


def test_wtf_tie_order_is_ascending_id():
    """A star: every leaf gets the same PPR from the centre, so the
    circle of trust is a run of ties that must come out in id order."""
    leaves = np.arange(1, 40)
    jg = JG.from_edge_list(np.zeros(39, np.int64), leaves, n=40,
                           undirected=True)
    tg = TG.from_edge_list(np.zeros(39, np.int64), leaves, n=40,
                           undirected=True, device="cpu")
    jr = JW.who_to_follow(jg, 0, k=10, ppr_iters=5, salsa_iters=2)
    tr = who_to_follow(tg, 0, k=10, ppr_iters=5, salsa_iters=2)
    assert tr.cot.tolist() == np.asarray(jr.cot).tolist()
    assert tr.cot.tolist() == list(range(1, 11))


def test_wtf_k_is_clamped_to_n_minus_one():
    tg = TG.grid2d(3, device="cpu")
    r = who_to_follow(tg, 4, k=1000, ppr_iters=3, salsa_iters=2)
    assert r.cot.shape == (8,) and 4 not in r.cot.tolist()


def test_vectorised_oracles_equal_reference_oracles(pair):
    jg, tg = pair
    u = _hub_user(tg)
    assert np.array_equal(R.ppr_ref(tg, u, iters=20),
                          JR.ppr_ref(jg, u, iters=20))
    rng = np.random.default_rng(5)
    for frac in (0.0, 0.05, 0.5):
        hubs = rng.random(tg.num_vertices) < frac
        for got, want in zip(R.salsa_ref(tg, hubs, iters=6),
                             JR.salsa_ref(jg, hubs, iters=6)):
            assert np.array_equal(got, want)
