"""The device generator against a plain numpy statement of the Graph500
Kronecker recurrence, and the pair weights."""
import numpy as np
import pytest
import torch

import pbtest_util as U
from pb import spec

GEN = spec.generator(U.REPO, "kronecker")
PARAMS = {"scale": 9, "edgefactor": 16, "A": 0.57, "B": 0.19, "C": 0.19,
          "weights": [1, 63]}


def numpy_kronecker(draws, perm, scale, a, b, c):
    """The specification's octave statement, in numpy, on given draws
    (one (2, M) array a level) and vertex permutation."""
    ab = a + b
    c_norm = np.float32(c / (1 - ab))
    a_norm = np.float32(a / ab)
    m = draws[0].shape[1]
    ij = np.zeros((2, m), np.int64)
    for ib in range(scale):
        ii_bit = draws[ib][0] > np.float32(ab)
        jj_bit = draws[ib][1] > (c_norm * ii_bit + a_norm * ~ii_bit)
        ij += (2 ** ib) * np.stack([ii_bit, jj_bit]).astype(np.int64)
    return perm[ij]


def test_matches_the_graph500_statement():
    seed = U.SEED
    e = GEN.edges(PARAMS, seed, torch.device("cpu"))
    # the same draws, in the generator's order
    gen = torch.Generator().manual_seed(seed % (1 << 63))
    n, m = 1 << PARAMS["scale"], PARAMS["edgefactor"] << PARAMS["scale"]
    draws = [torch.rand((2, m), generator=gen).numpy()
             for _ in range(PARAMS["scale"])]
    perm = torch.randperm(n, generator=gen).numpy()
    want = numpy_kronecker(draws, perm, PARAMS["scale"], 0.57, 0.19, 0.19)
    assert e["n"] == n
    np.testing.assert_array_equal(e["src"].numpy(), want[0])
    np.testing.assert_array_equal(e["dst"].numpy(), want[1])


@pytest.mark.parametrize("abc", [(0.57, 0.19, 0.19), (0.65, 0.15, 0.15)])
def test_quadrant_shares(abc):
    a, b, c = abc
    r = torch.rand((2, 1 << 18), generator=torch.Generator().manual_seed(3))
    ii, jj = GEN.bits(r[0], r[1], a, b, c)
    share = [float(((ii == i) & (jj == j)).float().mean())
             for i, j in ((0, 0), (0, 1), (1, 0), (1, 1))]
    np.testing.assert_allclose(share, [a, b, c, 1 - a - b - c], atol=0.005)


def test_same_seed_same_graph_other_seed_other_graph():
    cpu = torch.device("cpu")
    one, two = (GEN.edges(PARAMS, s, cpu) for s in (U.SEED, U.SEED))
    other = GEN.edges(PARAMS, U.SEED + 1, cpu)
    for k in ("src", "dst", "weight"):
        assert torch.equal(one[k], two[k])
    assert not torch.equal(one["src"], other["src"])


def test_pair_weight_is_symmetric_in_range_and_as_stated():
    u = torch.randint(0, 1 << 22, (4096,), generator=torch.Generator()
                      .manual_seed(1))
    v = torch.randint(0, 1 << 22, (4096,), generator=torch.Generator()
                      .manual_seed(2))
    w = GEN.pair_weight(u, v, U.SEED, 1, 63)
    assert torch.equal(w, GEN.pair_weight(v, u, U.SEED, 1, 63))
    assert w.dtype == torch.float32
    assert int(w.min()) >= 1 and int(w.max()) <= 63
    assert len(torch.unique(w)) == 63
    mask = (1 << 46) - 1
    s = GEN.seed_word(U.SEED)
    for a, b, got in zip(u.tolist()[:64], v.tolist()[:64], w.tolist()):
        x = ((min(a, b) << 26) ^ max(a, b)) & mask
        for c in (40503, 52711, 31337):
            x = ((((x ^ (x >> 19)) & mask) * c) & mask) ^ s
        assert got == 1 + (x >> 20) % 63


@pytest.mark.cuda
def test_card_draws_a_valid_graph(card):
    e = GEN.edges(PARAMS, U.SEED, card)
    n = 1 << PARAMS["scale"]
    assert e["src"].device.type == "cuda"
    assert int(e["src"].min()) >= 0 and int(e["src"].max()) < n
    assert torch.equal(e["weight"], GEN.pair_weight(e["dst"], e["src"],
                                                    U.SEED, 1, 63))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
