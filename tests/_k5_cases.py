"""Inputs of K5 (segment search) made with numpy from a seed: the cases
the tile model (tests/test_torch_kernel_models.py) and the card tests
(tests/test_torch_cuda.py) share. No JAX here: the card tests import it.
"""
import numpy as np


def _rows(rng, n: int, m: int):
    """A CSR of n rows, m sorted entries in all: (offsets, values)."""
    deg = rng.multinomial(m, rng.dirichlet(np.full(n, 0.3)))
    ro = np.concatenate([[0], np.cumsum(deg)])
    vals = np.concatenate([np.sort(rng.choice(4 * n, d, replace=False))
                           for d in deg])
    return ro.astype(np.int64), vals.astype(np.int64)


def k5_case(case: str):
    """(haystack int64 values, lo, hi, needles) of a K5 model case."""
    rng = np.random.default_rng(sum(map(ord, case)))
    ro, hay = _rows(rng, 300, 9000)
    deg = np.diff(ro)
    if case in ("shared", "broken"):
        # mxm's probes: row a's entries searched in row b, a run a pair
        pairs = rng.integers(0, 300, (60, 2))
        lo, hi, nd = [], [], []
        for a, b in pairs:
            lo += [ro[b]] * deg[a]
            hi += [ro[b + 1]] * deg[a]
            nd += list(hay[ro[a]:ro[a + 1]])
        lo, hi, nd = map(np.array, (lo, hi, nd))
        if case == "broken":                   # subgraph's dead lanes
            dead = rng.random(len(nd)) < 0.3
            lo, hi = np.where(dead, ro[0], lo), np.where(dead, ro[1], hi)
    elif case == "long_run":
        # one run over many chunks, then chunks of many short runs
        big = int(np.argmax(deg))
        k = 3 * 2048 + 77
        rows = rng.integers(0, 300, 1500)
        reps = rng.integers(1, 4, 1500)
        lo = np.concatenate([np.full(k, ro[big]), np.repeat(ro[rows], reps)])
        hi = np.concatenate([np.full(k, ro[big + 1]),
                             np.repeat(ro[rows + 1], reps)])
        nd = rng.integers(-5, 4 * 300 + 5, len(lo))
    elif case == "hub":
        # a hub segment of 6,000 entries, and a few short runs
        hub = np.sort(rng.choice(10 ** 6, 6000, replace=False))
        hay = np.concatenate([hay, hub])
        nd = np.concatenate([np.sort(rng.choice(hub, 2500)),
                             rng.integers(0, 10 ** 6, 1500)])
        lo = np.full(len(nd), 9000)
        hi = np.full(len(nd), 15000)
        rows = rng.integers(0, 300, 700)
        lo = np.concatenate([lo, ro[rows]])
        hi = np.concatenate([hi, ro[rows + 1]])
        nd = np.concatenate([nd, rng.integers(0, 1200, 700)])
    elif case == "short":
        # segments of 0 and 1 entries, lo >= hi
        lo = rng.integers(0, 9000, 3000)
        hi = lo + rng.integers(-3, 2, 3000)
        lo, hi = np.repeat(lo, 2), np.repeat(hi, 2)
        nd = np.where(rng.random(6000) < 0.5, hay[np.clip(lo, 0, 8999)],
                      rng.integers(0, 1200, 6000))
    elif case == "unsorted":
        # unsorted, overlapping segments; runs of descending needles
        hay = rng.integers(0, 500, 9000)
        lo = np.repeat(rng.integers(0, 8000, 80), 60)
        hi = lo + np.repeat(rng.integers(1, 1000, 80), 60)
        nd = np.sort(rng.integers(0, 500, len(lo)))[::-1].copy()
    elif case == "outside":
        # lo / hi past either end (segments no longer than the haystack)
        lo = np.repeat(rng.integers(-40, 9000, 100), 40)
        hi = lo + np.repeat(rng.integers(0, 300, 100), 40)
        hi[:400] = 9000 + rng.integers(1, 40, 400)
        nd = rng.integers(-3, 1300, len(lo))
    elif case == "empty":
        hay = hay[:0]
        lo = np.repeat(rng.integers(0, 5, 300), 10)
        hi = lo + 3
        nd = rng.integers(0, 9, len(lo))
    elif case == "extremes":
        # needles below and above every value
        rows = np.repeat(rng.integers(0, 300, 100), 30)
        lo, hi = ro[rows], ro[rows + 1]
        nd = np.where(rng.random(len(lo)) < 0.5, -1, 2 ** 31 - 1)
    return (hay, *(np.asarray(a).astype(np.int32) for a in (lo, hi, nd)))


K5_CASES = ["shared", "broken", "long_run", "hub", "short", "unsorted",
            "outside", "empty", "extremes"]
# the paths each case's searches must take (the model's stats)
K5_PATHS = {"shared": ("fast", "empty"), "broken": ("fast",),
            "long_run": ("fast",), "hub": ("fast",),
            "short": ("fast", "empty"), "unsorted": ("fast",),
            "outside": ("fast", "clamped"), "empty": ("empty",),
            "extremes": ("fast",)}
