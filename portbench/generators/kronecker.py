"""The Graph500 Kronecker generator, drawn on the device from the seed.

The recurrence is the one the Graph500 specification states in its
"Kronecker generator" section (octave form):

    ab = A + B;  c_norm = C / (1 - ab);  a_norm = A / ab
    for each of SCALE levels:
        ii_bit = rand > ab
        jj_bit = rand > (c_norm * ii_bit + a_norm * (1 - ii_bit))
        (i, j) += 2^level * (ii_bit, jj_bit)
    then the vertex ids go through one random permutation of [0, N).

so a level puts an edge in quadrant (0,0), (0,1), (1,0), (1,1) with
probabilities A, B, C, 1 - A - B - C. The specification also shuffles
the edge order; the graph is a set of undirected edges, so that shuffle
changes nothing here and is left out.

Weights: an integer in [lo, hi], a hash of the unordered pair and the
seed, so every copy of an undirected edge carries the same weight
whichever copy a deduplicating build keeps.
"""
from __future__ import annotations

import torch

_MASK46 = (1 << 46) - 1
_ROUNDS = (40503, 52711, 31337)        # odd 16-bit multipliers


def seed_word(seed: int) -> int:
    """A 46-bit word of ``seed`` (any size of integer) for the hash."""
    return ((int(seed) * 0x9E3779B97F4A7C15) % (1 << 64)) >> 18


def pair_weight(u: torch.Tensor, v: torch.Tensor, seed: int, lo: int,
                hi: int) -> torch.Tensor:
    """Integer weights in [lo, hi] as float32, one per unordered pair.
    int64 arithmetic that never passes 2^62."""
    a = torch.minimum(u, v)
    b = torch.maximum(u, v)
    x = ((a << 26) ^ b) & _MASK46
    s = seed_word(seed)
    for c in _ROUNDS:
        x = (((x ^ (x >> 19)) & _MASK46) * c) & _MASK46
        x = x ^ s
    return (lo + (x >> 20) % (hi - lo + 1)).to(torch.float32)


def bits(r_row: torch.Tensor, r_col: torch.Tensor, a: float, b: float,
         c: float) -> tuple[torch.Tensor, torch.Tensor]:
    """One level's (row bit, column bit) from two uniform draws."""
    ab = a + b
    c_norm = c / (1.0 - ab)
    a_norm = a / ab
    ii = r_row > ab
    jj = r_col > torch.where(ii, c_norm, a_norm)
    return ii, jj


def edges(params: dict, seed: int, device) -> dict:
    """The edge list of one graph: ``src``, ``dst`` (int64) and
    ``weight`` (float32) on ``device``, and ``n``."""
    scale = int(params["scale"])
    n = 1 << scale
    m = int(params["edgefactor"]) * n
    a, b, c = (float(params[k]) for k in ("A", "B", "C"))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    src = torch.zeros(m, dtype=torch.int64, device=device)
    dst = torch.zeros(m, dtype=torch.int64, device=device)
    for level in range(scale):
        r = torch.rand((2, m), generator=gen, device=device)
        ii, jj = bits(r[0], r[1], a, b, c)
        src |= ii.to(torch.int64) << level
        dst |= jj.to(torch.int64) << level
        del r, ii, jj
    perm = torch.randperm(n, generator=gen, device=device)
    src, dst = perm[src], perm[dst]
    lo, hi = params["weights"]
    return {"src": src, "dst": dst, "n": n,
            "weight": pair_weight(src, dst, seed, int(lo), int(hi))}
