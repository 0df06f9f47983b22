"""PageRank (paper §6.5), counterpart of
``repro.core.primitives.pagerank``.

Each iteration is one plus-times SpMV over the CSC transpose (rank mass
flows along reversed edges) through the ``"spmv"`` registry op, plus the
dangling mass and the teleport term. Two determinism rules of the
reference are kept: the reciprocal out-degrees are computed once on the
host (a single multiply in the loop, no division), and the dangling sum
is a fixed pairwise halving tree (``_fixed_tree_sum``).

``telemetry=True`` also returns a ``TelemetryBuffer`` with the active
(not yet settled) vertex count a sweep; ``budget=`` caps the sweeps
below ``max_iter`` (``converged`` False when it cut them short).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ...analysis import sanitize
from ...linalg import semiring as SR
from .. import backend as B
from ..enactor import run_until
from ..graph import Graph


class PRState(NamedTuple):
    rank: torch.Tensor       # (n,) float32
    active: torch.Tensor     # (n,) bool — unconverged vertices
    n_active: torch.Tensor   # () int32


class PRResult(NamedTuple):
    rank: torch.Tensor
    iterations: int
    # ranks settled below tol, or every requested sweep ran: False only
    # when a budget cut the sweeps short
    converged: bool


def _fixed_tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Float sum with a grouping fixed by construction: pad to a power of
    two, then halve — each step one elementwise add."""
    n = int(x.shape[0])
    k = 1
    while k < n:
        k *= 2
    x = torch.nn.functional.pad(x, (0, k - n))
    while k > 1:
        k //= 2
        x = x[:k] + x[k:]
    return x[0]


def _inv_out_degrees(graph: Graph) -> torch.Tensor:
    """Exact host-side reciprocal out-degrees (0 on dangling vertices),
    computed once per graph."""
    cached = graph.cache.get("inv_deg")
    if cached is None:
        deg = graph.degrees.cpu().numpy().astype(np.float32)
        inv = np.where(deg > 0, np.float32(1.0) / np.maximum(deg, 1.0),
                       np.float32(0.0)).astype(np.float32)
        cached = torch.from_numpy(inv).to(graph.device)
        graph.cache["inv_deg"] = cached
        sanitize.note_setup()
    return cached


@B.draw_scope()
def pagerank(graph: Graph, *, damping: float = 0.85, tol: float = 0.0,
             max_iter: int = 20, backend: Optional[str] = None,
             placement: Optional[str] = None,
             precision: str = "fp32", telemetry: bool = False,
             budget=None):
    """Power-iteration PageRank: at most ``max_iter`` sweeps, stopping
    early only when every rank moves by ≤ ``tol``. ``precision="bf16"``
    rounds the sweep's products to bfloat16 (float32 sums), as the
    reference does: the ranks then agree with float32 to ~1e-2, not
    bit for bit. ``telemetry=True`` returns ``(PRResult,
    TelemetryBuffer)``; ``budget`` caps the sweeps. ``graph`` may be a
    ``ShardedGraph`` / ``Sharded2DGraph``: the sweep then runs through
    its placement's "spmv" provider, the rest of the body unchanged, so
    the ranks equal the single-device run's bit for bit."""
    if not graph.has_csc:
        raise ValueError("pagerank uses the CSC transpose")
    bk = B.resolve(backend, graph.device)
    pl, ctx = B.resolve_graph_placement(graph, placement)
    with ctx, sanitize.setup_probe("pagerank", graph.cache,
                                   (bk, pl, precision)):
        return _pagerank(graph, bk, pl, damping, tol, max_iter, precision,
                         telemetry, budget)


def _pagerank(graph, bk, pl, damping, tol, max_iter, precision, telemetry,
              budget):
    spmv = B.dispatch("spmv", bk, pl)
    # the CSC store as the provider takes it (decoded once per graph for
    # a provider that declared only "dense")
    csc = B.storage_arg("spmv", bk, pl, graph=graph, side="csc")
    sr = SR.with_precision(SR.plus_times, precision)
    n = graph.num_vertices
    dev = graph.device
    inv_deg = _inv_out_degrees(graph)
    dangling_mask = inv_deg == 0
    d = torch.tensor(damping, dtype=torch.float32, device=dev)
    tol_t = torch.tensor(tol, dtype=torch.float32, device=dev)
    teleport = (1.0 - d) / n

    def body(st: PRState) -> PRState:
        contrib = st.rank * inv_deg
        acc = spmv(graph.csc_offsets, csc, None, contrib, sr,
                   graph.csc_ell_width, None, graph.csc_row_seg,
                   graph.csc_over_pos, graph.csc_over_row,
                   cache=graph.cache)
        dangling = _fixed_tree_sum(
            torch.where(dangling_mask, st.rank, 0.0)) / n
        new_rank = teleport + d * (acc + dangling)
        still = (new_rank - st.rank).abs() > tol_t
        return PRState(rank=new_rank, active=still,
                       n_active=still.sum(dtype=torch.int32))

    state = PRState(rank=torch.full((n,), 1.0 / n, dtype=torch.float32,
                                    device=dev),
                    active=torch.ones((n,), dtype=torch.bool, device=dev),
                    n_active=torch.tensor(n, dtype=torch.int32, device=dev))
    effective = max_iter if budget is None else budget.cap_iters(max_iter)
    probe = buf = None
    if telemetry:
        from ...obs.telemetry import TelemetryBuffer
        buf = TelemetryBuffer.make(effective,
                                   {"active": ((), torch.int32)}, dev)

        def probe(prev, new, _params):
            return {"active": new.n_active}

    final, iters, *rest = run_until(lambda st: st.n_active > 0, body,
                                    state, max_iter=effective, probe=probe,
                                    telemetry=buf)
    converged = iters >= max_iter or int(final.n_active) == 0
    result = PRResult(rank=final.rank, iterations=iters,
                      converged=converged)
    return (result, rest[0]) if telemetry else result
