"""Who-To-Follow (paper §7.5; Geil et al.), counterpart of
``repro.core.primitives.wtf`` — Twitter's recommendation pipeline on a
follow graph:

  1. PPR   — personalized PageRank from the query user;
  2. CoT   — the 'circle of trust': the top-k PPR vertices, the user
             excluded, equal ranks in ascending id order (the order of
             ``jax.lax.top_k``; a stable descending sort gives it, where
             ``torch.topk`` on the card promises no order among ties);
  3. Money — SALSA on the bipartite graph {CoT as hubs} × {their
             out-neighbours as authorities}: authority scores are the
             recommendations, hub scores the 'similar users'.

All three stages are dense gather / segment-sum sweeps over the CSR and
CSC, as in the reference, which has no kernel of its own for them; the
segment owner of each edge slot is the graph's build-time ``row_seg`` /
``csc_row_seg`` (the reference searches the offsets on every call, for
the same values). On the card the segment sums are ``index_add_`` with
float atomics, so their order, and the last bits, vary run to run.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import backend as B
from ..graph import Graph, row_segments_of


class WTFResult(NamedTuple):
    ppr: torch.Tensor          # (n,) personalized PageRank
    cot: torch.Tensor          # (k,) int32 circle-of-trust vertex ids
    hub_scores: torch.Tensor   # (n,) SALSA hub scores ('similar to you')
    auth_scores: torch.Tensor  # (n,) SALSA authority scores


def who_to_follow(graph: Graph, user: int, *, k: int = 1000,
                  damping: float = 0.85, ppr_iters: int = 30,
                  salsa_iters: int = 10,
                  backend: Optional[str] = None) -> WTFResult:
    """The WTF pipeline for one user. ``backend`` is accepted for a
    uniform primitive interface: the stages are plain PyTorch sweeps on
    both backends."""
    B.resolve(backend, graph.device)
    if not graph.has_csc:
        raise ValueError("who_to_follow uses the CSC mirror")
    n = graph.num_vertices
    dev = graph.device
    k = min(int(k), n - 1)
    deg = graph.degrees.to(torch.float32)
    seg = graph.csc_row_seg                     # CSC slot → destination
    if seg is None:
        seg = row_segments_of(graph.csc_offsets)
    src_all = graph.row_seg                     # CSR slot → source
    if src_all is None:
        src_all = row_segments_of(graph.row_offsets)
    esrc_csc = graph.csc_indices
    edst_csr = graph.col_indices
    d = torch.tensor(damping, dtype=torch.float32, device=dev)

    def seg_sum(vals: torch.Tensor, owners: torch.Tensor) -> torch.Tensor:
        out = torch.zeros((n,), dtype=torch.float32, device=dev)
        return out.index_add_(0, owners, vals)

    def per_degree(x: torch.Tensor, dg: torch.Tensor) -> torch.Tensor:
        return torch.where(dg > 0, x / torch.clamp_min(dg, 1.0), 0.0)

    # ---- stage 1: PPR ----------------------------------------------------
    pr = torch.zeros((n,), dtype=torch.float32, device=dev)
    pr[user] = 1.0
    for _ in range(ppr_iters):
        contrib = per_degree(pr, deg)
        acc = seg_sum(torch.index_select(contrib, 0, esrc_csc), seg)
        dangling = torch.where(deg == 0, pr, 0.0).sum()
        new = d * acc
        new[user] += (1.0 - d) + d * dangling
        pr = new

    # ---- stage 2: circle of trust (top-k PPR, the user excluded) ---------
    masked = pr.clone()
    masked[user] = float("-inf")
    top_vals, order = torch.sort(masked, descending=True, stable=True)
    top_vals, cot = top_vals[:k], order[:k].to(torch.int32)
    hubs = torch.zeros((n,), dtype=torch.bool, device=dev)
    hubs[cot[top_vals > 0].long()] = True

    # ---- stage 3: SALSA on the CoT-induced bipartite graph ---------------
    live_csr = torch.index_select(hubs, 0, src_all)   # source is a hub
    live_csc = torch.index_select(hubs, 0, esrc_csc)
    hub_deg = seg_sum(live_csr.to(torch.float32), src_all)
    auth_deg = seg_sum(live_csc.to(torch.float32), seg)
    h = hubs.to(torch.float32) / max(int(hubs.sum()), 1)
    a = torch.zeros((n,), dtype=torch.float32, device=dev)
    for _ in range(salsa_iters):
        # hub -> authority (gather per CSC slot, reduce by destination)
        contrib_h = torch.index_select(per_degree(h, hub_deg), 0, esrc_csc)
        a = seg_sum(torch.where(live_csc, contrib_h, 0.0), seg)
        # authority -> hub (gather per CSR slot, reduce by source)
        contrib_a = torch.index_select(per_degree(a, auth_deg), 0, edst_csr)
        h = seg_sum(torch.where(live_csr, contrib_a, 0.0), src_all)
        h = torch.where(hubs, h, 0.0)
    return WTFResult(ppr=pr, cot=cot, hub_scores=h, auth_scores=a)
