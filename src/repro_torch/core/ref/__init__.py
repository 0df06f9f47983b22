"""Host-side oracles of the primitives."""
from .ref_graph import (PR_RTOL, bc_ref, bfs_ref, cc_ref, pagerank_ref,
                        pagerank_rel_err, sssp_ref, tc_ref)

__all__ = ["PR_RTOL", "bc_ref", "bfs_ref", "cc_ref", "pagerank_ref",
           "pagerank_rel_err", "sssp_ref", "tc_ref"]
