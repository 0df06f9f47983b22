"""Host-side oracles of the primitives."""
from .ref_graph import (PR_RTOL, bc_ref, bfs_ref, cc_ref,
                        label_propagation_ref, pagerank_ref,
                        pagerank_rel_err, ppr_ref, reach_ref, salsa_ref,
                        sssp_ref, tc_ref)

__all__ = ["PR_RTOL", "bc_ref", "bfs_ref", "cc_ref",
           "label_propagation_ref", "pagerank_ref", "pagerank_rel_err",
           "ppr_ref", "reach_ref", "salsa_ref", "sssp_ref", "tc_ref"]
