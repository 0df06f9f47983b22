"""Host-side oracles of the primitives."""
from .ref_graph import bfs_ref, pagerank_ref, sssp_ref

__all__ = ["bfs_ref", "pagerank_ref", "sssp_ref"]
