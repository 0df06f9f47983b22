"""Graph primitives of the main path: BFS, SSSP and PageRank."""
from .bfs import BFSResult, bfs, bfs_batch
from .pagerank import PRResult, pagerank
from .sssp import SSSPResult, sssp, sssp_batch

__all__ = ["BFSResult", "PRResult", "SSSPResult", "bfs", "bfs_batch",
           "pagerank", "sssp", "sssp_batch"]
