"""Graph primitives: BFS, SSSP, PageRank, connected components,
betweenness centrality and triangle counting — the paper's six."""
from .bc import BCResult, MultiBCResult, bc, bc_batch
from .bfs import BFSResult, bfs, bfs_batch
from .cc import CCResult, connected_components
from .pagerank import PRResult, pagerank
from .sssp import SSSPResult, sssp, sssp_batch
from .tc import TCResult, triangle_count, triangle_count_full

__all__ = ["BCResult", "BFSResult", "CCResult", "MultiBCResult",
           "PRResult", "SSSPResult", "TCResult", "bc", "bc_batch", "bfs",
           "bfs_batch", "connected_components", "pagerank", "sssp",
           "sssp_batch", "triangle_count", "triangle_count_full"]
