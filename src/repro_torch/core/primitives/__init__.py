"""Graph primitives: the paper's six (BFS, SSSP, PageRank, connected
components, betweenness centrality, triangle counting) and the
reference's algebraic and application primitives (k-hop reach, label
propagation, who-to-follow, subgraph matching)."""
from .bc import BCResult, MultiBCResult, bc, bc_batch
from .bfs import BFSResult, bfs, bfs_batch
from .cc import CCResult, connected_components
from .label_propagation import LPResult, label_propagation
from .pagerank import PRResult, pagerank
from .reach import ReachResult, reach, reach_batch
from .sssp import SSSPResult, sssp, sssp_batch
from .subgraph import MatchResult, subgraph_match, subgraph_match_ref
from .tc import TCResult, triangle_count, triangle_count_full
from .wtf import WTFResult, who_to_follow

__all__ = ["BCResult", "BFSResult", "CCResult", "LPResult", "MatchResult",
           "MultiBCResult", "PRResult", "ReachResult", "SSSPResult",
           "TCResult", "WTFResult", "bc", "bc_batch", "bfs", "bfs_batch",
           "connected_components", "label_propagation", "pagerank",
           "reach", "reach_batch", "sssp", "sssp_batch", "subgraph_match",
           "subgraph_match_ref", "triangle_count", "triangle_count_full",
           "who_to_follow"]
