"""Frontier engine: graph, frontiers, operators (advance under the LB,
TWC and THREAD load-balancing strategies; filter with exact or hash
uniquification), enactor, primitives."""
