"""Frontier engine: graph, frontiers, operators, enactor, primitives."""
