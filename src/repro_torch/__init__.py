"""Gunrock on PyTorch and CUDA: the port of the ``repro`` package's graph
engine to one NVIDIA Hopper card.

The module layout mirrors ``repro`` (``core.graph``, ``core.frontier``,
``core.operators``, ``core.enactor``, ``core.primitives``,
``linalg``, ``kernels``, ``launch.graph_run``). It imports ``torch``,
numpy and scipy, never ``jax`` and nothing of ``repro``. Entry points
run on the card unless the caller passes ``device="cpu"``; the operator
hot paths are the hand-written CUDA kernels under ``kernels/csrc``.
"""
