"""The port's rules: it never imports JAX or the reference package, its
entry points never drop to the CPU on their own, the ``cuda`` backend
takes CUDA tensors only, and every kernel names the TPU kernel it
replaces."""
import ast
from pathlib import Path

import pytest
import torch

from repro_torch.core import backend as TB
from repro_torch.core import graph as TG
from repro_torch.core.primitives import (bc, bc_batch, bfs,
                                         connected_components,
                                         label_propagation, pagerank, reach,
                                         reach_batch, sssp, subgraph_match,
                                         triangle_count,
                                         triangle_count_full, who_to_follow)
from repro_torch.kernels import ops as K
from repro_torch.kernels import runtime
from repro_torch.launch import graph_run

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) +
                         [ROOT / "chip_smoke.py",
                          ROOT / "tools" / "ab_paths.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_never_imports_jax_or_reference(path):
    bad = [name for name in _imports(path) if _forbidden(name)]
    assert not bad, f"{path} imports {bad}"


def test_device_none_means_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runtime.resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TG.rmat(4, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graph_run.main(["--scale", "4"])
    assert runtime.resolve_device("cpu").type == "cpu"


def test_cuda_backend_refuses_cpu_tensors():
    g = TG.rmat(5, 4, seed=2, weighted=True, device="cpu")
    for call in (lambda: bfs(g, 0, backend="cuda"),
                 lambda: sssp(g, 0, backend="cuda"),
                 lambda: pagerank(g, backend="cuda"),
                 lambda: connected_components(g, backend="cuda"),
                 lambda: bc(g, 0, backend="cuda"),
                 lambda: bc_batch(g, [0, 1], backend="cuda"),
                 lambda: triangle_count(g, backend="cuda"),
                 lambda: triangle_count_full(g, backend="cuda"),
                 lambda: reach(g, 0, backend="cuda"),
                 lambda: reach_batch(g, [0, 1], backend="cuda"),
                 lambda: label_propagation(g, backend="cuda"),
                 lambda: who_to_follow(g, 0, k=4, backend="cuda"),
                 lambda: subgraph_match(g, 3, [(0, 1), (1, 2)],
                                        backend="cuda")):
        with pytest.raises(ValueError, match="CUDA tensors"):
            call()
    assert TB.resolve(None, g.device) == TB.TORCH
    assert TB.resolve(None, torch.device("cuda")) == TB.CUDA
    assert TB.resolve("torch", torch.device("cuda")) == TB.TORCH
    with pytest.raises(ValueError, match="unknown backend"):
        TB.resolve("xla", g.device)


def test_dispatch_miss_is_structured():
    with pytest.raises(TB.ProviderMissError) as info:
        TB.dispatch("no_such_op", TB.TORCH)
    assert info.value.op == "no_such_op"
    assert isinstance(info.value, KeyError)
    for op in ("compact", "advance", "advance_batch", "advance_filter",
               "advance_filter_batch", "spmv", "spmm", "segment_search",
               "mxm"):
        assert TB.registered(op, TB.TORCH) and TB.registered(op, TB.CUDA)


@pytest.mark.parametrize("name", sorted(K.KERNELS))
def test_kernel_records_point_at_real_sources(name):
    k = K.KERNELS[name]
    assert (ROOT / k.source).exists()
    path, line = k.replaces.split(":")
    text = (ROOT / path).read_text().splitlines()[int(line) - 1]
    assert text.startswith("def ") and "kernel" in text
    assert k.replaces in (ROOT / k.source).read_text()
