"""The port's rules: it never imports JAX or the reference package, its
entry points never drop to the CPU on their own, the ``cuda`` backend
takes CUDA tensors only, and every kernel names the TPU kernel it
replaces."""
import ast
from pathlib import Path

import numpy as np
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
                         [ROOT / "chip_smoke.py"] +
                         sorted((ROOT / "tools").glob("*.py")),
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


def _env_reads(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and node.attr in (
                "environ", "getenv", "putenv", "environb"):
            yield node.attr
        elif isinstance(node, ast.ImportFrom) and node.module == "os":
            yield from (a.name for a in node.names
                        if a.name in ("environ", "getenv"))


# the one variable the port reads, as the reference does: it only adds
# the sanitizers' checks and changes no result
_ENV_ALLOWED = {"src/repro_torch/analysis/sanitize.py": "REPRO_SANITIZE"}


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_reads_no_environment_variable(path):
    """The reference's REPRO_* variables are arguments here (the fault
    plan, the log level, the backend); REPRO_SANITIZE alone is read, by
    ``analysis.sanitize.enabled()``."""
    bad = list(_env_reads(path))
    allowed = _ENV_ALLOWED.get(str(path.relative_to(ROOT)))
    if allowed is not None:
        text = path.read_text()
        assert bad == ["environ"] and text.count("environ") == 1
        assert f'ENV_VAR = "{allowed}"' in text
        assert "os.environ.get(ENV_VAR" in text
        return
    assert not bad, f"{path} reads the environment: {bad}"


def test_serving_entry_points_need_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is valid here")
    from repro_torch.core import frontier as TF
    from repro_torch.launch import graph_serve
    for call in (lambda: graph_serve.main(["--scale", "4"]),
                 lambda: graph_run.main(["--graph", "rgg", "--scale", "4"]),
                 lambda: TG.random_geometric(16, 0.3),
                 lambda: TG.bipartite_random(4, 4, 2),
                 lambda: TG.demo_graph(),
                 lambda: TF.empty(4)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_placement_entry_points_need_the_card():
    """The placements keep the rules: ``backend="cuda"`` on a CPU mesh
    raises, and serving from a mesh with no device named needs the
    card."""
    from repro_torch.core import distributed as D
    from repro_torch.core.partition import Mesh, partition_1d, partition_2d
    from repro_torch.launch import graph_serve
    g = TG.rmat(5, 4, seed=2, weighted=True, device="cpu")
    mesh = Mesh.on("cpu", (2,), ("graph",))
    pg = partition_1d(g, 2)
    for call in (lambda: D.distributed_bfs(pg, 0, mesh, backend="cuda"),
                 lambda: pagerank(pg.shard(mesh), backend="cuda"),
                 lambda: reach_batch(pg.shard(mesh), [0], backend="cuda")):
        with pytest.raises(ValueError, match="CUDA tensors"):
            call()
    assert partition_2d(g, 2, 2).shard(Mesh.on(
        "cpu", (2, 2), ("row", "col"))).device.type == "cpu"
    if torch.cuda.is_available():
        return
    for argv in (["--scale", "4", "--parts", "2"],
                 ["--scale", "4", "--mesh", "2x2"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            graph_serve.main(argv)


def test_lm_entry_points_need_the_card():
    """The LM serving path's entry points default to the card and raise
    without one; ``meta`` builds shapes anywhere."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is valid here")
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.gunrock_graphs import make_paper_dataset
    from repro_torch.convert import params_from_arrays
    from repro_torch.data import SyntheticLMDataset, make_batch_for
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    cfg = get_smoke_config("minicpm-2b")
    model = build_model(cfg)
    for call in (lambda: model.init(device=None),
                 lambda: model.init(),
                 lambda: serve.main(["--arch", "minicpm-2b", "--smoke"]),
                 lambda: make_batch_for(cfg, {"global_batch": 2,
                                              "seq_len": 8}, "train"),
                 lambda: SyntheticLMDataset(cfg.vocab, 8, 2),
                 lambda: params_from_arrays({"w": np.zeros(2, np.float32)}),
                 lambda: make_paper_dataset("roadnet_USA")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert model.param_count(model.init(device="meta")) > 0


def test_training_entry_points_need_the_card():
    """The training path's entry points default to the card and raise
    without one: the launcher, the test mesh, the restartable trainer
    and a restore with no device named."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is valid here")
    from repro_torch.ckpt import restore_checkpoint, save_checkpoint
    from repro_torch.ft import RestartableTrainer
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
    for call in (lambda: train.main(["--arch", "minicpm-2b", "--smoke"]),
                 lambda: make_test_mesh(2, 4),
                 lambda: RestartableTrainer("unused"),
                 lambda: restore_checkpoint("unused", 0, {})):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert make_production_mesh().devices[0].type == "meta"
