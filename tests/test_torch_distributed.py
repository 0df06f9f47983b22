"""The port's placements (``core/distributed.py``) against the reference.

In-process: the distributed bfs / sssp / cc / label_propagation / reach
under every placement are bit-equal to the reference's single-device
primitives, and the sharded / 2-D ``spmv`` / ``spmm`` / ``mxm`` to the
reference's single-device ``linalg``; distributed PageRank is bit-equal
to the port's single-device ``pagerank`` and within C-ref-3's 1e-6 of
the reference's (XLA fuses one multiply-add that PyTorch rounds twice).
Subprocesses: the reference's own ``distributed_*`` on four fake host
devices, and the int64 storage baseline under ``jax_enable_x64``. Data
crosses between the packages as numpy."""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import linalg as JL
from repro.core import distributed as JD
from repro.core import graph as JG
from repro.core.partition import partition_1d as j_partition_1d
from repro.core.partition import partition_2d as j_partition_2d
from repro.core.primitives import bfs as jbfs
from repro.core.primitives import connected_components as jcc
from repro.core.primitives import label_propagation as jlp
from repro.core.primitives import pagerank as jpagerank
from repro.core.primitives import reach_batch as jreach_batch
from repro.core.primitives import sssp as jsssp
from repro_torch import linalg as TL
from repro_torch.core import distributed as D
from repro_torch.core import graph as TG
from repro_torch.core.partition import Mesh, partition_1d, partition_2d
from repro_torch.core.primitives import bfs, pagerank, sssp

ROOT = Path(__file__).resolve().parents[1]
SRCS = [0, 5, 17]


def _padded(G, **kw):
    """rmat(7, 8, seed=3) re-built at n = 263 (= 2·128 + 7): padded tail
    parts on every mesh and isolated vertices whose parts keep an empty
    frontier every step."""
    base = G.rmat(7, 8, seed=3, weighted=True, **kw)
    se, de = G.edge_list(base)
    vals = base.edge_values
    vals = np.asarray(vals.cpu() if hasattr(vals, "cpu") else vals)
    return G.from_edge_list(se, de, n=base.num_vertices * 2 + 7,
                            values=vals, **kw)


def _mesh(shape):
    return Mesh.on("cpu", shape, ("graph",) if len(shape) == 1
                   else ("row", "col"))


def _part(tg, shape):
    return (partition_1d(tg, shape[0]) if len(shape) == 1
            else partition_2d(tg, *shape))


@pytest.fixture(scope="module")
def padded():
    jg, tg = _padded(JG), _padded(TG, device="cpu")
    src = int(np.argmax(np.diff(np.asarray(jg.row_offsets))))
    want = {"bfs": np.asarray(jbfs(jg, src).labels),
            "sssp": np.asarray(jsssp(jg, src).dist),
            "cc": jcc(jg),
            "lp": np.asarray(jlp(jg, max_iter=8).labels),
            "reach": np.asarray(jreach_batch(jg, SRCS, 3).reached),
            "pagerank": np.asarray(jpagerank(jg, max_iter=12).rank),
            "port_pagerank": pagerank(tg, max_iter=12).rank}
    return jg, tg, src, want


SHAPES = [(2,), (4,), (8,), (2, 2), (2, 4), (1, 4), (4, 1)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_distributed_primitives_bit_equal_to_single_device(padded, shape):
    jg, tg, src, want = padded
    pg, mesh = _part(tg, shape), _mesh(shape)
    r = D.distributed_bfs(pg, src, mesh)
    assert np.array_equal(r.labels.numpy(), want["bfs"])
    # the isolated tail is unreachable: its parts never see a frontier
    assert want["bfs"][128:].max() < 0
    assert np.array_equal(D.distributed_sssp(pg, src, mesh).dist.numpy(),
                          want["sssp"])
    c = D.distributed_cc(pg, mesh)
    assert np.array_equal(c.labels.numpy(), np.asarray(want["cc"].labels))
    assert c.num_components == int(want["cc"].num_components)
    rank = D.distributed_pagerank(pg, mesh, iters=12)
    assert torch.equal(rank, want["port_pagerank"])
    np.testing.assert_allclose(rank.numpy(), want["pagerank"], rtol=0,
                               atol=1e-6)
    assert np.array_equal(
        D.distributed_label_propagation(pg, mesh, max_iter=8).labels
        .numpy(), want["lp"])
    assert np.array_equal(
        D.distributed_reach(pg, SRCS, 3, mesh=mesh).reached.numpy(),
        want["reach"])


@pytest.fixture(scope="module")
def linalg_pair():
    jg = JG.rmat(7, 8, seed=2, weighted=True)
    tg = TG.rmat(7, 8, seed=2, weighted=True, device="cpu")
    rng = np.random.default_rng(0)
    n = tg.num_vertices
    return (jg, tg, rng.random(n).astype(np.float32),
            rng.random((n, 5)).astype(np.float32), rng.random(n) > 0.4)


@pytest.mark.parametrize("shape", [(4,), (2, 4), (2, 2)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("srn", ["plus_times", "min_plus", "or_and",
                                 "max_min", "plus_and"])
def test_placement_spmv_spmm_bit_equal(linalg_pair, shape, srn):
    """The 1-D row fold and the 2-D pre-fold product exchange give the
    single-device bits for every semiring, masked and complemented."""
    jg, tg, x, X, mask = linalg_pair
    sg = _part(tg, shape).shard(_mesh(shape))
    want = np.asarray(JL.spmv(jg, x, semiring=srn, mask=mask))
    assert np.array_equal(TL.spmv(sg, x, semiring=srn, mask=mask).numpy(),
                          want)
    want = np.asarray(JL.spmm(jg, X, semiring=srn, mask=mask,
                              complement=True))
    assert np.array_equal(TL.spmm(sg, X, semiring=srn, mask=mask,
                                  complement=True).numpy(), want)
    if srn == "plus_times":
        assert np.array_equal(TL.spmv(sg, x, transpose=True).numpy(),
                              np.asarray(JL.spmv(jg, x, transpose=True)))


@pytest.mark.parametrize("shape", [(4,), (2, 4)],
                         ids=lambda s: "x".join(map(str, s)))
def test_placement_mxm_bit_equal(linalg_pair, shape):
    jg, tg, *_ = linalg_pair
    sg = _part(tg, shape).shard(_mesh(shape))
    se, de = JG.edge_list(jg)
    want = np.asarray(JL.mxm(jg, jg, (se, de), semiring=JL.plus_and,
                             b_transpose=True, structural=True))
    got = TL.mxm(sg, tg, (se, de), semiring=TL.plus_and, b_transpose=True,
                 structural=True)
    assert np.array_equal(got.numpy(), want)
    for srn in ("min_plus", "max_min"):
        assert np.array_equal(TL.mxm(sg, tg, (se, de), semiring=srn)
                              .numpy(),
                              np.asarray(JL.mxm(jg, jg, (se, de),
                                                semiring=srn)))
    with pytest.raises(ValueError, match="probe side"):
        TL.mxm(tg, sg, (se, de))
    with pytest.raises(ValueError, match="spmsv has no sharded"):
        TL.spmsv(sg, [0])


_REFERENCE_MESH_SCRIPT = textwrap.dedent("""
    import sys
    import numpy as np, jax
    from jax.sharding import Mesh
    from repro.core import graph as G
    from repro.core.partition import partition_1d, partition_2d
    from repro.core import distributed as D
    base = G.rmat(7, 8, seed=3, weighted=True)
    se, de = G.edge_list(base)
    g = G.from_edge_list(se, de, n=base.num_vertices * 2 + 7,
                         values=np.asarray(base.edge_values))
    src = int(np.argmax(np.diff(np.asarray(g.row_offsets))))
    delta = float(sys.argv[2])
    out = {}
    for name, pg, mesh in (
            ("p4", partition_1d(g, 4),
             Mesh(np.array(jax.devices()[:4]), ("graph",))),
            ("m22", partition_2d(g, 2, 2),
             Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                  ("row", "col")))):
        r = D.distributed_bfs(pg, src, mesh)
        s = D.distributed_sssp(pg, src, mesh, delta=delta)
        c = D.distributed_cc(pg, mesh)
        out.update({
            name + "_bfs": np.asarray(r.labels),
            name + "_bfs_it": int(r.iterations),
            name + "_sssp": np.asarray(s.dist),
            name + "_sssp_it": int(s.iterations),
            name + "_cc": np.asarray(c.labels),
            name + "_cc_n": int(c.num_components),
            name + "_cc_it": int(c.iterations),
            name + "_pr": np.asarray(D.distributed_pagerank(pg, mesh,
                                                            iters=12)),
            name + "_lp": np.asarray(D.distributed_label_propagation(
                pg, mesh, max_iter=8).labels),
            name + "_reach": np.asarray(D.distributed_reach(
                pg, [0, 5, 17], 3, mesh=mesh).reached)})
    np.savez(sys.argv[1], src=src, **out)
""")


def test_port_equals_reference_distributed_on_four_devices(tmp_path):
    """The reference's own distributed_* at p = 4 and 2×2 on four fake
    host devices: labels, distances, components and the step counts of
    every loop equal the port's, pagerank within C-ref-3's 1e-6."""
    out = tmp_path / "mesh.npz"
    delta = 0.75
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.run([sys.executable, "-c", _REFERENCE_MESH_SCRIPT,
                           str(out), repr(delta)], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    want = np.load(out)
    tg = _padded(TG, device="cpu")
    src = int(want["src"])
    for name, shape in (("p4", (4,)), ("m22", (2, 2))):
        pg, mesh = _part(tg, shape), _mesh(shape)
        r = D.distributed_bfs(pg, src, mesh)
        assert np.array_equal(r.labels.numpy(), want[name + "_bfs"])
        assert r.iterations == int(want[name + "_bfs_it"])
        s = D.distributed_sssp(pg, src, mesh, delta=delta)
        assert np.array_equal(s.dist.numpy(), want[name + "_sssp"])
        assert s.iterations == int(want[name + "_sssp_it"])
        c = D.distributed_cc(pg, mesh)
        assert np.array_equal(c.labels.numpy(), want[name + "_cc"])
        assert (c.num_components, c.iterations) == (
            int(want[name + "_cc_n"]), int(want[name + "_cc_it"]))
        np.testing.assert_allclose(
            D.distributed_pagerank(pg, mesh, iters=12).numpy(),
            want[name + "_pr"], rtol=0, atol=1e-6)
        assert np.array_equal(D.distributed_label_propagation(
            pg, mesh, max_iter=8).labels.numpy(), want[name + "_lp"])
        assert np.array_equal(D.distributed_reach(
            pg, SRCS, 3, mesh=mesh).reached.numpy(), want[name + "_reach"])


_X64_SCRIPT = textwrap.dedent("""
    import sys
    import jax
    jax.config.update("jax_enable_x64", True)
    import numpy as np
    from repro.core import graph as G
    from repro.core.primitives import bfs, pagerank, sssp
    g = G.rmat(7, 8, seed=5, weighted=True, index_dtype="int64")
    src = int(np.argmax(np.diff(np.asarray(g.row_offsets))))
    np.savez(sys.argv[1], src=src, labels=np.asarray(bfs(g, src).labels),
             dist=np.asarray(sssp(g, src).dist),
             rank=np.asarray(pagerank(g, max_iter=12).rank))
""")


def test_sharded_storage_plan_parity(tmp_path):
    """The twin of the reference's ``test_sharded_storage_plan_parity``:
    int32 and delta sources shard into dense int32 parts, and the
    distributed bfs / sssp equal the int64 single-device baseline (the
    reference's, run under jax_enable_x64 in a subprocess) bit for bit
    at 2 and 4 parts; pagerank equals the port's int64 single-device
    ranks bit for bit and the reference's within 1e-6."""
    out = tmp_path / "x64.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _X64_SCRIPT, str(out)],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    want = np.load(out)
    src = int(want["src"])
    g64 = TG.rmat(7, 8, seed=5, weighted=True, index_dtype="int64",
                  device="cpu")
    rank64 = pagerank(g64, max_iter=12).rank
    assert np.array_equal(bfs(g64, src).labels.numpy(), want["labels"])
    for kw in ({"index_dtype": "int32"}, {"encoding": "delta"}):
        g = TG.rmat(7, 8, seed=5, weighted=True, device="cpu", **kw)
        for p in (2, 4):
            pg, mesh = partition_1d(g, p), _mesh((p,))
            assert np.array_equal(
                D.distributed_bfs(pg, src, mesh).labels.numpy(),
                want["labels"]), (kw, p)
            assert np.array_equal(
                D.distributed_sssp(pg, src, mesh).dist.numpy(),
                want["dist"]), (kw, p)
            rank = D.distributed_pagerank(pg, mesh, iters=12)
            assert torch.equal(rank, rank64), (kw, p)
            np.testing.assert_allclose(rank.numpy(), want["rank"], rtol=0,
                                       atol=1e-6)


@pytest.mark.parametrize("tiles", [1, 2, 3])
def test_exchange_bytes_per_step_equal_reference(padded, tiles):
    jg, tg, *_ = padded
    for shape in SHAPES:
        a = (j_partition_1d(jg, shape[0]) if len(shape) == 1
             else j_partition_2d(jg, *shape))
        b = _part(tg, shape)
        for prim in ("bfs", "sssp", "cc", "pagerank"):
            assert D.exchange_bytes_per_step(b, prim, tiles) == \
                JD.exchange_bytes_per_step(a, prim, tiles), (shape, prim)
        with pytest.raises(ValueError, match="unknown primitive"):
            D.exchange_bytes_per_step(b, "reach")
    g = TG.rmat(7, 8, seed=3, device="cpu")
    assert D.exchange_bytes_per_step(partition_2d(g, 2, 2), "bfs") < \
        D.exchange_bytes_per_step(partition_1d(g, 4), "bfs")


def test_collectives_fold_in_part_order():
    parts = [torch.tensor([1.0, 2.0]), torch.tensor([1e8, -1e8]),
             torch.tensor([-1e8, 1e8])]
    # ((a + b) + c) in part order: the small terms vanish into 1e8
    assert torch.equal(D.all_reduce(parts, "sum")[0],
                       (parts[0] + parts[1]) + parts[2])
    assert torch.equal(D.all_reduce(parts, "min")[1],
                       torch.tensor([-1e8, -1e8]))
    assert torch.equal(D.all_gather([torch.tensor([1]), torch.tensor([2, 3])]
                                    )[1], torch.tensor([1, 2, 3]))
    grid = [torch.tensor([v]) for v in range(6)]        # 2 x 3 mesh
    rows = D.axis_all_reduce(grid, (2, 3), 0, "sum")    # over i
    cols = D.axis_all_reduce(grid, (2, 3), 1, "max")    # over j
    assert [int(t) for t in rows] == [3, 5, 7, 3, 5, 7]
    assert [int(t) for t in cols] == [2, 2, 2, 5, 5, 5]
    x = torch.arange(3)
    reps = D.replicate(x, [torch.device("cpu")] * 4)
    assert list(reps) == [torch.device("cpu")] and reps[
        torch.device("cpu")] is x


def test_cuda_backend_under_a_placement_needs_the_card(padded):
    jg, tg, src, _ = padded
    pg = partition_1d(tg, 2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        D.distributed_bfs(pg, src, _mesh((2,)), backend="cuda")
    with pytest.raises(ValueError, match="must match"):
        D.distributed_bfs(pg, src, _mesh((4,)))
