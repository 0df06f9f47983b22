"""The port's graph_run driver end to end on the CPU."""
import numpy as np
import pytest

from repro_torch.core import graph as G
from repro_torch.core import ref as R
from repro_torch.launch import graph_run
from repro_torch.linalg import ops as TL


def test_graph_run_validates_on_cpu(capsys):
    graph_run.main(["--scale", "8", "--primitives", "bfs,sssp,pagerank",
                    "--validate", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("PASS") == 3 and "FAIL" not in out
    assert "backend=torch" in out


def test_graph_run_batched_sources_on_grid(capsys):
    graph_run.main(["--graph", "grid", "--scale", "8", "--sources",
                    "0,17,200", "--validate", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("PASS") == 3


@pytest.mark.parametrize("sources", [None, "3,40,200"])
def test_graph_run_cc_bc_tc_validate_on_cpu(capsys, sources):
    argv = ["--scale", "8", "--primitives", "cc,bc,tc", "--validate",
            "--device", "cpu"]
    graph_run.main(argv + (["--sources", sources] if sources else []))
    out = capsys.readouterr().out.replace("[graph] ", "")
    assert out.count("PASS") == 3 and "FAIL" not in out
    for name in ("cc", "bc", "tc"):
        assert any(line.startswith(name) for line in out.splitlines())


@pytest.mark.parametrize("sources", [None, "3,40,200,3"])
def test_graph_run_reach_lp_wtf_on_cpu(capsys, sources):
    argv = ["--scale", "8", "--primitives", "reach,label_propagation,wtf",
            "--hops", "2", "--validate", "--device", "cpu"]
    graph_run.main(argv + (["--sources", sources] if sources else []))
    out = capsys.readouterr().out.replace("[graph] ", "")
    assert out.count("PASS") == 2 and "FAIL" not in out
    lines = {line.split()[0]: line for line in out.splitlines()[1:]}
    assert set(lines) == {"reach", "label_propagation", "wtf"}
    assert "PASS" not in lines["wtf"]           # as in the reference
    assert all("backend=torch" in line for line in lines.values())


def test_graph_run_rejects_unknown_primitive():
    with pytest.raises(ValueError, match="unknown primitive"):
        graph_run.main(["--scale", "6", "--primitives", "no_such_primitive",
                        "--device", "cpu"])


def test_graph_run_refuses_tc_beyond_int32(monkeypatch):
    """An expansion past int32 is refused by mxm's plan before anything
    is launched; graph_run names the capacity and the largest rmat
    scale that fits."""
    plan = TL.mxm_plan
    monkeypatch.setattr(TL, "mxm_plan",
                        lambda *a, **k: (*plan(*a, **k)[:-1], 4_600_000_000))
    with pytest.raises(SystemExit,
                       match=r"4,600,000,000 expansion slots.*scale 19"):
        graph_run.main(["--scale", "6", "--primitives", "tc",
                        "--device", "cpu"])


def test_pagerank_check_is_per_vertex_relative():
    """The old check, allclose(atol=1e-6), passes ranks 3 % off on every
    vertex ranked below 3e-5 — two thirds of them at rmat scale 14,
    where ranks average 1/n = 6.1e-5; the per-vertex relative limit that
    graph_run and chip_smoke.py share refuses them."""
    g = G.rmat(14, 16, seed=0, weighted=True, device="cpu")
    want = R.pagerank_ref(g, iters=20)
    low = want < 3e-5
    assert low.mean() > 0.6
    wrong = np.where(low, want * np.float32(0.97), want)
    assert np.allclose(wrong, want, atol=1e-6)          # the old check
    assert R.pagerank_rel_err(wrong, want) > R.PR_RTOL  # the new one
    assert R.pagerank_rel_err(want, want) == 0.0
    assert R.pagerank_rel_err(want[:-1], want) == float("inf")
    bad = want.copy()
    bad[3] = np.nan
    assert R.pagerank_rel_err(bad, want) == float("inf")


@pytest.mark.parametrize("graph", ["rgg", "rmat"])
def test_graph_run_stats_and_trace(capsys, tmp_path, graph):
    """--stats prints each primitive's telemetry table (the frontier
    column of bfs is the level sizes); --trace writes the spans."""
    trace = tmp_path / "trace.json"
    graph_run.main(["--graph", graph, "--scale", "7", "--primitives",
                    "bfs,sssp,pagerank,cc,bc,tc,reach", "--validate",
                    "--stats", "--trace", str(trace), "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("PASS") == 7 and "FAIL" not in out
    for name in ("bfs", "sssp", "pagerank", "cc", "bc", "tc"):
        assert f"[graph] {name} per-iteration trajectory:" in out
    assert "reach per-iteration" not in out          # no telemetry hook
    lines = out.splitlines()
    head = lines.index("[graph] bfs per-iteration trajectory:") + 1
    assert lines[head].split() == ["iter", "direction", "frontier",
                                   "overflow", "tier"]
    g = graph_run.make_graph(graph, 7, 16, 0, device="cpu")
    src = int(np.argmax(np.diff(g.row_offsets.numpy())))
    depth = R.bfs_ref(g, src)
    rows = []
    for line in lines[head + 1:]:
        if not line.startswith("  "):
            break
        rows.append(int(line.split()[2]))
    assert rows == list(np.bincount(depth[depth >= 0])[1:]) + [0]
    import json
    names = [e["name"] for e in json.loads(trace.read_text())["traceEvents"]]
    assert names[0] == "build_graph" and "run:bfs" in names
    assert "stats:tc" in names


def test_graph_run_rgg_matches_reference_generator():
    import math

    from repro.core import graph as JG
    g = graph_run.make_graph("rgg", 8, 16, 3, device="cpu")
    jg = JG.random_geometric(256, math.sqrt(8.0 / 256), seed=3,
                             weighted=True)
    assert np.array_equal(g.col_indices.numpy(), np.asarray(jg.col_indices))
    assert np.array_equal(g.edge_values.numpy(), np.asarray(jg.edge_values))


def test_warn_overflow(capsys):
    """The reference's warning, word for word, only when a lane dropped
    discoveries; its total over the lanes."""
    import torch
    graph_run._warn_overflow(torch.zeros(3, dtype=torch.int32))
    assert "overflow" not in capsys.readouterr().out
    graph_run._warn_overflow(torch.tensor([0, 118, 4], dtype=torch.int32))
    out = capsys.readouterr().out
    assert ("bfs dropped 122 frontier entries (overflow); rerun with "
            "idempotence=False") in out
