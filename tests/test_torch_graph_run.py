"""The port's graph_run driver end to end on the CPU."""
import pytest

from repro_torch.launch import graph_run


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


def test_graph_run_rejects_unknown_primitive():
    with pytest.raises(ValueError, match="unknown primitive"):
        graph_run.main(["--scale", "6", "--primitives", "tc",
                        "--device", "cpu"])
