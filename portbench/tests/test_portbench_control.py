"""The comparison that decides ``correct`` fails what it must: the
control (the plain reference put in the program's place, stopped one
round short) and faults planted in the timed path. Each run skips the
harness's look for a card and drives the rest of a run on the CPU."""
import pytest
import torch

import pbtest_util as U
from pb import spec
from repro_torch.launch import graph_serve as gs


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return U.tiny_root(tmp_path_factory.mktemp("pb"))


CONTROL = spec.load_module(U.BENCH / "control.py", "portbench_control")


@pytest.mark.parametrize("cell", ["tiny.traverse", "tiny.reach"])
@pytest.mark.parametrize("rounds_short", [0, 1])
def test_control_fails_and_reference_passes(root, cell, rounds_short):
    """control.py's run: the reference in the program's place, through
    the harness's own run and comparison."""
    r = CONTROL.control_run(spec.load_cell(root, cell), U.SEED, 0.2, "cpu",
                            rounds_short)
    assert r["correct"] is (rounds_short == 0)
    wrong = sum(c["value"] for k, c in r["checks"].items()
                if k.endswith("_wrong_entries"))
    assert (wrong > 0) is (rounds_short == 1)


def altered(result):
    """An answer altered where it is produced: lane 0, vertex 0."""
    field = result[0].clone()
    field[0, 0] = ~field[0, 0] if field.dtype == torch.bool else \
        field[0, 0] + 1
    return result._replace(**{result._fields[0]: field})


def half_batch(run):
    """Half of the batch left out: the first half's answers stand in for
    the rest."""
    def fault(g, srcs, *args, **kwargs):
        half = run(g, srcs[:len(srcs) // 2], *args, **kwargs)
        field = half[0]
        return half._replace(**{half._fields[0]: torch.cat([field, field])})
    return fault


@pytest.mark.parametrize("cell,prim", [("tiny.traverse", "bfs_batch"),
                                       ("tiny.traverse", "sssp_batch"),
                                       ("tiny.reach", "reach_batch")])
@pytest.mark.parametrize("fault", ["altered", "half_batch"])
def test_planted_fault_is_not_correct(root, monkeypatch, cell, prim, fault):
    run = getattr(gs, prim)
    if fault == "altered":
        monkeypatch.setattr(gs, prim, lambda *a, **k: altered(run(*a, **k)))
    else:
        monkeypatch.setattr(gs, prim, half_batch(run))
    r = U.run(root, cell)
    assert r["correct"] is False
    kind = prim.split("_")[0]
    assert r["checks"][f"{kind}_wrong_entries"]["value"] > 0
