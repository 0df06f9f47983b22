"""A tiny cell end to end on the CPU: both mixes, untraced and traced,
and the lines a run prints."""
import io
import json
import subprocess
import sys

import pytest

import pbtest_util as U

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return U.tiny_root(tmp_path_factory.mktemp("pb"))


@pytest.mark.parametrize("mix", ["traverse", "reach"])
@pytest.mark.parametrize("traced", [False, True])
def test_tiny_cell_runs_and_is_correct(root, mix, traced):
    r = U.run(root, f"tiny.{mix}", traced)
    assert list(r)[:5] == KEYS and list(r)[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0
    assert r["attempted"] > 0
    assert r["device"]["platform"] == "cpu"
    if traced:
        # no device here: the device-trace metrics find nothing to read
        assert set(r["metrics"]) == {"build_s", "copy_share",
                                     "host_reads_per_flush"}
        assert {"busy_s", "window_s"} <= set(r["device"])
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(r["metrics"]) == {"qps", "p95_ms", "setup_s"}
        assert all(m["value"] > 0 for m in r["metrics"].values())
    kinds = {"traverse": ("bfs", "sssp"), "reach": ("reach",)}[mix]
    for kind in kinds:
        assert r["checks"][f"{kind}_wrong_entries"] == {"value": 0, "max": 0}
        assert r["checks"][f"{kind}_queries_compared"]["value"] >= 1


def test_report_prints_the_contract_line(root):
    import run as R
    r = U.run(root, "tiny.reach")
    out, err = io.StringIO(), io.StringIO()
    R.report(r, out, err)
    lines = out.getvalue().splitlines()
    assert lines[-2].startswith("imports: no module of flax, jax, jaxlib, "
                                "repro")
    assert json.loads(lines[-1]) == json.loads(json.dumps(r))
    tail = err.getvalue().splitlines()
    assert tail[-1].startswith("check answers_unmatched = 0 (max 0)")


@pytest.fixture
def no_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the CLI would run the cell")


def test_cli_refuses_without_a_card(no_card):
    """No CUDA device here: a non-zero exit and no result line."""
    p = subprocess.run([sys.executable, str(U.BENCH / "run.py"),
                        "--workload", "graph500-22.traverse", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=U.REPO,
                       timeout=120)
    assert p.returncode != 0
    assert '"correct"' not in p.stdout
