"""The benchmark is driven by files: a new configuration, mix or metric
is a new file; and BENCHMARK.json keeps to the benchmark contract."""
import json
import re

import pbtest_util as U

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_new_config_mix_and_metric_are_files_only(tmp_path):
    root = U.tiny_root(tmp_path)
    bench = root / "portbench"
    (bench / "traffic" / "bfs-only.json").write_text(json.dumps(
        {"loop": "closed_saturated", "batch": 4, "chunk": {"bfs": 8},
         "hops": 3, "sample": {"bfs": 1}}))
    cfg = json.loads((bench / "configs" / "tiny.json").read_text())
    cfg["params"].update(scale=6, A=0.65, B=0.15, C=0.15)
    (bench / "configs" / "tiny-web.json").write_text(json.dumps(cfg))
    (bench / "metrics" / "flushes_per_s.py").write_text(
        "def read(rec):\n    return len(rec['flushes']) / rec['window_s']\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny-web", "source": "test",
                            "file": "portbench/configs/tiny-web.json",
                            "reduced": ["scale"], "why": "test"})
    spec["workloads"].append({"name": "tiny-web.bfs-only",
                              "config": "tiny-web", "traffic": "bfs-only",
                              "chips": 1, "why": "test"})
    spec["per_layer"].append({"name": "flushes_per_s", "unit": "1/s",
                              "better": "higher", "source": "program_span",
                              "layer": "serving", "moves": "qps",
                              "workloads": ["tiny-web.bfs-only"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    r = U.run(root, "tiny-web.bfs-only", traced=True)
    assert r["correct"] is True
    assert r["metrics"]["flushes_per_s"]["value"] > 0
    assert r["checks"]["bfs_queries_compared"]["value"] == 4


def test_benchmark_json_keeps_to_the_contract():
    b = json.loads((U.REPO / "BENCHMARK.json").read_text())
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"] and 1 <= b["run_seconds"] <= 51
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        assert (U.REPO / c["file"]).is_file()
        assert set(c["reduced"]) == set(json.loads(
            (U.REPO / c["file"]).read_text())["reduced"])
        names.add(c["name"])
    used = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (U.BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        used.add(w["config"])
    assert used == names
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in b["workloads"]}
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert (U.BENCH / "metrics" / f"{m['name']}.py").is_file()
        assert set(m.get("workloads", cells)) <= cells
    for m in b["per_layer"]:
        assert m["moves"] in e2e
    for thing in b["configs"] + b["workloads"]:
        assert NAME.match(thing["name"])
    assert len(json.dumps(b)) < 64 * 1024
