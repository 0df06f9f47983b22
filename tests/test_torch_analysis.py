"""The port's analysis layer (``repro_torch.analysis``) on the CPU: every
lint rule, contract rule and sanitizer fires on a seeded bug and stays
silent on the shipped tree and healthy calls — the twin of
tests/test_analysis.py, re-derived for PyTorch and the hand-written
kernels — plus parity with the reference (the registry's rows and
declared fallbacks, the compile budgets, the rule IDs).

  * reprolint: one seeded violation per rule (RL001-RL006) through
    ``lint_source``, the suppression syntax, the BSP-step discovery, and
    the shipped-tree-green invariant (the library, tools/ and
    chip_smoke.py);
  * registry contracts: the real provider matrix passes CT001-CT006;
    seeded corruptions surface the right finding; misses raise the
    structured ``ProviderMissError``;
  * set-up counter: one fixed configuration of each of the six
    primitives stays inside its budget; a churning graph fires;
  * launch audit: every one of the 11 launch sites of
    ``kernels/ops.py`` audited clean on CPU tensors built as its wrapper
    builds them, and each fault class (out-of-bounds, write-write race,
    rank or dtype mismatch) seeded into each site raises ``MemoryFault``
    — through ``_launch`` before the C call is reached.
"""
import ctypes
import math

import numpy as np
import pytest
import torch

from repro.analysis import budgets as JBUD
from repro.analysis import lint as JLINT
from repro.analysis.contracts import PROVIDER_MODULES as J_PROVIDERS
from repro.core import backend as JB
from repro_torch.analysis import budgets, sanitize
from repro_torch.analysis.contracts import (PRIMITIVES, PROVIDER_MODULES,
                                            check_registry, matrix)
from repro_torch.analysis.lint import RULES, lint_paths, lint_source
from repro_torch.core import backend as B
from repro_torch.core import enactor
from repro_torch.core import graph as G
from repro_torch.core.primitives import (bc, bfs, bfs_batch,
                                         connected_components, pagerank,
                                         sssp, triangle_count)
from repro_torch.kernels import ops as K
from repro_torch.linalg import semiring as SR

CPU = torch.device("cpu")


# ---- reprolint: seeded true positives ------------------------------------

# a BSP step: the body handed to the enactor's loop
STEP = ("from repro_torch.core.enactor import run_until\n"
        "def f(state):\n"
        "    def body(st):\n")
LOOP = "    return run_until(lambda st: st.n > 0, body, state, 8)\n"


def rules_of(findings):
    return {f.rule for f in findings}


def test_rl001_item_in_step():
    src = STEP + "        k = st.x.sum().item()\n        return st\n" + LOOP
    assert "RL001" in rules_of(lint_source(src))


def test_rl001_int_cast_in_step():
    src = STEP + "        k = int(st.x.sum())\n        return st\n" + LOOP
    assert "RL001" in rules_of(lint_source(src))


def test_rl001_reaches_helpers_a_step_calls():
    src = ("from repro_torch.core.enactor import run_until_any\n"
           "def helper(x):\n"
           "    return x.cpu()\n"
           "def f(state):\n"
           "    def body(st, active, params):\n"
           "        return helper(st)\n"
           "    return run_until_any(lambda s: s, lambda s: s, body=body,\n"
           "                         state=state, max_iter=4)\n")
    found = lint_source(src)
    assert [f.line for f in found if f.rule == "RL001"] == [3]


def test_rl001_enactor_read_is_the_declared_exception():
    src = STEP + ("        flags = _read(st.x.sum(dtype=torch.int32))\n"
                  "        return st\n") + LOOP
    assert "RL001" not in rules_of(lint_source(src))
    # the same read outside a step is no finding either
    assert lint_source("def g(t):\n    return t.tolist()\n") == []


def test_rl002_python_branch_on_tensor():
    src = STEP + ("        if st.x.any():\n            return st\n"
                  "        return st\n") + LOOP
    assert "RL002" in rules_of(lint_source(src))


def test_rl002_python_loop_over_tensor():
    src = STEP + ("        for v in st.x.nonzero():\n            pass\n"
                  "        return st\n") + LOOP
    assert "RL002" in rules_of(lint_source(src))


def test_rl003_unpinned_int_sum():
    src = ("import torch\n"
           "def f(m):\n"
           "    k = m.to(torch.int32)\n"
           "    return torch.sum(k)\n")
    assert "RL003" in rules_of(lint_source(src))
    # the method form over a comparison (a bool sum is int64)
    src = "def f(x):\n    return (x > 0).sum()\n"
    assert "RL003" in rules_of(lint_source(src))


def test_rl003_pinned_is_clean():
    src = ("import torch\n"
           "def f(m):\n"
           "    k = m.to(torch.int32)\n"
           "    a = torch.sum(k, dtype=torch.int32)\n"
           "    b = (m > 0).sum(dim=0, dtype=torch.int32)\n"
           "    return a, b, (m > 0).sum().to(torch.int32)\n")
    assert "RL003" not in rules_of(lint_source(src))


def test_rl004_unfenced_timing():
    src = ("import time\n"
           "def f(step):\n"
           "    t0 = time.monotonic()\n"
           "    y = step()\n"
           "    return time.monotonic() - t0\n")
    assert "RL004" in rules_of(lint_source(src))


def test_rl004_fenced_is_clean():
    src = ("import time, torch\n"
           "def f(step):\n"
           "    t0 = time.monotonic()\n"
           "    y = step()\n"
           "    torch.cuda.synchronize()\n"
           "    return time.monotonic() - t0\n")
    assert "RL004" not in rules_of(lint_source(src))
    # a host read and a same-file helper that synchronizes fence too
    src = ("import time, torch\n"
           "def _sync():\n"
           "    torch.cuda.synchronize()\n"
           "def f(step):\n"
           "    t0 = time.monotonic()\n"
           "    _sync()\n"
           "    return time.monotonic() - t0\n"
           "def g(step):\n"
           "    t0 = time.monotonic()\n"
           "    n = step().item()\n"
           "    return time.monotonic() - t0\n")
    assert "RL004" not in rules_of(lint_source(src))


def test_rl005_bare_print_in_lib():
    src = "def f():\n    print('hi')\n"
    assert "RL005" in rules_of(lint_source(src, lib=True))
    # the rule is library-scoped: scripts and tools are exempt
    assert "RL005" not in rules_of(lint_source(src, lib=False))
    assert "RL005" in rules_of(lint_source(
        src, "src/repro_torch/x.py"))
    assert "RL005" not in rules_of(lint_source(src, "tools/x.py"))


def test_rl006_bare_except_swallows():
    src = ("def f(step):\n"
           "    try:\n"
           "        step()\n"
           "    except:\n"
           "        pass\n")
    assert "RL006" in rules_of(lint_source(src))


def test_rl006_broad_except_trivial_body():
    for body in ("pass", "..."):
        src = ("def f(step):\n"
               "    try:\n"
               "        step()\n"
               f"    except Exception:\n        {body}\n")
        assert "RL006" in rules_of(lint_source(src)), body
    src = ("def f(steps):\n"
           "    for s in steps:\n"
           "        try:\n"
           "            s()\n"
           "        except BaseException:\n"
           "            continue\n")
    assert "RL006" in rules_of(lint_source(src))


def test_rl006_handled_or_narrow_is_clean():
    src = ("def f(step, log):\n"
           "    try:\n"
           "        return step()\n"
           "    except Exception as e:\n"
           "        log.error(e)\n"
           "        return None\n")
    assert "RL006" not in rules_of(lint_source(src))
    src = ("def f(step):\n"
           "    try:\n"
           "        step()\n"
           "    except ValueError:\n"
           "        pass\n")
    assert "RL006" not in rules_of(lint_source(src))
    src = ("def f(step, undo):\n"
           "    try:\n"
           "        step()\n"
           "    except:\n"
           "        undo()\n"
           "        raise\n")
    assert "RL006" not in rules_of(lint_source(src))


def test_rl006_declared_boundary_suppresses():
    src = ("def f(step):\n"
           "    try:\n"
           "        step()\n"
           "    except Exception:  "
           "# reprolint: disable=RL006 -- probe boundary\n"
           "        pass\n")
    assert lint_source(src) == []


def test_syncs_outside_a_step_are_no_finding():
    src = ("import torch\n"
           "def f(x):\n"
           "    if x.any():\n"
           "        return int(x.sum(dtype=torch.int32))\n"
           "    return x.max().item()\n")
    assert lint_source(src) == []


def test_every_rule_has_a_seeded_test():
    assert set(RULES) == {"RL001", "RL002", "RL003", "RL004", "RL005",
                          "RL006"}


def test_rule_ids_and_suppression_syntax_match_the_reference():
    assert set(RULES) == set(JLINT.RULES)
    src = "def f():\n    print('x')  # reprolint: disable=RL005 -- CLI\n"
    assert lint_source(src, lib=True) == []
    assert JLINT.lint_source(src, lib=True) == []


# ---- reprolint: suppression syntax ---------------------------------------

def test_suppress_same_line():
    src = "def f():\n    print('x')  # reprolint: disable=RL005 -- CLI\n"
    assert lint_source(src, lib=True) == []


def test_suppress_line_above():
    src = ("def f():\n"
           "    # reprolint: disable=RL005 -- CLI output\n"
           "    print('x')\n")
    assert lint_source(src, lib=True) == []


def test_suppress_bare_disables_all():
    src = "def f():\n    print('x')  # reprolint: disable\n"
    assert lint_source(src, lib=True) == []


def test_suppress_wrong_rule_does_not_silence():
    src = "def f():\n    print('x')  # reprolint: disable=RL001\n"
    assert "RL005" in rules_of(lint_source(src, lib=True))


def test_skip_file():
    src = "# reprolint: skip-file\ndef f():\n    print('x')\n"
    assert lint_source(src, lib=True) == []


def test_shipped_tree_is_lint_clean():
    # the library lints as library code; tools/ and chip_smoke.py as
    # scripts (RL005 off)
    assert lint_paths(["src/repro_torch", "tools", "chip_smoke.py"]) == []


@pytest.mark.parametrize("args,rc", [
    (["src/repro_torch", "tools", "chip_smoke.py"], 0),
    (["--select", "RL005", "--statistics", "src/repro_torch"], 0)])
def test_lint_cli_exit_codes(args, rc, tmp_path, capsys):
    from repro_torch.analysis import lint
    assert lint.main(args) == rc
    bad = tmp_path / "src" / "repro_torch" / "bad.py"
    bad.parent.mkdir(parents=True)
    bad.write_text("def f():\n    print('x')\n")
    assert lint.main([str(bad), "--json"]) == 1
    assert '"RL005"' in capsys.readouterr().out


# ---- registry contracts --------------------------------------------------

def test_real_registry_passes_contracts():
    assert check_registry() == []


def test_contracts_cli_exit_code(capsys):
    from repro_torch.analysis import contracts
    assert contracts.main([]) == 0
    assert "0 contract finding(s)" in capsys.readouterr().out
    assert contracts.main(["--matrix"]) == 0


def test_matrix_renders_every_op():
    out = matrix()
    for op in ("advance", "advance_filter", "spmv", "mxm"):
        assert op in out
    assert "(declared)" in out        # advance_filter's sharded hole
    assert "(route)" in out           # cuda under a placement


def test_seeded_ct001_undeclared_hole(monkeypatch):
    monkeypatch.setitem(B._REGISTRY, ("fakeop", B.TORCH, B.SHARDED),
                        lambda: None)
    monkeypatch.setitem(B._ENCODINGS, ("fakeop", B.TORCH, B.SHARDED),
                        ("dense",))
    found = [f for f in check_registry() if f.rule == "CT001"]
    assert any("fakeop" in f.key for f in found)


def test_seeded_ct002_missing_dense(monkeypatch):
    check_registry()                  # every provider module loaded first
    key = ("advance", B.TORCH, B.SINGLE)
    assert key in B._ENCODINGS
    monkeypatch.setitem(B._ENCODINGS, key, ("delta",))
    found = [f for f in check_registry() if f.rule == "CT002"]
    assert any("advance/torch/single" == f.key for f in found)


def test_seeded_ct003_primitive_without_telemetry(monkeypatch):
    monkeypatch.setitem(PRIMITIVES, "cc", ("repro_torch.core.primitives.cc",
                                           "_pointer_jump"))
    found = [f for f in check_registry() if f.rule == "CT003"]
    assert [f.key for f in found] == ["cc"]


def test_seeded_ct004_aliased_single_callable(monkeypatch):
    check_registry()                  # every provider module loaded first
    single = B._REGISTRY[("advance", B.TORCH, B.SINGLE)]
    monkeypatch.setitem(B._REGISTRY, ("advance", B.TORCH, B.TWOD), single)
    found = [f for f in check_registry() if f.rule == "CT004"]
    assert any(f.key == "advance/torch/2d" for f in found)


def test_seeded_ct004_route_that_lands_on_single(monkeypatch):
    # a lookup that drops a placement miss to the single provider
    real = B._lookup

    def leaky(op, backend, placement=B.SINGLE):
        try:
            return real(op, backend, placement)
        except B.ProviderMissError:
            return real(op, backend, B.SINGLE)

    monkeypatch.setattr(B, "_lookup", leaky)
    found = [f for f in check_registry() if f.rule == "CT004"]
    assert any(f.key == "compact/cuda/sharded" for f in found)


def test_seeded_ct005_cuda_without_torch_twin(monkeypatch):
    monkeypatch.setitem(B._REGISTRY, ("fakeop", B.CUDA, B.SINGLE),
                        lambda: None)
    monkeypatch.setitem(B._ENCODINGS, ("fakeop", B.CUDA, B.SINGLE),
                        ("dense",))
    found = [f for f in check_registry() if f.rule == "CT005"]
    assert [f.key for f in found] == ["fakeop/cuda/single"]


def test_seeded_ct006_primitive_without_budget(monkeypatch):
    monkeypatch.delitem(budgets.COMPILE_BUDGETS, "tc")
    found = [f for f in check_registry() if f.rule == "CT006"]
    assert [f.key for f in found] == ["tc"]


def test_register_rejects_unknown_encoding():
    with pytest.raises(ValueError, match="unknown storage encoding"):
        B.register("x", B.TORCH, encodings=("zstd",))


def test_provider_miss_is_structured():
    with pytest.raises(B.ProviderMissError) as ei:
        B.dispatch("compact", B.CUDA, B.SHARDED)
    err = ei.value
    assert isinstance(err, KeyError)
    # the cuda backend under a placement looks up the torch provider
    assert (err.op, err.backend, err.placement) == \
        ("compact", B.TORCH, B.SHARDED)
    msg = str(err)
    assert "compact" in msg and "sharded" in msg and "single" in msg


def test_provider_miss_on_an_unknown_op_is_structured():
    with pytest.raises(B.ProviderMissError) as ei:
        B.dispatch("advanse", B.TORCH, B.SINGLE)
    err = ei.value
    assert (err.op, err.backend, err.placement) == \
        ("advanse", B.TORCH, B.SINGLE)
    assert "registered (backend, placement) for this op: []" in str(err)


def test_declare_fallback_requires_reason():
    with pytest.raises(ValueError):
        B.declare_fallback("advance", B.SHARDED, reason="")
    assert B.declared_fallback("advance_filter", B.SHARDED)
    assert B.declared_fallback("advance", B.SHARDED) is None


# ---- parity with the reference -------------------------------------------

_RENAME = {JB.XLA: B.TORCH, JB.PALLAS: B.CUDA}


def test_registry_rows_match_the_reference():
    """The same (op, backend, placement) rows with the same encodings,
    xla↔torch and pallas↔cuda, and the same declared fallbacks: no
    exception is needed."""
    import importlib
    for mod in J_PROVIDERS:
        importlib.import_module(mod)
    check_registry()                  # loads every port provider module
    ref = {(op, _RENAME[bk], pl): tuple(JB._ENCODINGS[(op, bk, pl)])
           for (op, bk, pl) in JB._REGISTRY}
    port = {k: tuple(B._ENCODINGS[k]) for k in B._REGISTRY}
    assert port == ref
    assert B.declared_fallbacks() == JB._DECLARED_FALLBACKS
    assert [m.replace("repro_torch.", "repro.") for m in PROVIDER_MODULES] \
        == list(J_PROVIDERS)


def test_budgets_match_the_reference():
    assert budgets.COMPILE_BUDGETS == JBUD.COMPILE_BUDGETS


# ---- set-up (retrace) counter --------------------------------------------

def test_trace_probe_counts():
    c0 = sanitize.trace_count("probe_unit_test")
    sanitize.trace_probe("probe_unit_test")
    assert sanitize.trace_count("probe_unit_test") == c0 + 1


def test_setup_probe_counts_new_keys_and_built_setup():
    cache = {}
    name = "setup_unit_test"
    c0 = sanitize.trace_count(name)
    with sanitize.setup_probe(name, cache, (4,)):
        pass                            # a new configuration: one trace
    with sanitize.setup_probe(name, cache, (4,)):
        pass                            # warm: none
    assert sanitize.trace_count(name) == c0 + 1
    with sanitize.setup_probe(name, cache, (4,)):
        sanitize.note_setup()           # set-up rebuilt on a warm key
    with sanitize.setup_probe(name, cache, (8,)):
        pass                            # a new batch width
    assert sanitize.trace_count(name) == c0 + 3
    sanitize.note_setup()               # outside a scope: nothing


def test_retrace_guard_fires_on_setup_churn():
    with pytest.raises(sanitize.RetraceError, match="seeded_retrace"):
        with sanitize.retrace_guard("seeded_retrace", budget=1):
            for k in range(3):          # 3 fresh caches -> 3 traces
                with sanitize.setup_probe("seeded_retrace", {}, (k,)):
                    pass


def test_retrace_guard_clean_and_reports():
    cache = {}
    with sanitize.retrace_guard("clean_retrace", budget=1) as rep:
        for _ in range(5):
            with sanitize.setup_probe("clean_retrace", cache, ()):
                pass
    assert rep["traces"] == 1


def test_budget_pins():
    assert budgets.COMPILE_BUDGETS == {
        "bfs": 1, "sssp": 1, "pagerank": 1, "cc": 1, "bc": 2, "tc": 1}
    with pytest.raises(KeyError, match="no compile budget"):
        budgets.budget_for("nope")


def test_primitive_probes_wired_and_within_budget():
    """Each of the six primitives opens a set-up scope: its first call on
    a graph counts, and one fixed configuration stays inside its
    declared budget across repeat calls."""
    g = G.rmat(6, 4, seed=31, weighted=True, device=CPU)
    calls = {
        "bfs": lambda: bfs(g, 0),
        "sssp": lambda: sssp(g, 0),
        "pagerank": lambda: pagerank(g, max_iter=4),
        "cc": lambda: connected_components(g),
        "bc": lambda: bc(g, 0),
        "tc": lambda: triangle_count(g),
    }
    assert set(calls) == set(PRIMITIVES)
    for name, call in calls.items():
        c0 = sanitize.trace_count(name)
        call()                                      # warm the cache
        assert sanitize.trace_count(name) == c0 + 1, name
        with sanitize.retrace_guard(name) as rep:   # declared budget
            call()
            call()
        assert rep["traces"] == 0, name


def test_bc_sweep_counts_one_batch_width():
    g = G.rmat(5, 4, seed=3, device=CPU)
    c0 = sanitize.trace_count("bc")
    with sanitize.retrace_guard("bc"):
        r = bc(g, chunk=12)            # 32 roots: 12, 12 and a padded 8
        bc(g, chunk=12)
    assert r.chunks == 3
    assert sanitize.trace_count("bc") == c0 + 1


def test_new_batch_width_and_fresh_graph_fire():
    g = G.rmat(6, 4, seed=5, device=CPU)
    bfs_batch(g, [0, 1])
    c0 = sanitize.trace_count("bfs")
    bfs_batch(g, [2, 3])                # same width: warm
    assert sanitize.trace_count("bfs") == c0
    bfs_batch(g, [0, 1, 2])             # a new batch width
    assert sanitize.trace_count("bfs") == c0 + 1
    with pytest.raises(sanitize.RetraceError, match="bfs"):
        with sanitize.retrace_guard("bfs"):
            for seed in range(3):       # a fresh graph per query
                bfs(G.rmat(6, 4, seed=seed, device=CPU), 0)


def test_serving_loop_within_budget_and_churn_fires():
    """A warm serve_mixed stream (bfs / sssp / pagerank, batch 4) stays
    within every kind's budget; a query on a freshly built graph each
    time fires."""
    from repro_torch.launch import graph_serve
    g = G.rmat(7, 8, seed=0, weighted=True, device=CPU)
    kinds = ("bfs", "sssp", "pagerank")
    stream = [(k, i % g.num_vertices)
              for i, k in enumerate(kinds * 4)]
    graph_serve.serve_mixed(g, stream[:3], batch=4, backend="torch")
    with sanitize.retrace_guard("bfs") as rb, \
            sanitize.retrace_guard("sssp") as rs, \
            sanitize.retrace_guard("pagerank") as rp:
        stats = graph_serve.serve_mixed(g, stream, batch=4, backend="torch")
    assert stats["status_counts"]["ok"] == len(stream)
    assert (rb["traces"], rs["traces"], rp["traces"]) == (0, 0, 0)
    with pytest.raises(sanitize.RetraceError, match="bfs"):
        with sanitize.retrace_guard("bfs"):
            for seed in range(3):
                graph_serve.serve_mixed(
                    G.rmat(7, 8, seed=seed + 1, weighted=True, device=CPU),
                    [("bfs", 0)], batch=4, backend="torch")


def test_env_var_enables_sanitizer(monkeypatch):
    monkeypatch.setenv(sanitize.ENV_VAR, "1")
    assert sanitize.enabled()
    monkeypatch.setenv(sanitize.ENV_VAR, "0")
    assert not sanitize.enabled()
    with sanitize.sanitizing():              # context wins over env
        assert sanitize.enabled()
        with sanitize.sanitizing(False):     # the innermost wins
            assert not sanitize.enabled()
    monkeypatch.delenv(sanitize.ENV_VAR)
    assert not sanitize.enabled()


# ---- launch audit: each site's arguments on CPU tensors ------------------

THREADS = 256


def _graph():
    return G.rmat(6, 4, seed=7, weighted=True, device=CPU)


def _frontier(g, b: int, cap_in: int):
    """(base, sizes) (b, cap_in): the first vertices of each lane, -1
    padded, sizes their degrees."""
    deg = g.degrees
    base = torch.full((b, cap_in), -1, dtype=torch.int32)
    for i in range(b):
        base[i, :cap_in - 1] = torch.arange(i, i + cap_in - 1)
    sizes = torch.where(base >= 0, deg[base.clamp(min=0).long()], 0)
    return base, sizes.to(torch.int32)


def _args_advance_batch():
    g = _graph()
    b, cap_in = 2, 5
    base, sizes = _frontier(g, b, cap_in)
    cap_out = int(sizes.sum(dim=1).max())
    (off, eb, tl), lb, epoch = K._lb_scratch(b, cap_in, cap_out, THREADS,
                                             True, CPU)
    rows = [torch.empty((b, cap_out), dtype=torch.int32) for _ in range(5)]
    return ("advance", "advance_batch", [
        sizes, base, g.row_offsets, g.col_store, None, 1, b, cap_in,
        cap_out, g.num_edges, off, eb, tl, tl.numel(), lb.counters,
        lb.live_end, lb.status, lb.status.numel(), epoch, *rows,
        torch.empty((b, cap_out), dtype=torch.bool),
        torch.empty((b,), dtype=torch.int32), THREADS, None])


def _args_advance_filter_batch():
    g = _graph()
    b, cap_in, n = 2, 5, g.num_vertices
    base, sizes = _frontier(g, b, cap_in)
    cap_out, cap_front = int(sizes.sum(dim=1).max()), n
    tile = K.lb_tile(THREADS)
    slot_tiles = max(-(-cap_out // tile), 1)
    tiles = max(-(-cap_in // K.SCAN_TILE), slot_tiles)
    lb, epoch = K._lookback_state(CPU, b, b * tiles, 2)

    def empty(*shape):
        return torch.empty(shape, dtype=torch.int32)

    tl, cand = empty(b, slot_tiles + 1), empty(b, slot_tiles * tile // 32)
    return ("advance", "advance_filter_batch", [
        sizes, base, g.row_offsets, g.col_store, None, 1,
        torch.zeros((b, n), dtype=torch.bool), b, n, cap_in, cap_out,
        g.num_edges, cap_front, K._first_table(None, b, n, CPU),
        empty(b, cap_in + 1), empty(b, cap_in), tl, tl.numel(), cand,
        cand.numel(), lb.counters, lb.live_end, lb.status,
        lb.status.numel(), epoch, empty(b, cap_front), empty(b, cap_front),
        empty(b), empty(b), THREADS, None])


def _args_compact():
    b, cap = 3, 100
    values = torch.arange(b * cap, dtype=torch.int32).reshape(b, cap)
    tiles = max(-(-cap // (K.COMPACT_ITEMS * THREADS)), 1)
    lb, epoch = K._lookback_state(CPU, b, b * tiles, 1)
    return ("compact", "compact_batch", [
        values, values.stride(0), values % 3 == 0, b, cap, lb.counters,
        lb.status, lb.status.numel(), epoch,
        torch.empty((b, cap), dtype=torch.int32),
        torch.empty((b,), dtype=torch.int32), THREADS, None])


def _csr():
    g = _graph()
    cols = g.cols()
    vals = torch.rand(cols.shape, generator=torch.Generator().manual_seed(0))
    return g, cols, vals


def _args_spmv():
    g, cols, vals = _csr()
    n, width = g.num_vertices, 2
    heavy, nvery = K.spmv_heavy_rows(g.row_offsets, width)
    return ("spmv", "spmv", [
        SR.plus_times.code, g.row_offsets, cols, vals, torch.ones(n), n,
        None, n, width, heavy, int(heavy.shape[0]), nvery,
        torch.empty((n,)), THREADS, None])


def _args_spmm():
    g, cols, vals = _csr()
    n, k = g.num_vertices, 3
    rows, nsplit = K.heavy_rows(g.row_offsets, 2, 8)
    return ("spmv", "spmm", [
        SR.plus_times.code, g.row_offsets, cols, vals, torch.ones((n, k)), n,
        k, torch.ones((n,), dtype=torch.bool), n, rows, int(rows.shape[0]),
        nsplit, 2, torch.empty((n, k)), None])


def _args_segment_search():
    g, cols, _ = _csr()
    ro = g.row_offsets
    u = torch.arange(0, g.num_vertices, 3)
    lo, hi = ro[u], ro[u + 1]
    needles = (u * 7 % g.num_vertices).to(torch.int32)
    return ("search", "segment_search_locate", [
        cols, 0, int(cols.shape[0]), lo, hi, needles, int(u.shape[0]),
        torch.empty(u.shape, dtype=torch.int32), THREADS, None])


def _args_lb_expand():
    sizes = torch.tensor([3, 0, 5, 1, 0, 2], dtype=torch.int32)
    cap_in, cap_out = 6, 13
    (off, _, tl), lb, epoch = K._lb_scratch(1, cap_in, cap_out, THREADS,
                                            False, CPU)
    out = torch.empty((2 * cap_out + 1,), dtype=torch.int32)
    return ("lb_expand", "lb_expand", [
        sizes, cap_in, cap_out, off, tl, tl.numel(), lb.counters,
        lb.live_end, lb.status, lb.status.numel(), epoch, out[:cap_out],
        out[cap_out:-1], torch.empty((cap_out,), dtype=torch.bool), out[-1],
        THREADS, None])


def _qkv(sq=6, sk=9, d=8):
    gen = torch.Generator().manual_seed(1)
    return [torch.randn((s, d), generator=gen) for s in (sq, sk, sk)]


def _args_attention_partials():
    q, k, v = _qkv()
    sq, d, nsplit = 6, 8, 2
    acc, ml = K._attention_workspace(nsplit, sq, d, CPU)
    return ("attention", "flash_attention", [
        0, q, k, v, None, acc, ml, sq, 9, d, 1 / math.sqrt(d), 1, nsplit,
        None])


def _args_attention_combine():
    sq, d, nsplit = 6, 8, 2
    acc, ml = K._attention_workspace(nsplit, sq, d, CPU)
    return ("attention", "attention_combine", [
        0, acc, ml, torch.empty((sq, d)), sq, d, nsplit, None])


def _args_flash_attention():
    q, k, v = _qkv()
    sq, d, nsplit = 6, 8, 3
    acc, ml = K._attention_workspace(nsplit, sq, d, CPU)
    return ("attention", "flash_attention_split", [
        0, q, k, v, torch.empty((sq, d)), acc, ml, sq, 9, d,
        ctypes.c_float(1 / math.sqrt(d)), 1, nsplit, None])


def _args_moe_gather():
    t, d, s = 5, 4, 7
    x = torch.randn((t, d), generator=torch.Generator().manual_seed(2))
    # -1 (a zero row) and past the last token (the last row): no fault
    slot = torch.tensor([0, 4, -1, 2, 9, 3, 3], dtype=torch.int32)
    return ("moe_gather", "moe_gather", [
        x, t, d * 4, 4, slot, s,
        torch.empty((2 * (t + 1) + 1 + s,), dtype=torch.int32),
        torch.empty((s, d)), None])


SITE_ARGS = {
    "advance_batch": _args_advance_batch,
    "advance_filter_batch": _args_advance_filter_batch,
    "compact": _args_compact,
    "spmv": _args_spmv,
    "spmm": _args_spmm,
    "segment_search": _args_segment_search,
    "lb_expand": _args_lb_expand,
    "attention_partials": _args_attention_partials,
    "attention_combine": _args_attention_combine,
    "flash_attention": _args_flash_attention,
    "moe_gather": _args_moe_gather,
}


def _params(lib, fn):
    return [p for p, _ in K._SIGNATURES[(lib, fn)]]


def _declared(site, lib, fn, args):
    return K._SITES[site](fn, dict(zip(_params(lib, fn), args)))


def _replace(lib, fn, args, name, value):
    out = list(args)
    out[_params(lib, fn).index(name)] = value
    return out


def test_every_launch_site_is_declared():
    assert set(K.SITES) == set(SITE_ARGS)
    assert len(K.SITES) == 11
    for site, make in SITE_ARGS.items():
        lib, fn, args = make()
        decl = _declared(site, lib, fn, args)
        pointers = {p for p, c in K._SIGNATURES[(lib, fn)]
                    if c.endswith("*")}
        assert set(decl.operands) == pointers, site
        assert set(decl.accumulate) <= {p for p, o in decl.operands.items()
                                        if o.out}, site
    for fn, kernels in K.FUNCTION_KERNELS.items():
        assert any(f == fn for _, f in K._SIGNATURES), fn
        assert set(kernels) <= set(K.KERNELS), fn


@pytest.mark.parametrize("site", sorted(SITE_ARGS))
def test_site_audits_clean(site):
    lib, fn, args = SITE_ARGS[site]()
    before = sanitize.audit_count(site)
    K.audit(site, lib, fn, *args)
    assert sanitize.audit_count(site) == before + 1
    assert sanitize.audits()[(site, fn)] >= 1


def _first_output(decl, args, lib, fn, rank_min=1):
    for p in _params(lib, fn):
        o = decl.operands.get(p)
        if o is not None and o.out and o.extent > 0 and o.rank >= rank_min:
            t = dict(zip(_params(lib, fn), args))[p]
            if t is not None:
                return p, t
    raise AssertionError("no output")


@pytest.mark.parametrize("site", sorted(SITE_ARGS))
def test_seeded_out_of_bounds_extent(site):
    """An output one element short of what the grid writes."""
    lib, fn, args = SITE_ARGS[site]()
    decl = _declared(site, lib, fn, args)
    p, t = _first_output(decl, args, lib, fn)
    bad = _replace(lib, fn, args, p, t[..., :-1])
    with pytest.raises(sanitize.MemoryFault, match="out-of-bounds"):
        K.audit(site, lib, fn, *bad)


@pytest.mark.parametrize("site", sorted(SITE_ARGS))
def test_seeded_write_write_race(site):
    """An output whose storage overlaps an input (or, where no input
    shares its type, another output)."""
    lib, fn, args = SITE_ARGS[site]()
    decl = _declared(site, lib, fn, args)
    a = dict(zip(_params(lib, fn), args))
    p, out = _first_output(decl, args, lib, fn)
    others = [q for q in _params(lib, fn)
              if q != p and isinstance(a.get(q), torch.Tensor)
              and a[q].dtype == out.dtype and a[q].numel() > 0
              and q in decl.operands]
    others.sort(key=lambda q: decl.operands[q].out)   # inputs first
    q = others[0]
    buf = torch.zeros(max(out.numel(), a[q].numel()), dtype=out.dtype)
    bad = _replace(lib, fn, args, p, buf[:out.numel()].view(out.shape))
    bad = _replace(lib, fn, bad, q, buf[:a[q].numel()].view(a[q].shape))
    with pytest.raises(sanitize.MemoryFault, match="write-write race"):
        K.audit(site, lib, fn, *bad)


@pytest.mark.parametrize("site", sorted(SITE_ARGS))
def test_seeded_rank_or_dtype_mismatch(site):
    lib, fn, args = SITE_ARGS[site]()
    a = dict(zip(_params(lib, fn), args))
    p = next(q for q, c in K._SIGNATURES[(lib, fn)]
             if c.endswith("*") and isinstance(a[q], torch.Tensor)
             and a[q].dim() >= 1)
    with pytest.raises(sanitize.MemoryFault, match="dtype mismatch"):
        K.audit(site, lib, fn,
                *_replace(lib, fn, args, p, a[p].to(torch.float64)))
    with pytest.raises(sanitize.MemoryFault, match="rank mismatch"):
        K.audit(site, lib, fn, *_replace(lib, fn, args, p, a[p][None]))
    scalar = next(q for q, c in K._SIGNATURES[(lib, fn)] if c == "int")
    with pytest.raises(sanitize.MemoryFault, match="dtype mismatch"):
        K.audit(site, lib, fn,
                *_replace(lib, fn, args, scalar, 2 ** 40))
    with pytest.raises(sanitize.MemoryFault, match="arguments"):
        K.audit(site, lib, fn, *args[:-1])


# the index operands: each seeded past its range
def _oob_column(site):
    lib, fn, args = SITE_ARGS[site]()
    a = dict(zip(_params(lib, fn), args))
    cols = a["cols"].clone()
    cols[-1] = a["row_offsets"].numel() - 1 if "row_offsets" in a else \
        a["nx"]
    return lib, fn, _replace(lib, fn, args, "cols", cols)


@pytest.mark.parametrize("site", ["advance_batch", "advance_filter_batch",
                                  "spmv", "spmm"])
def test_seeded_column_id_out_of_range(site):
    lib, fn, args = _oob_column(site)
    with pytest.raises(sanitize.MemoryFault, match="column ids outside"):
        K.audit(site, lib, fn, *args)


def test_seeded_frontier_and_offsets_out_of_range():
    lib, fn, args = _args_advance_batch()
    a = dict(zip(_params(lib, fn), args))
    base = a["base"].clone()
    base[0, 0] = -1                     # a live lane (size > 0) at -1
    with pytest.raises(sanitize.MemoryFault, match="live lane"):
        K.audit("advance_batch", lib, fn,
                *_replace(lib, fn, args, "base", base))
    base[0, 0] = a["row_offsets"].numel() - 1       # = n
    with pytest.raises(sanitize.MemoryFault, match="frontier ids"):
        K.audit("advance_batch", lib, fn,
                *_replace(lib, fn, args, "base", base))
    ro = a["row_offsets"].clone()
    ro[3] = ro[2] - 1                   # not non-decreasing
    with pytest.raises(sanitize.MemoryFault, match="non-decreasing"):
        K.audit("advance_batch", lib, fn,
                *_replace(lib, fn, args, "row_offsets", ro))


def test_seeded_delta_stream_out_of_range():
    g = G.rmat(6, 4, seed=7, device=CPU, encoding="delta")
    store = g.col_store
    assert store.num_escapes == 0
    lib, fn, args = _args_advance_batch()
    args = _replace(lib, fn, args, "row_offsets", g.row_offsets)
    args = _replace(lib, fn, args, "cols", store.delta)
    args = _replace(lib, fn, args, "anchor", store.anchor)
    args = _replace(lib, fn, args, "kind", K._DELTA_KIND)
    args = _replace(lib, fn, args, "m", store.num_edges)
    K.audit("advance_batch", lib, fn, *args)
    anchor = store.anchor.clone()
    anchor[-1] = g.num_vertices
    with pytest.raises(sanitize.MemoryFault, match="delta stream"):
        K.audit("advance_batch", lib, fn,
                *_replace(lib, fn, args, "anchor", anchor))


def test_seeded_unsorted_and_overlong_segments():
    lib, fn, args = _args_segment_search()
    a = dict(zip(_params(lib, fn), args))
    hay = a["hay"].clone()
    lo, hi = int(a["lo"][1]), int(a["hi"][1])
    assert hi - lo >= 2
    first, second = int(hay[lo]), int(hay[lo + 1])
    hay[lo], hay[lo + 1] = second + 1, first
    with pytest.raises(sanitize.MemoryFault, match="not sorted"):
        K.audit("segment_search", lib, fn,
                *_replace(lib, fn, args, "hay", hay))
    hi_t = a["hi"].clone()
    hi_t[0] = a["m"] + 1
    with pytest.raises(sanitize.MemoryFault, match="segment outside"):
        K.audit("segment_search", lib, fn,
                *_replace(lib, fn, args, "hi", hi_t))


def test_seeded_negative_segment_size():
    lib, fn, args = _args_lb_expand()
    sizes = dict(zip(_params(lib, fn), args))["sizes"].clone()
    sizes[2] = -1
    with pytest.raises(sanitize.MemoryFault, match="segment sizes"):
        K.audit("lb_expand", lib, fn, *_replace(lib, fn, args, "sizes",
                                                 sizes))


def test_seeded_stale_lookback_epoch_and_dirty_first_table():
    lib, fn, args = _args_advance_filter_batch()
    a = dict(zip(_params(lib, fn), args))
    status = a["status"].clone()
    status[0] = (a["epoch"] << 34) | (2 << 32)      # this launch's tag
    with pytest.raises(sanitize.MemoryFault, match="look-back status"):
        K.audit("advance_filter_batch", lib, fn,
                *_replace(lib, fn, args, "status", status))
    first = a["first"].clone()
    first[1, 3] = 0
    with pytest.raises(sanitize.MemoryFault, match="first holds another"):
        K.audit("advance_filter_batch", lib, fn,
                *_replace(lib, fn, args, "first", first))


def test_declared_alias_is_no_race():
    """The counterpart of the reference's ``accumulate=`` test: a pair
    of operands the site declares as sharing storage passes."""
    lib, fn, args = _args_compact()
    a = dict(zip(_params(lib, fn), args))
    bad = _replace(lib, fn, args, "packed", a["values"])
    decl = _declared("compact", lib, fn, bad)
    with pytest.raises(sanitize.MemoryFault, match="write-write race"):
        sanitize.check_launch(fn, K._SIGNATURES[(lib, fn)], bad, decl)
    decl.aliases = [("packed", "values")]
    sanitize.check_launch(fn, K._SIGNATURES[(lib, fn)], bad, decl)


def test_moe_slot_ids_clamp_is_no_fault():
    lib, fn, args = _args_moe_gather()
    slot = torch.tensor([-5, 10 ** 6, 0, 4, -1, 2, 3], dtype=torch.int32)
    K.audit("moe_gather", lib, fn, *_replace(lib, fn, args, "slot_token",
                                             slot))


class _FakeFn:
    """Stands in for a loaded C launcher: records its calls."""

    def __init__(self):
        self.calls = 0

    def __call__(self, *args):
        self.calls += 1
        return 0


def test_launch_audits_only_when_sanitizing(monkeypatch):
    """With sanitizing off ``_launch`` goes straight to the C call (no
    audit); with it on, a faulty launch raises before the call."""
    fake = _FakeFn()
    monkeypatch.setattr(K, "_fn", lambda lib, fn: fake)
    lib, fn, args = _args_compact()
    bad = _replace(lib, fn, args, "packed",
                   dict(zip(_params(lib, fn), args))["values"])
    audited = sanitize.audit_count("compact")
    with sanitize.sanitizing(False):
        K._launch("compact", lib, fn, *bad)
    assert fake.calls == 1 and sanitize.audit_count("compact") == audited
    with sanitize.sanitizing():
        with pytest.raises(sanitize.MemoryFault, match="write-write race"):
            K._launch("compact", lib, fn, *bad)
        assert fake.calls == 1            # the C call was not reached
        K._launch("compact", lib, fn, *args)
    assert fake.calls == 2
    assert sanitize.audit_count("compact") == audited + 2


def test_audit_adds_no_host_read_to_the_loops():
    """The audit never runs with sanitizing off, so the enactor's read a
    step is all the loops make (the CPU path has no launch either way;
    the card test holds the counts)."""
    g = _graph()
    enactor.reset_host_reads()
    r1 = bfs_batch(g, [0, 3])
    off = enactor.host_reads()
    enactor.reset_host_reads()
    with sanitize.sanitizing():
        r2 = bfs_batch(g, [0, 3])
    assert enactor.host_reads() == off
    assert torch.equal(r1.labels, r2.labels)
