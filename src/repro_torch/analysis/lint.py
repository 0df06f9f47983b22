"""reprolint for the port — the BSP-step discipline linter (stdlib
``ast``, no dependencies; counterpart of ``repro.analysis.lint``, with
the same rule IDs, suppression syntax and CLI).

The port runs its loops eagerly: ``core.enactor`` makes exactly one host
read a BSP step (``enactor._read``), and every other step operation is
queued on the card. Its correctness and speed rest on conventions
nothing else enforces: no other host sync inside a step (a single
``.item()`` there stalls the queue once a step, and a Python branch on a
tensor is the same sync in disguise), integer accumulators pinned to
int32 (PyTorch promotes the sum of a bool or int tensor, and an int32
``cumsum``, to int64 where the reference keeps int32), fenced timing (a
wall-clock pair around queued kernels measures the enqueue, not the
work), diagnostics routed through ``repro_torch.obs.log``, no swallowed
exceptions. Every rule encodes one of those conventions.

Rules
  RL001 host-sync-in-step     ``.item()``, ``.tolist()``, ``.cpu()``,
                              ``.numpy()``, ``torch.equal`` /
                              ``torch.allclose``, ``int()`` / ``bool()``
                              / ``float()`` over a tensor expression, or
                              ``np.asarray`` / ``np.array`` of one, inside
                              a BSP step. (A Python ``if`` / ``while`` on
                              a tensor is a sync too; it is reported
                              once, as RL002.) ``enactor._read``, the
                              loop's one read a step, is the declared
                              exception.
  RL002 tensor-branch-in-step Python ``if`` / ``while`` / conditional
                              expression / ``assert`` over a tensor
                              expression, or ``for`` over one, inside a
                              BSP step — a host sync a step, and a
                              decision the device cannot queue.
  RL003 unpinned-int-accum    ``torch.sum`` / ``cumsum`` / ``prod`` /
                              ``count_nonzero`` (or the method forms)
                              over a bool / int operand without
                              ``dtype=`` and without an immediate re-pin
                              (``.to(...)``, ``.int()``, ``.long()``):
                              the result is int64.
  RL004 unfenced-timing       a wall-clock measurement (two timing calls
                              or a timing subtraction) with no
                              ``torch.cuda.synchronize`` / event
                              ``synchronize`` / ``elapsed_time`` /
                              ``span`` / ``timed`` / ``obs.tracing.fence``
                              fence, no host read (``.item()``,
                              ``.tolist()``, ``.cpu()``, ``.numpy()``:
                              each waits for the work it reads) and no
                              call of a same-file function that fences,
                              inside the measured region.
  RL005 bare-diagnostic       ``print(...)`` or ``warnings.warn(...)``
                              in library code (under ``src/repro_torch``)
                              — route through ``repro_torch.obs.log``.
  RL006 swallowed-exception   a bare ``except:`` that never re-raises, or
                              an ``except Exception/BaseException`` whose
                              body is only ``pass``/``...``/``continue``.

A BSP step is a function passed (by name, as a lambda or through
``functools.partial``) to ``run_until``, ``run_until_any`` or
``tiered_step`` — the ``cond``, ``plan``, ``body`` and ``probe`` of the
loops and the step builder of a tier — anything nested in one, and any
function of the same file a step calls by name (it runs inside the
step).

Suppression syntax (same line or the line above)::

    total = counts.sum()        # reprolint: disable=RL003 -- host-only
    # reprolint: disable=RL004,RL005
    # reprolint: skip-file          (first 10 lines: skip whole file)

A bare ``# reprolint: disable`` suppresses every rule on that line. Each
suppression should carry a trailing reason, as the shipped tree's do.

CLI::

    python -m repro_torch.analysis.lint [paths ...] [--select RL00x,...]
        [--json] [--statistics] [--lib-root PREFIX]

Exit status 1 when findings remain, 0 on a clean tree. Detection is
syntactic: it cannot prove an expression is a tensor, only that it is
tensor-flavoured in a region that runs once a step — the review
question a human would ask, automated.
"""
from __future__ import annotations

import argparse
import ast
import json
import re
import sys
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Iterable, Optional

RULES = {
    "RL001": "host sync inside a BSP step",
    "RL002": "Python control flow over a tensor in a BSP step",
    "RL003": "integer/bool accumulation without a pinned dtype",
    "RL004": "wall-clock timing without a fence in the measured region",
    "RL005": "bare print()/warnings.warn() in library code",
    "RL006": "exception swallowed outside a declared retry boundary",
}

LIB_ROOT = "src/repro_torch"

_SUPPRESS_RE = re.compile(
    r"#\s*reprolint:\s*disable(?:=\s*([A-Za-z0-9_,\s]+?))?\s*(?:--|$)")
_SKIP_FILE_RE = re.compile(r"#\s*reprolint:\s*skip-file")

# --- syntactic vocabulary -------------------------------------------------

_TIMING_FNS = {"time.monotonic", "time.monotonic_ns", "time.time",
               "time.perf_counter", "time.perf_counter_ns"}
# a call whose last name is one of these fences the device (a host read
# waits for the work it reads; ``fence`` is obs.tracing's)
_FENCE_CALLS = {"synchronize", "elapsed_time", "span", "timed",
                "timed_span", "fence", "item", "tolist", "cpu", "numpy"}
# calls whose function-valued arguments are BSP steps (core.enactor)
_STEP_WRAPPERS = {"run_until", "run_until_any", "tiered_step"}
# the enactor's one read a step: the declared exception to RL001
_SANCTIONED_READS = {"_read", "enactor._read"}
_ACCUM_FNS = {"torch.sum", "torch.cumsum", "torch.prod",
              "torch.count_nonzero"}
_ACCUM_METHODS = {"sum", "cumsum", "prod", "count_nonzero"}
# an immediate re-pin of an accumulator's dtype
_REPIN_METHODS = {"to", "int", "long", "short", "type"}
# tensor methods: a call of one makes an expression tensor-flavoured
_TENSOR_METHODS = {"any", "all", "sum", "min", "max", "mean", "amax",
                   "amin", "argmax", "argmin", "item", "nonzero",
                   "count_nonzero", "cumsum", "prod", "eq", "ne", "gt",
                   "ge", "lt", "le", "equal", "dot", "masked_fill",
                   "index_select", "gather"}
# torch calls that return host values — never tensors
_STATIC_TORCH = {"torch.device", "torch.dtype", "torch.iinfo",
                 "torch.finfo", "torch.Size", "torch.is_tensor",
                 "torch.is_floating_point", "torch.get_default_dtype",
                 "torch.promote_types", "torch.result_type"}
_STATIC_TORCH_PREFIXES = ("torch.cuda.", "torch.backends.",
                          "torch.profiler.", "torch.utils.")
_HOST_READS = {"item", "tolist", "cpu", "numpy", "is_nonzero"}
_HOST_READ_FNS = {"torch.equal", "torch.allclose"}
_INT_DTYPES = {"int8", "int16", "int32", "int64", "uint8", "uint16",
               "uint32", "uint64", "short", "int", "long"}
_BOOL_DTYPES = {"bool"}
_INT_METHODS = {"int", "long", "short", "char", "byte"}
_BOOL_FNS = {"torch.logical_and", "torch.logical_or", "torch.logical_not",
             "torch.logical_xor", "torch.isin", "torch.isnan",
             "torch.isfinite", "torch.isinf", "torch.isclose", "torch.eq",
             "torch.ne", "torch.gt", "torch.lt", "torch.ge", "torch.le"}
_BOOL_METHODS = {"bool", "eq", "ne", "gt", "lt", "ge", "le", "isnan",
                 "isfinite", "logical_and", "logical_or", "logical_not"}
_NP_CAST = {"np.asarray", "np.array", "numpy.asarray", "numpy.array"}


@dataclass
class Finding:
    path: str
    line: int
    col: int
    rule: str
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"


def _dotted(node) -> Optional[str]:
    """'torch.cuda.synchronize' for an Attribute/Name chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _leaf(func) -> Optional[str]:
    """The called name: ``synchronize`` for ``torch.cuda.synchronize``
    and for ``f().synchronize``."""
    if isinstance(func, ast.Attribute):
        return func.attr
    return func.id if isinstance(func, ast.Name) else None


def _is_tensorish(expr: ast.AST) -> bool:
    """Heuristic: does this expression make or read a tensor? A call of
    a ``torch`` function (not one returning host values) or of a tensor
    method."""
    for sub in ast.walk(expr):
        if not isinstance(sub, ast.Call):
            continue
        d = _dotted(sub.func)
        if d is not None and d.split(".", 1)[0] == "torch":
            if d in _STATIC_TORCH or d.startswith(_STATIC_TORCH_PREFIXES):
                continue
            return True
        if (isinstance(sub.func, ast.Attribute)
                and sub.func.attr in _TENSOR_METHODS):
            return True
    return False


def _dtype_flavor(node: Optional[ast.AST]) -> Optional[str]:
    """'int' / 'bool' for a dtype expression like ``torch.int32``."""
    name = _dotted(node) if node is not None else None
    leaf = name.rsplit(".", 1)[-1] if name else None
    if leaf in _INT_DTYPES:
        return "int"
    if leaf in _BOOL_DTYPES:
        return "bool"
    return None


def _call_flavor(call: ast.Call) -> Optional[str]:
    d = _dotted(call.func)
    if d in _BOOL_FNS:
        return "bool"
    for kw in call.keywords:
        if kw.arg == "dtype":
            return _dtype_flavor(kw.value)
    if isinstance(call.func, ast.Attribute):
        attr = call.func.attr
        if attr in _INT_METHODS:
            return "int"
        if attr in _BOOL_METHODS:
            return "bool"
        if attr in ("to", "type") and call.args:
            return _dtype_flavor(call.args[0])
    return None


def _flavor(expr: ast.AST, env: dict) -> Optional[str]:
    """'int' | 'bool' | None — the syntactic integer-ness of ``expr``.
    ``env`` maps local names to flavors (single-pass assignment scan)."""
    if isinstance(expr, (ast.Compare, ast.BoolOp)):
        return "bool"
    if isinstance(expr, ast.UnaryOp) and isinstance(expr.op,
                                                    (ast.Invert, ast.Not)):
        return "bool"
    if isinstance(expr, ast.BinOp):
        if isinstance(expr.op, (ast.BitAnd, ast.BitOr, ast.BitXor)):
            return "bool"
        if isinstance(expr.op, (ast.Add, ast.Sub, ast.Mult)):
            return _flavor(expr.left, env) or _flavor(expr.right, env)
    if isinstance(expr, ast.Call):
        return _call_flavor(expr)
    if isinstance(expr, ast.Subscript):
        return _flavor(expr.value, env)
    if isinstance(expr, ast.Name):
        return env.get(expr.id)
    return None


def _scope_nodes(body: Iterable[ast.stmt]):
    """All nodes in a function/module body WITHOUT descending into nested
    function definitions (they are their own scopes)."""
    stack = [n for n in body
             if not isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            stack.append(child)


class _FileLinter:
    def __init__(self, path: str, source: str, *, lib: bool,
                 select: Optional[set] = None):
        self.path = path
        self.source = source
        self.lib = lib
        self.select = select or set(RULES)
        self.findings: list[Finding] = []
        self.lines = source.splitlines()
        self.suppressions = self._scan_suppressions()
        self.tree = ast.parse(source, filename=path)
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                child._rl_parent = node
        self.steps = self._collect_steps()
        self.fences = self._collect_fences()

    # -- suppression handling ---------------------------------------------

    def _scan_suppressions(self) -> dict:
        out: dict[int, set] = {}
        for i, line in enumerate(self.lines, start=1):
            m = _SUPPRESS_RE.search(line)
            if m:
                ids = m.group(1)
                out[i] = ({s.strip().upper() for s in ids.split(",")
                           if s.strip()} if ids else {"*"})
        return out

    def _suppressed(self, line: int, rule: str) -> bool:
        for ln in (line, line - 1):
            ids = self.suppressions.get(ln)
            if ids and ("*" in ids or rule in ids):
                return True
        return False

    def _flag(self, node: ast.AST, rule: str, message: str) -> None:
        if rule not in self.select:
            return
        line = getattr(node, "lineno", 1)
        if self._suppressed(line, rule):
            return
        self.findings.append(Finding(self.path, line,
                                     getattr(node, "col_offset", 0),
                                     rule, message))

    # -- BSP-step discovery -------------------------------------------------

    def _collect_steps(self) -> set:
        """Function/Lambda nodes that run once a BSP step: passed
        (directly or via functools.partial) to an enactor loop or
        ``tiered_step``, then every same-file function a step calls by
        name, to a fixed point (nesting is handled by the traversal)."""
        defs_by_name: dict[str, list] = {}
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                defs_by_name.setdefault(node.name, []).append(node)
        steps: dict[int, ast.AST] = {}

        def mark(arg):
            if isinstance(arg, ast.Lambda):
                steps[id(arg)] = arg
            elif isinstance(arg, ast.Name):
                for d in defs_by_name.get(arg.id, ()):
                    steps[id(d)] = d
            elif isinstance(arg, ast.Call):
                d = _dotted(arg.func)
                if d and d.rsplit(".", 1)[-1] == "partial" and arg.args:
                    mark(arg.args[0])

        for node in ast.walk(self.tree):
            if not isinstance(node, ast.Call):
                continue
            d = _dotted(node.func)
            if d and d.rsplit(".", 1)[-1] in _STEP_WRAPPERS:
                for arg in node.args:
                    mark(arg)
                for kw in node.keywords:
                    mark(kw.value)
        # a same-file function a step calls by name runs inside the step
        todo = list(steps.values())
        while todo:
            fn = todo.pop()
            for sub in ast.walk(fn):
                if (isinstance(sub, ast.Call)
                        and isinstance(sub.func, ast.Name)
                        and sub.func.id not in _SANCTIONED_READS):
                    for d in defs_by_name.get(sub.func.id, ()):
                        if id(d) not in steps:
                            steps[id(d)] = d
                            todo.append(d)
        return set(steps)

    def _collect_fences(self) -> set:
        """Fence names: the vocabulary, plus every function of this file
        whose body calls a fence (a helper such as ``_sync(dev)``), to a
        fixed point."""
        fences = set(_FENCE_CALLS)
        defs = [n for n in ast.walk(self.tree)
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        grew = True
        while grew:
            grew = False
            for d in defs:
                if d.name in fences:
                    continue
                if any(isinstance(c, ast.Call) and _leaf(c.func) in fences
                       for c in ast.walk(d)):
                    fences.add(d.name)
                    grew = True
        return fences

    # -- main traversal ----------------------------------------------------

    def run(self) -> list[Finding]:
        if any(_SKIP_FILE_RE.search(ln) for ln in self.lines[:10]):
            return []
        self._visit_block(self.tree.body, step=False)
        self._check_timing_scope(self.tree.body)
        self.findings.sort(key=lambda f: (f.line, f.col, f.rule))
        return self.findings

    def _visit_block(self, body, *, step: bool) -> None:
        env: dict[str, Optional[str]] = {}
        stack = list(body)
        nodes = []
        while stack:
            node = stack.pop(0)
            # defs/lambdas get their own region, step-ness inherited (a
            # def nested in a step runs in it)
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._visit_block(node.body,
                                  step=step or id(node) in self.steps)
                self._check_timing_scope(node.body)
                continue
            if isinstance(node, ast.Lambda):
                self._visit_expr_region(
                    [node.body], step=step or id(node) in self.steps, env={})
                continue
            nodes.append(node)
            stack.extend(ast.iter_child_nodes(node))
        nodes.sort(key=lambda n: (getattr(n, "lineno", 0),
                                  getattr(n, "col_offset", 0)))
        for node in nodes:
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)):
                env[node.targets[0].id] = _flavor(node.value, env)
            self._check_node(node, step=step, env=env)

    def _visit_expr_region(self, exprs, *, step: bool, env: dict) -> None:
        for e in exprs:
            for node in ast.walk(e):
                self._check_node(node, step=step, env=env)

    def _check_node(self, node, *, step: bool, env: dict) -> None:
        if isinstance(node, ast.Call):
            self._check_call(node, step=step, env=env)
        elif isinstance(node, ast.ExceptHandler):
            self._check_except(node)
        elif not step:
            return
        elif isinstance(node, (ast.If, ast.While, ast.IfExp, ast.Assert)):
            if _is_tensorish(node.test):
                kw = {ast.If: "if", ast.While: "while", ast.IfExp:
                      "conditional expression", ast.Assert: "assert"}[
                          type(node)]
                self._flag(node, "RL002",
                           f"Python `{kw}` over a tensor expression in a "
                           f"BSP step — a host sync a step; use "
                           f"torch.where, or read it with the step's one "
                           f"host read (the plan)")
        elif isinstance(node, ast.For):
            if _is_tensorish(node.iter):
                self._flag(node, "RL002",
                           "Python `for` over a tensor in a BSP step — "
                           "one host read an element")

    def _check_call(self, node: ast.Call, *, step: bool, env: dict) -> None:
        d = _dotted(node.func)

        # RL001 — host syncs in BSP steps
        if step and d not in _SANCTIONED_READS:
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr in _HOST_READS and not node.args):
                self._flag(node, "RL001",
                           f"`.{node.func.attr}()` reads the device inside "
                           f"a BSP step — a host sync a step beside the "
                           f"enactor's one")
            elif d in _HOST_READ_FNS:
                self._flag(node, "RL001",
                           f"`{d}` returns a host bool: a host sync inside "
                           f"a BSP step")
            elif (isinstance(node.func, ast.Name)
                  and node.func.id in ("int", "bool", "float")
                  and len(node.args) == 1
                  and _is_tensorish(node.args[0])):
                self._flag(node, "RL001",
                           f"`{node.func.id}(...)` over a tensor expression "
                           f"reads the device inside a BSP step")
            elif d in _NP_CAST and node.args and not isinstance(
                    node.args[0], (ast.List, ast.Tuple, ast.Constant)):
                self._flag(node, "RL001",
                           f"`{d}` of a tensor inside a BSP step copies it "
                           f"to the host")

        # RL003 — unpinned integer accumulation
        operand = None
        if d in _ACCUM_FNS and node.args:
            operand, leaf = node.args[0], d.rsplit(".", 1)[-1]
        elif (isinstance(node.func, ast.Attribute)
              and node.func.attr in _ACCUM_METHODS
              and d not in _ACCUM_FNS
              and not (d or "").startswith(("np.", "numpy."))):
            operand, leaf = node.func.value, node.func.attr
        if operand is not None:
            has_dtype = any(kw.arg == "dtype" for kw in node.keywords)
            parent = getattr(node, "_rl_parent", None)
            repinned = (isinstance(parent, ast.Attribute)
                        and parent.attr in _REPIN_METHODS)
            flavor = ("bool" if leaf == "count_nonzero"
                      else _flavor(operand, env))
            if not has_dtype and not repinned and flavor in ("int", "bool"):
                self._flag(node, "RL003",
                           f"`{leaf}` over an integer/bool operand without "
                           f"dtype= promotes to int64 — pin "
                           f"dtype=torch.int32 (or re-pin at once)")

        # RL005 — bare diagnostics in library code
        if self.lib:
            if isinstance(node.func, ast.Name) and node.func.id == "print":
                self._flag(node, "RL005",
                           "bare print() in library code — route through "
                           "repro_torch.obs.log.get_logger(...)")
            elif d in ("warnings.warn",):
                self._flag(node, "RL005",
                           "warnings.warn() in library code — route "
                           "through repro_torch.obs.log")

    # -- RL006: swallowed exceptions --------------------------------------

    @staticmethod
    def _broad_types(handler: ast.ExceptHandler):
        """Names among Exception/BaseException the handler catches."""
        nodes = (handler.type.elts if isinstance(handler.type, ast.Tuple)
                 else [handler.type])
        out = []
        for t in nodes:
            d = _dotted(t)
            leaf = d.rsplit(".", 1)[-1] if d else None
            if leaf in ("Exception", "BaseException"):
                out.append(leaf)
        return out

    def _check_except(self, handler: ast.ExceptHandler) -> None:
        body_raises = any(isinstance(n, ast.Raise)
                          for stmt in handler.body
                          for n in ast.walk(stmt))
        if handler.type is None:
            # a bare except: catches KeyboardInterrupt/SystemExit too —
            # only a re-raising cleanup handler gets a pass
            if not body_raises:
                self._flag(handler, "RL006",
                           "bare `except:` swallows every exception "
                           "(including KeyboardInterrupt) — catch a "
                           "concrete type, re-raise, or declare the "
                           "boundary with a disable comment")
            return
        broad = self._broad_types(handler)
        if not broad or body_raises:
            return
        trivial = all(
            isinstance(stmt, (ast.Pass, ast.Continue))
            or (isinstance(stmt, ast.Expr)
                and isinstance(stmt.value, ast.Constant)
                and stmt.value.value is Ellipsis)
            for stmt in handler.body)
        if trivial:
            self._flag(handler, "RL006",
                       f"`except {broad[0]}` with an empty body discards "
                       f"the failure — handle it, narrow the type, or "
                       f"declare the retry boundary with a disable "
                       f"comment")

    # -- RL004: per-scope timing analysis ---------------------------------

    def _check_timing_scope(self, body) -> None:
        timing_calls = []
        timing_subs = []
        fence_lines = []
        for node in _scope_nodes(body):
            if isinstance(node, ast.Call):
                d = _dotted(node.func)
                if d in _TIMING_FNS:
                    timing_calls.append(node)
                elif _leaf(node.func) in self.fences:
                    fence_lines.append(node.lineno)
            if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Sub):
                if any(isinstance(s, ast.Call)
                       and _dotted(s.func) in _TIMING_FNS
                       for s in ast.walk(node)):
                    timing_subs.append(node)
        measuring = len(timing_calls) >= 2 or timing_subs
        if not (measuring and timing_calls):
            return
        region = [n.lineno for n in timing_calls]
        region += [n.lineno for n in timing_subs]
        lo, hi = min(region), max(region)
        if any(lo <= ln <= hi for ln in fence_lines):
            return
        first = min(timing_calls, key=lambda n: n.lineno)
        self._flag(first, "RL004",
                   "timing region has no torch.cuda.synchronize / event "
                   "synchronize / elapsed_time / span / timed fence — the "
                   "card runs queued work asynchronously, so this "
                   "measures the enqueue, not the work")


# --- public API ------------------------------------------------------------


def lint_source(source: str, path: str = "<string>", *,
                lib: Optional[bool] = None,
                select: Optional[set] = None,
                lib_root: str = LIB_ROOT) -> list[Finding]:
    """Lint a source string. ``lib`` controls RL005 (library-only rule);
    when None it is inferred from ``path`` containing ``lib_root``."""
    if lib is None:
        lib = lib_root in Path(path).as_posix()
    try:
        return _FileLinter(path, source, lib=lib, select=select).run()
    except SyntaxError as e:
        return [Finding(path, e.lineno or 1, e.offset or 0, "RL000",
                        f"syntax error: {e.msg}")]


def lint_file(path, *, select: Optional[set] = None,
              lib_root: str = LIB_ROOT) -> list[Finding]:
    p = Path(path)
    return lint_source(p.read_text(), str(p), select=select,
                       lib_root=lib_root)


def iter_py_files(paths) -> Iterable[Path]:
    for raw in paths:
        p = Path(raw)
        if p.is_dir():
            yield from sorted(q for q in p.rglob("*.py")
                              if "__pycache__" not in q.parts)
        elif p.suffix == ".py":
            yield p


def lint_paths(paths, *, select: Optional[set] = None,
               lib_root: str = LIB_ROOT) -> list[Finding]:
    findings: list[Finding] = []
    for f in iter_py_files(paths):
        findings.extend(lint_file(f, select=select, lib_root=lib_root))
    return findings


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="reprolint — BSP-step discipline linter for the port")
    ap.add_argument("paths", nargs="*", default=[LIB_ROOT],
                    help=f"files/directories to lint (default: {LIB_ROOT})")
    ap.add_argument("--select", default=None,
                    help="comma-separated rule ids (default: all)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit findings as a JSON array")
    ap.add_argument("--statistics", action="store_true",
                    help="print a per-rule count summary")
    ap.add_argument("--lib-root", default=LIB_ROOT,
                    help="path fragment marking library code for RL005")
    args = ap.parse_args(argv)

    select = ({s.strip().upper() for s in args.select.split(",")}
              if args.select else None)
    findings = lint_paths(args.paths, select=select,
                          lib_root=args.lib_root)
    if args.as_json:
        print(json.dumps([asdict(f) for f in findings], indent=1))  # reprolint: disable=RL005 -- CLI output channel
    else:
        for f in findings:
            print(f.render())  # reprolint: disable=RL005 -- CLI output channel
    if args.statistics:
        counts: dict[str, int] = {}
        for f in findings:
            counts[f.rule] = counts.get(f.rule, 0) + 1
        for rule in sorted(counts):
            print(f"{rule}: {counts[rule]:4d}  {RULES.get(rule, '')}")  # reprolint: disable=RL005 -- CLI output channel
        nfiles = len(list(iter_py_files(args.paths)))
        print(f"{len(findings)} finding(s) across {nfiles} file(s)")  # reprolint: disable=RL005 -- CLI output channel
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
