"""repro_torch.analysis — correctness tooling for the port (counterpart
of ``repro.analysis``).

Three tools, one package:

  * ``repro_torch.analysis.lint`` — *reprolint* for the port, an AST
    linter (stdlib ``ast``, zero dependencies) enforcing the conventions
    the port's correctness rests on: no host sync inside a BSP step (the
    enactor's one read a step is the only one), no Python control flow
    over a tensor in a step, int32-pinned integer accumulators (PyTorch
    promotes a bool or int sum to int64), fenced wall-clock timing
    (kernels run asynchronously), diagnostics routed through
    ``repro_torch.obs.log``, no swallowed exceptions. CLI: ``python -m
    repro_torch.analysis.lint src/repro_torch tools chip_smoke.py``.
  * ``repro_torch.analysis.contracts`` — the registry contract checker:
    loads ``core.backend``'s (op × backend × placement × encoding)
    provider matrix and verifies its invariants (distributed coverage or
    declared fallbacks, encodings declared everywhere, telemetry= on
    every primitive, the cuda route under a placement and no silent
    fallback to single, a torch twin for every cuda provider, compile
    budgets declared). CLI: ``python -m repro_torch.analysis.contracts``.
  * ``repro_torch.analysis.sanitize`` — runtime sanitizers: a set-up
    (retrace) counter with per-primitive budgets
    (``budgets.COMPILE_BUDGETS``) and a launch audit of the hand-written
    kernels (out-of-bounds extents and indices, write-write races,
    operands that do not match the C signature) run by
    ``kernels.ops._launch`` before the C call under ``REPRO_SANITIZE=1``
    or ``sanitizing()``.

This module stays import-light on purpose: ``lint``, ``budgets`` and
``sanitize`` import nothing of the port at module level (``sanitize``
imports torch only inside the audit), so ``repro_torch.core`` /
``repro_torch.kernels`` may import them without cycles; ``contracts``
imports the registry and is pulled in lazily (tests and CLI only).
"""
from __future__ import annotations

__all__ = ["budgets", "contracts", "lint", "sanitize"]
