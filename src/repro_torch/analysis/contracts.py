"""Registry contract checker: static audit of the port's provider matrix
(counterpart of ``repro.analysis.contracts``; ``xla`` reads ``torch``
and ``pallas`` reads ``cuda``).

``core.backend`` routes every operator hot path through a
(op × backend × placement × encoding) registry. Its dispatch rules are
load-bearing — a distributed placement never drops to single, the cuda
backend under a placement runs that placement's torch provider, every
cuda kernel has a plain torch twin, encoding-restricted providers
declare what they decode, every primitive exposes ``telemetry=`` — but
nothing re-verifies them once the decorators have run. This module
loads every provider module the registry pulls lazily and checks the
assembled matrix:

  CT001  distributed coverage: every op with a "sharded" provider has a
         "2d" provider and vice versa, OR the hole is a declared
         fallback (``backend.declare_fallback``).
  CT002  encodings declared: every registered key has an encodings
         entry, a non-empty subset of {dense, delta} that contains
         "dense" (the decode-to-dense contract every provider accepts).
  CT003  telemetry surface: each of the six paper primitives exposes a
         ``telemetry=`` keyword.
  CT004  the declared route and no silent fallback to single: under a
         distributed placement the cuda backend dispatches the torch
         provider of that placement (``core/backend.py::_lookup``); a
         placement with no provider raises ``ProviderMissError`` on
         either backend; no distributed key shares its callable with the
         op's single-placement key (a fallback wearing a registration).
  CT005  torch twin: every cuda provider has a torch provider under the
         same placement — the plain version each kernel is held against,
         and the serving ladder's ``cuda → torch`` rung.
  CT006  compile budgets: each of the six primitives has a declared
         set-up budget (``analysis.budgets.COMPILE_BUDGETS``).

Run as a test (``tests/test_torch_analysis.py``) and a CLI:
``python -m repro_torch.analysis.contracts`` (exit 1 on findings).
"""
from __future__ import annotations

import importlib
import inspect
from dataclasses import dataclass
from typing import List

# The six paper primitives: registry name -> (module, public callable).
PRIMITIVES = {
    "bfs": ("repro_torch.core.primitives.bfs", "bfs"),
    "sssp": ("repro_torch.core.primitives.sssp", "sssp"),
    "pagerank": ("repro_torch.core.primitives.pagerank", "pagerank"),
    "cc": ("repro_torch.core.primitives.cc", "connected_components"),
    "bc": ("repro_torch.core.primitives.bc", "bc"),
    "tc": ("repro_torch.core.primitives.tc", "triangle_count"),
}

# Every module that registers providers on import — the registry is
# lazy, so the checker must pull them all in before reading the matrix.
PROVIDER_MODULES = (
    "repro_torch.core.operators",
    "repro_torch.core.frontier",
    "repro_torch.linalg.ops",
    "repro_torch.kernels.ops",
    "repro_torch.core.distributed",
)

VALID_ENCODINGS = frozenset({"dense", "delta"})


@dataclass(frozen=True)
class ContractFinding:
    rule: str
    key: str      # "op/backend/placement" or "op"
    message: str

    def render(self) -> str:
        return f"{self.rule} [{self.key}] {self.message}"


def _load_registry():
    for mod in PROVIDER_MODULES:
        importlib.import_module(mod)
    from ..core import backend as B
    return B


def check_registry() -> List[ContractFinding]:
    """Audit the fully-loaded provider matrix; returns all findings."""
    B = _load_registry()
    reg = dict(B._REGISTRY)
    enc = dict(B._ENCODINGS)
    findings: List[ContractFinding] = []

    ops = sorted({k[0] for k in reg})
    by_placement = {pl: {k[0] for k in reg if k[2] == pl}
                    for pl in B.PLACEMENTS}
    distributed = [pl for pl in B.PLACEMENTS if pl != B.SINGLE]

    # CT001 — sharded <-> 2d coverage, honouring declared fallbacks
    for a, b in ((B.SHARDED, B.TWOD), (B.TWOD, B.SHARDED)):
        for op in sorted(by_placement[a] - by_placement[b]):
            if B.declared_fallback(op, b) is None:
                findings.append(ContractFinding(
                    "CT001", f"{op}/{b}",
                    f"op has a {a!r} provider but no {b!r} provider and "
                    f"no declared fallback — register one or "
                    f"declare_fallback({op!r}, {b!r}, reason=...)"))

    # CT002 — encodings declared and valid for every registered key
    for key in sorted(reg):
        kid = "/".join(key)
        declared = enc.get(key)
        if declared is None:
            findings.append(ContractFinding(
                "CT002", kid, "registered provider has no encodings "
                "entry (register() must record one)"))
            continue
        bad = set(declared) - VALID_ENCODINGS
        if bad:
            findings.append(ContractFinding(
                "CT002", kid, f"unknown encodings declared: {sorted(bad)}"))
        if "dense" not in declared:
            findings.append(ContractFinding(
                "CT002", kid, "provider does not declare 'dense' — every "
                "provider must accept the decode-to-dense fallback"))

    # CT003 — telemetry= on every primitive's public wrapper
    for name, (mod, fn_name) in PRIMITIVES.items():
        fn = getattr(importlib.import_module(mod), fn_name)
        params = inspect.signature(fn).parameters
        if "telemetry" not in params:
            findings.append(ContractFinding(
                "CT003", name,
                f"{mod}.{fn_name} does not expose a telemetry= keyword"))

    # CT004 — the declared route under a placement; no silent fallback
    # to single. (a) behavioural, through dispatch itself
    for pl in distributed:
        for op in ops:
            for bk in B.BACKENDS:
                kid = f"{op}/{bk}/{pl}"
                want = reg.get((op, B.TORCH, pl))
                try:
                    got = B.dispatch(op, bk, pl)
                except B.ProviderMissError:
                    if want is not None:
                        findings.append(ContractFinding(
                            "CT004", kid, f"dispatch missed, but the "
                            f"torch provider under {pl!r} exists — the "
                            f"declared route lands there"))
                    continue
                except KeyError:
                    findings.append(ContractFinding(
                        "CT004", kid, "distributed miss raised a bare "
                        "KeyError, not ProviderMissError — the structured "
                        "miss contract"))
                    continue
                if want is None:
                    findings.append(ContractFinding(
                        "CT004", kid, "distributed dispatch with no "
                        "provider returned an implementation — a silent "
                        "fallback"))
                elif got is not want:
                    findings.append(ContractFinding(
                        "CT004", kid, f"dispatch did not take the declared "
                        f"route to the torch provider under {pl!r}"))
    # (b) structural: no distributed key aliases a single callable
    for (op, bk, pl), fn in sorted(reg.items()):
        if pl == B.SINGLE:
            continue
        singles = {id(reg.get((op, b, B.SINGLE))) for b in B.BACKENDS}
        if id(fn) in singles:
            findings.append(ContractFinding(
                "CT004", f"{op}/{bk}/{pl}",
                "distributed registration reuses the single-placement "
                "callable — a silent single fallback wearing a "
                "registration"))

    # CT005 — every cuda provider has a torch twin under its placement
    for (op, bk, pl) in sorted(reg):
        if bk == B.CUDA and (op, B.TORCH, pl) not in reg:
            findings.append(ContractFinding(
                "CT005", f"{op}/cuda/{pl}",
                f"cuda provider has no torch twin under {pl!r}: the kernel "
                f"has no plain version to be held against and the "
                f"cuda→torch rung nowhere to land"))

    # CT006 — compile budget declared for each primitive
    from .budgets import COMPILE_BUDGETS
    for name in PRIMITIVES:
        if name not in COMPILE_BUDGETS:
            findings.append(ContractFinding(
                "CT006", name,
                "primitive has no declared compile budget in "
                "repro_torch.analysis.budgets.COMPILE_BUDGETS"))

    return findings


def matrix() -> str:
    """Human-readable provider matrix: one row per op, one column per
    (backend, placement) pair; "+delta" where the provider decodes the
    delta stream itself, "(route)" where cuda runs the placement's
    torch provider, "(declared)" for a declared hole."""
    B = _load_registry()
    reg = B._REGISTRY
    enc = B._ENCODINGS
    cols = [(bk, pl) for pl in B.PLACEMENTS for bk in B.BACKENDS]
    ops = sorted({k[0] for k in reg})
    head = ["op"] + [f"{bk}/{pl}" for bk, pl in cols]
    rows = [head]
    for op in ops:
        row = [op]
        for bk, pl in cols:
            key = (op, bk, pl)
            if key in reg:
                e = enc.get(key, ())
                row.append("+delta" if "delta" in e else "yes")
            elif B.declared_fallback(op, pl) is not None:
                row.append("(declared)")
            elif pl != B.SINGLE and (op, B.TORCH, pl) in reg:
                row.append("(route)")
            else:
                row.append("-")
        rows.append(row)
    widths = [max(len(r[i]) for r in rows) for i in range(len(head))]
    return "\n".join(
        "  ".join(c.ljust(w) for c, w in zip(r, widths)) for r in rows)


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.contracts",
        description="Check the port's backend registry contracts "
                    "(CT001-CT006).")
    p.add_argument("--matrix", action="store_true",
                   help="print the provider matrix and exit")
    ns = p.parse_args(argv)
    if ns.matrix:
        print(matrix())                      # reprolint: disable=RL005 -- CLI output channel
        return 0
    findings = check_registry()
    for f in findings:
        print(f.render())                    # reprolint: disable=RL005 -- CLI output channel
    print(f"{len(findings)} contract finding(s)")  # reprolint: disable=RL005 -- CLI output channel
    return 1 if findings else 0


if __name__ == "__main__":
    raise SystemExit(main())
