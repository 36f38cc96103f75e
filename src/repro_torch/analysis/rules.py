"""navlint's migration-safety rules: NAV1xx–NAV4xx.

Each rule is a pure function ``ModuleInfo -> list[Finding]`` registered in
:data:`RULES`. Codes are stable API — suppression comments, fixture
goldens, and the docs catalog all key on them:

    NAV101  lambda as Stage.fn
    NAV102  closure / nested function as Stage.fn
    NAV103  bound method or functools.partial as Stage.fn
    NAV104  Stage.fn defined in a non-importable script (__main__)
    NAV201  open file handle held across a hop/publish boundary
    NAV202  socket held across a hop/publish boundary
    NAV203  lock/semaphore/condition held across a hop/publish boundary
    NAV204  live thread/executor/process held across a hop/publish boundary
    NAV205  generator held across a hop/publish boundary
    NAV301  nondeterminism source in stage/boundary code
    NAV401  hop destination never declared in this module's node topology
    NAV402  in-place mutation of state after publishing it (stale token/grid)

The coverage checker's NAV5xx codes live in
:mod:`repro_torch.analysis.coverage`.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Callable

from repro_torch.analysis.stageref import classify_stage_fn
from repro_torch.analysis.walker import Boundary, FunctionInfo, ModuleInfo, Resource

_RESOURCE_CODE = {
    "file": "NAV201",
    "socket": "NAV202",
    "lock": "NAV203",
    "thread": "NAV204",
    "generator": "NAV205",
}

_RESOURCE_WHY = {
    "file": "an open file handle is process-local — it cannot be serialized "
            "into a CMI or survive a hop to another node",
    "socket": "a socket is bound to this process and host — the resumed or "
              "migrated computation cannot reuse it",
    "lock": "a held lock protects nothing on the destination node and can "
            "deadlock the resumed process",
    "thread": "a live thread/executor does not migrate — its work is "
              "silently lost on the destination",
    "generator": "a generator's frame cannot be serialized — the CMI would "
                 "not capture its progress",
}


@dataclass
class Finding:
    code: str
    path: str
    line: int
    message: str
    suppressed: bool = False

    def key(self) -> tuple:
        return (self.path, self.line, self.code)


# code -> (title, why-it-breaks-migration). The docs catalog and
# --list-rules render from this.
CATALOG: dict[str, tuple[str, str]] = {
    "NAV101": ("lambda as Stage.fn",
               "a lambda has no importable name; svc/run_stage cannot resolve "
               "it in a worker, so the tour silently localizes the state"),
    "NAV102": ("closure as Stage.fn",
               "a nested function's qualname contains <locals> and cannot be "
               "imported by a worker process"),
    "NAV103": ("bound method / partial as Stage.fn",
               "the worker would resolve the unbound function and misbind the "
               "state as self; partials are not importable by name"),
    "NAV104": ("Stage.fn defined in a script",
               "a file without a package __init__.py imports as __main__ — "
               "workers cannot import the stage, so remote tours ship the "
               "data instead of the computation"),
    "NAV201": ("open file across hop/publish", _RESOURCE_WHY["file"]),
    "NAV202": ("socket across hop/publish", _RESOURCE_WHY["socket"]),
    "NAV203": ("lock across hop/publish", _RESOURCE_WHY["lock"]),
    "NAV204": ("live thread across hop/publish", _RESOURCE_WHY["thread"]),
    "NAV205": ("generator across hop/publish", _RESOURCE_WHY["generator"]),
    "NAV301": ("nondeterminism between publish points",
               "resume replays from the last CMI; wall-clock or unseeded "
               "randomness makes the replay diverge from the interrupted "
               "run, breaking the bit-identical-resume invariant"),
    "NAV401": ("hop to undeclared destination",
               "the destination is not in this module's add_node/"
               "add_remote_node topology — the hop raises KeyError at "
               "runtime, typically mid-tour"),
    "NAV402": ("mutation of published state",
               "publish snapshots and hashes the state; mutating it in place "
               "afterwards (without rebinding from the stage result) leaves "
               "cached stream grids and async-publish hashes describing "
               "state that no longer exists"),
    "NAV501": ("unregistered fault point",
               "a faults.fire() site not in repro.chaos.SITES never gets a "
               "chaos-matrix cell — it is injection surface CI cannot see"),
    "NAV502": ("dead SITES entry",
               "a registered point with no fire site can never fire; the "
               "matrix cell covering it tests nothing"),
    "NAV503": ("SITES entry without a matrix cell",
               "a protocol state with no chaos cell has no enforced recovery "
               "invariant"),
    "NAV504": ("matrix cell for unregistered point",
               "the cell would arm a plan that never fires"),
    "NAV505": ("SITES entry undocumented",
               "docs/fabric.md's state table is the operator-facing contract "
               "for every injectable state"),
    "NAV506": ("documented point not registered",
               "the docs table names a state the code no longer fires at"),
}


def _finding(mod: ModuleInfo, code: str, line: int, message: str) -> Finding:
    codes = mod.suppressions.get(line, set()) | mod.file_suppressions
    return Finding(
        code=code, path=str(mod.path), line=line, message=message,
        suppressed=bool({code, "*"} & codes),
    )


# ---------------------------------------------------------------------------
# NAV101–104: stage-ref resolvability
# ---------------------------------------------------------------------------


def check_stage_refs(mod: ModuleInfo) -> list[Finding]:
    out = []
    for use in mod.stage_uses:
        if use.fn_ref:  # explicitly addressed — register_stage contract
            continue
        if use.fn_expr is None:
            continue
        verdict = classify_stage_fn(use.fn_expr, mod)
        if verdict is not None:
            code, msg = verdict
            out.append(_finding(mod, code, use.line, msg))
    return out


# ---------------------------------------------------------------------------
# NAV201–205: resources held across migration boundaries
# ---------------------------------------------------------------------------


def _live_across(res: Resource, b: Boundary, fn: FunctionInfo) -> bool:
    if res.with_span is not None:
        lo, hi = res.with_span
        return lo <= b.line <= hi
    if res.line >= b.line:
        return False
    if res.closed_at is not None and res.closed_at <= b.line:
        return False
    if res.name and res.name in b.arg_names:
        return True  # carried inside the hopped/published state itself
    # held open while the boundary runs AND touched again afterwards
    uses_after = [ln for ln in fn.uses.get(res.name, []) if ln > b.line]
    return bool(res.name) and bool(uses_after)


def check_resources(mod: ModuleInfo) -> list[Finding]:
    out = []
    for fn in mod.functions:
        for b in fn.boundaries:
            for res in fn.resources:
                if not _live_across(res, b, fn):
                    continue
                code = _RESOURCE_CODE[res.kind]
                where = (f"`{res.name}`" if res.name else "the with-block resource")
                out.append(_finding(
                    mod, code, b.line,
                    f"{res.kind} {where} (from {res.desc}, line {res.line}) is "
                    f"held across {b.desc} — {_RESOURCE_WHY[res.kind]}",
                ))
    return out


# ---------------------------------------------------------------------------
# NAV301: nondeterminism in state-carrying code
# ---------------------------------------------------------------------------


def _stage_fn_names(mod: ModuleInfo) -> set[str]:
    names = set(mod.registered_fn_names)
    for use in mod.stage_uses:
        if isinstance(use.fn_expr, ast.Name):
            names.add(use.fn_expr.id)
    return names


def check_nondeterminism(mod: ModuleInfo) -> list[Finding]:
    stage_names = _stage_fn_names(mod)
    out = []
    for fn in mod.functions:
        in_scope = fn.name in stage_names or bool(fn.boundaries)
        if not in_scope or not fn.nondet:
            continue
        role = ("stage function" if fn.name in stage_names
                else "publish/hop scope")
        for call in fn.nondet:
            out.append(_finding(
                mod, "NAV301", call.line,
                f"{call.desc} (in {role} `{fn.name}`) — "
                "bit-identical resume requires replayed steps to recompute "
                "the same values; seed it or move it out of state-carrying "
                "code",
            ))
    return out


# ---------------------------------------------------------------------------
# NAV401: undeclared hop destinations
# ---------------------------------------------------------------------------


def check_destinations(mod: ModuleInfo) -> list[Finding]:
    if not mod.declared_nodes or not mod.declarations_complete:
        # no statically-visible topology (or a dynamic declaration):
        # destinations cannot be judged from this file alone
        return []
    out = []
    for use in mod.stage_uses:
        if use.dest_literal is not None and use.dest_literal not in mod.declared_nodes:
            out.append(_finding(
                mod, "NAV401", use.line,
                f"Stage destination {use.dest_literal!r} is never declared "
                f"(declared here: {sorted(mod.declared_nodes)})",
            ))
    return out


class _HopDestVisitor(ast.NodeVisitor):
    """Collect literal dests of ``*.hop(state, "dest", ...)`` calls."""

    def __init__(self):
        self.dests: list[tuple[int, str]] = []

    def visit_Call(self, node: ast.Call) -> None:
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr == "hop" and len(node.args) >= 2:
            arg = node.args[1]
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                self.dests.append((node.lineno, arg.value))
        self.generic_visit(node)


def check_hop_destinations(mod: ModuleInfo, tree: ast.AST) -> list[Finding]:
    if not mod.declared_nodes or not mod.declarations_complete:
        return []
    v = _HopDestVisitor()
    v.visit(tree)
    out = []
    for line, dest in v.dests:
        if dest not in mod.declared_nodes:
            out.append(_finding(
                mod, "NAV401", line,
                f"hop destination {dest!r} is never declared "
                f"(declared here: {sorted(mod.declared_nodes)})",
            ))
    return out


# ---------------------------------------------------------------------------
# NAV402: in-place mutation after publish
# ---------------------------------------------------------------------------


def check_publish_mutation(mod: ModuleInfo) -> list[Finding]:
    out = []
    for fn in mod.functions:
        publishes = [b for b in fn.boundaries if b.kind == "publish"]
        for b in publishes:
            for name in sorted(b.arg_names):
                muts = fn.mutations.get(name, [])
                if not muts:
                    continue
                rebinds_after = [ln for ln in fn.rebinds.get(name, []) if ln > b.line]
                horizon = min(rebinds_after) if rebinds_after else float("inf")
                for line, desc in muts:
                    if b.line < line < horizon:
                        out.append(_finding(
                            mod, "NAV402", line,
                            f"`{name}` was published at line {b.line} and is "
                            f"mutated in place here ({desc}) without being "
                            "rebound — the published snapshot, its hash grid, "
                            "and any cached stream baseline now describe "
                            "stale state; rebind from the stage/publish "
                            "result instead",
                        ))
    return out


# ---------------------------------------------------------------------------
# registry + module entry point
# ---------------------------------------------------------------------------

LINT_RULES: list[Callable[[ModuleInfo], list[Finding]]] = [
    check_stage_refs,
    check_resources,
    check_nondeterminism,
    check_destinations,
    check_publish_mutation,
]


def lint_module(mod: ModuleInfo, tree: ast.AST | None = None) -> list[Finding]:
    findings: list[Finding] = []
    for rule in LINT_RULES:
        findings.extend(rule(mod))
    if tree is not None:
        findings.extend(check_hop_destinations(mod, tree))
    return sorted(findings, key=Finding.key)
