"""Protocol fault-coverage checker: fire sites ↔ SITES ↔ matrix ↔ docs.

Extracts every ``faults.fire("family.state")`` call site from a source
tree by AST — including the *dynamic* sites where the point travels in a
``fault_point`` parameter (``stream.pump_state_chunks``) — and enforces
the 1:1 contract promised by :mod:`repro_torch.chaos.sites`:

* every fire site names a registered SITES entry          (else NAV501)
* every SITES entry has at least one fire site            (else NAV502)
* every SITES entry has at least one chaos-matrix cell    (else NAV503)
* every matrix cell strikes a registered point            (else NAV504)
* every SITES entry appears in the docs state table       (else NAV505)
* every documented point is registered                    (else NAV506)

This replaces the hand-listed family-coverage meta-test: adding a
``faults.fire`` call at a new protocol state without a SITES entry, a
matrix cell, and a docs row is a CI failure, not a silent gap.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Iterable, Mapping

from repro_torch.analysis.rules import Finding

# a docs table row:  | `hop.after_save` | ... |  (states may be dotted too:
# `cas.publish.pre_link`)
_DOC_POINT_RE = re.compile(r"^\|\s*`([a-z_]+(?:\.[a-z_]+)+)`\s*\|", re.MULTILINE)

# dotted "family.state" strings are fire points; single tokens are ad-hoc
_POINT_RE = re.compile(r"^[a-z_]+(?:\.[a-z_]+)+$")


def _iter_py(paths: Iterable[Path]):
    for p in paths:
        p = Path(p)
        if p.is_dir():
            yield from sorted(p.rglob("*.py"))
        elif p.suffix == ".py":
            yield p


def extract_fire_sites(src_root: Path | str) -> dict[str, list[tuple[str, int]]]:
    """point -> [(path, line), ...] for every statically-visible fire site.

    Three spellings count as a site:

    * ``faults.fire("family.state", ...)`` — a literal point,
    * a function parameter named ``fault_point`` with a literal default
      (the shared chunk pump's own protocol label),
    * a ``fault_point="family.state"`` keyword at any call (the pump's
      callers each labeling their own mid-stream state).
    """
    sites: dict[str, list[tuple[str, int]]] = {}

    def record(point: str, path: Path, line: int) -> None:
        if _POINT_RE.match(point):
            sites.setdefault(point, []).append((str(path), line))

    for path in _iter_py([Path(src_root)]):
        try:
            tree = ast.parse(path.read_text(), filename=str(path))
        except SyntaxError:
            continue
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                f = node.func
                is_fire = (isinstance(f, ast.Attribute) and f.attr == "fire") or (
                    isinstance(f, ast.Name) and f.id == "fire"
                )
                if is_fire and node.args:
                    a0 = node.args[0]
                    if isinstance(a0, ast.Constant) and isinstance(a0.value, str):
                        record(a0.value, path, node.lineno)
                for kw in node.keywords:
                    if (kw.arg == "fault_point"
                            and isinstance(kw.value, ast.Constant)
                            and isinstance(kw.value.value, str)):
                        record(kw.value.value, path, kw.value.lineno)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                args = node.args
                params = list(args.posonlyargs) + list(args.args)
                # align positional defaults right-to-left
                for param, default in zip(reversed(params), reversed(args.defaults)):
                    if (param.arg == "fault_point"
                            and isinstance(default, ast.Constant)
                            and isinstance(default.value, str)):
                        record(default.value, path, default.lineno)
                for param, default in zip(args.kwonlyargs, args.kw_defaults or []):
                    if (param.arg == "fault_point"
                            and isinstance(default, ast.Constant)
                            and isinstance(default.value, str)):
                        record(default.value, path, default.lineno)
    return sites


def extract_doc_points(docs_path: Path | str) -> set[str]:
    return set(_DOC_POINT_RE.findall(Path(docs_path).read_text()))


def check_coverage(
    src_root: Path | str,
    *,
    sites: Mapping[str, str] | None = None,
    cells: list[dict] | None = None,
    docs_path: Path | str | None = None,
) -> list[Finding]:
    """Cross-check the four views of the chaos surface; one Finding per drift.

    Defaults load the real registry (``repro_torch.chaos.sites.SITES``) and the
    real matrix (``repro_torch.chaos.matrix.CELLS``); tests pass doctored copies
    to prove each direction of the check fails when a side is removed.
    """
    if sites is None:
        from repro_torch.chaos.sites import SITES as sites  # type: ignore[no-redef]
    if cells is None:
        from repro_torch.chaos.matrix import CELLS

        cells = [{"id": c["id"], "point": c["spec"]["point"]} for c in CELLS]

    src_root = Path(src_root)
    fire_sites = extract_fire_sites(src_root)
    findings: list[Finding] = []

    matrix_path = str(src_root / "chaos" / "matrix.py")
    sites_path = str(src_root / "chaos" / "sites.py")

    for point, locs in sorted(fire_sites.items()):
        if point not in sites:
            path, line = locs[0]
            findings.append(Finding(
                code="NAV501", path=path, line=line,
                message=f"faults.fire site {point!r} is not registered in "
                        "repro_torch.chaos.SITES — it will never get a chaos-matrix "
                        "cell (typo'd point strings silently never fire)",
            ))
    for point in sorted(sites):
        if point not in fire_sites:
            findings.append(Finding(
                code="NAV502", path=sites_path, line=1,
                message=f"SITES entry {point!r} has no faults.fire call site "
                        f"under {src_root} — dead registry entry",
            ))

    # accept raw matrix.CELLS entries ({"spec": {"point": ...}}) as well as
    # normalized cell_registry() dicts ({"point": ...})
    cells = [c if "point" in c else {"id": c.get("id", "?"),
                                     "point": c["spec"]["point"]}
             for c in cells]
    cell_points = {c["point"] for c in cells}
    for point in sorted(sites):
        if point not in cell_points:
            findings.append(Finding(
                code="NAV503", path=matrix_path, line=1,
                message=f"SITES entry {point!r} has no chaos-matrix cell — "
                        "its recovery invariant is unenforced",
            ))
    for cell in cells:
        if cell["point"] not in sites:
            findings.append(Finding(
                code="NAV504", path=matrix_path, line=1,
                message=f"matrix cell {cell.get('id', '?')!r} strikes "
                        f"unregistered point {cell['point']!r}",
            ))

    if docs_path is not None and Path(docs_path).exists():
        doc_points = extract_doc_points(docs_path)
        for point in sorted(sites):
            if point not in doc_points:
                findings.append(Finding(
                    code="NAV505", path=str(docs_path), line=1,
                    message=f"SITES entry {point!r} missing from the "
                            "injectable-states table",
                ))
        for point in sorted(doc_points):
            if point not in sites:
                findings.append(Finding(
                    code="NAV506", path=str(docs_path), line=1,
                    message=f"documented point {point!r} is not registered "
                            "in repro_torch.chaos.SITES",
                ))

    return sorted(findings, key=Finding.key)
