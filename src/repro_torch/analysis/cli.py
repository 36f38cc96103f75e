"""``python -m repro_torch.analysis`` — navlint's command line.

    # migration-safety lint (exit 1 on findings)
    python -m repro_torch.analysis --check src/repro_torch

    # protocol fault-coverage checker (fire sites ↔ SITES ↔ matrix ↔ docs)
    python -m repro_torch.analysis --coverage

    # both, machine-readable
    python -m repro_torch.analysis --check --coverage --json src/repro_torch

Exit codes: 0 clean · 1 findings · 2 usage/internal error.
"""

from __future__ import annotations

import argparse
import ast
import sys
from pathlib import Path

from repro_torch.analysis.report import render_json, render_rules, render_text
from repro_torch.analysis.rules import Finding, lint_module
from repro_torch.analysis.walker import parse_module

# directories that are never NavP app code
_SKIP_DIRS = {"__pycache__", ".git", ".venv", "node_modules"}


def iter_targets(paths: list[str]) -> list[Path]:
    out: list[Path] = []
    for raw in paths:
        p = Path(raw)
        if p.is_dir():
            out.extend(
                f for f in sorted(p.rglob("*.py"))
                if not (_SKIP_DIRS & set(f.parts))
            )
        elif p.suffix == ".py" and p.exists():
            out.append(p)
        else:
            raise FileNotFoundError(f"no such lint target: {raw}")
    return out


def lint_paths(paths: list[str]) -> tuple[list[Finding], int, int]:
    """Lint files/trees; returns (reportable findings, files, n suppressed)."""
    findings: list[Finding] = []
    suppressed = 0
    targets = iter_targets(paths)
    for path in targets:
        source = path.read_text()
        try:
            mod = parse_module(path, source)
            tree = ast.parse(source, filename=str(path))
        except SyntaxError as e:
            findings.append(Finding(
                code="NAV000", path=str(path), line=e.lineno or 1,
                message=f"syntax error: {e.msg}",
            ))
            continue
        for f in lint_module(mod, tree):
            if f.suppressed:
                suppressed += 1
            else:
                findings.append(f)
    return findings, len(targets), suppressed


def _default_repo_root() -> Path:
    """src/repro_torch containing this installation — works from any CWD."""
    return Path(__file__).resolve().parent.parent


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.analysis",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("paths", nargs="*", help="files or directories to lint")
    ap.add_argument("--check", action="store_true",
                    help="lint the given paths (the default when paths are given)")
    ap.add_argument("--coverage", action="store_true",
                    help="run the protocol fault-coverage checker")
    ap.add_argument("--json", action="store_true", help="machine-readable output")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    ap.add_argument("--src-root", default=None,
                    help="repro_torch package root the coverage checker scans "
                         "(default: the installed repro_torch/)")
    ap.add_argument("--docs", default=None,
                    help="fabric docs the coverage checker cross-checks "
                         "(default: docs/fabric.md under CWD if present)")
    args = ap.parse_args(argv)

    if args.list_rules:
        print(render_rules())
        return 0
    if not args.paths and not args.coverage:
        ap.error("nothing to do: give paths to lint and/or --coverage")

    findings: list[Finding] = []
    checked = suppressed = 0
    try:
        if args.paths:
            findings, checked, suppressed = lint_paths(args.paths)
        if args.coverage:
            from repro_torch.analysis.coverage import check_coverage

            src_root = Path(args.src_root) if args.src_root else _default_repo_root()
            docs = args.docs
            if docs is None:
                candidate = Path("docs/fabric.md")
                docs = candidate if candidate.exists() else None
            findings.extend(check_coverage(src_root, docs_path=docs))
    except FileNotFoundError as e:
        print(f"navlint: {e}", file=sys.stderr)
        return 2

    if args.json:
        print(render_json(findings, checked=checked, suppressed=suppressed))
    else:
        print(render_text(findings, checked=checked, suppressed=suppressed))
    return 1 if findings else 0
