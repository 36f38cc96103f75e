"""Rendering for navlint findings: human text and machine JSON."""

from __future__ import annotations

import json
from collections import Counter

from repro_torch.analysis.rules import CATALOG, Finding


def render_text(findings: list[Finding], *, checked: int, suppressed: int) -> str:
    lines = []
    for f in findings:
        title = CATALOG.get(f.code, ("", ""))[0]
        lines.append(f"{f.path}:{f.line}: {f.code} [{title}] {f.message}")
    by_code = Counter(f.code for f in findings)
    if findings:
        summary = ", ".join(f"{c}×{n}" for c, n in sorted(by_code.items()))
        lines.append(
            f"navlint: {len(findings)} finding(s) in {checked} file(s) "
            f"({summary}); {suppressed} suppressed"
        )
    else:
        lines.append(
            f"navlint: clean — {checked} file(s), 0 findings, "
            f"{suppressed} suppressed"
        )
    return "\n".join(lines)


def render_json(findings: list[Finding], *, checked: int, suppressed: int) -> str:
    return json.dumps(
        {
            "findings": [
                {
                    "code": f.code,
                    "rule": CATALOG.get(f.code, ("", ""))[0],
                    "path": f.path,
                    "line": f.line,
                    "message": f.message,
                }
                for f in findings
            ],
            "counts": dict(Counter(f.code for f in findings)),
            "checked_files": checked,
            "suppressed": suppressed,
        },
        indent=1,
        sort_keys=True,
    )


def render_rules() -> str:
    lines = ["navlint rule catalog:"]
    for code, (title, why) in sorted(CATALOG.items()):
        lines.append(f"  {code}  {title}")
        lines.append(f"         {why}")
    lines.append(
        "suppress with `# navlint: disable=CODE[,CODE...]` on the flagged "
        "line, or `# navlint: disable-file=CODE` anywhere in the file"
    )
    return "\n".join(lines)
