"""The port's navlint (``repro_torch.analysis``) against the JAX package's.

The reference's navlint cases run against the port: the golden fixtures
(every ``# EXPECT: NAVxxx`` line and nothing else), suppressions,
self-hosting over ``src/repro_torch``, the coverage checker over the
port's fire sites, ``SITES``, chaos cells and ``docs/fabric.md`` in all
six directions of drift, the CLI's exit codes and output, and the runtime
half of the addressability rules in the port's ``core/itinerary.py``. Then
the two packages side by side: every fixture gives equal findings (code,
line and message), ``--list-rules`` prints the same catalog, and
``declared_destinations`` agrees.
"""

import json
import os
import re
import subprocess
import sys
from collections import Counter
from functools import partial
from pathlib import Path

import pytest

from repro.analysis import lint_paths as jax_lint_paths
from repro.analysis import main as jax_main
from repro.core import itinerary as jax_itinerary
from repro_torch.analysis import check_coverage, lint_paths, main
from repro_torch.analysis.coverage import extract_doc_points, extract_fire_sites
from repro_torch.chaos import matrix
from repro_torch.chaos.sites import SITES

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"
DOCS = REPO / "docs" / "fabric.md"
FIXTURES = Path(__file__).resolve().parent / "lint_fixtures"

_EXPECT_RE = re.compile(r"#\s*EXPECT:\s*([A-Z0-9, ]+)")


def _fixture_files() -> list[Path]:
    return [f for f in sorted(FIXTURES.rglob("*.py")) if f.name != "__init__.py"]


def _expected(path: Path) -> Counter:
    """(line, code) multiset promised by the fixture's EXPECT comments."""
    expected: Counter = Counter()
    for lineno, line in enumerate(path.read_text().splitlines(), start=1):
        m = _EXPECT_RE.search(line)
        if m:
            for code in m.group(1).replace(",", " ").split():
                expected[(lineno, code)] += 1
    return expected


_IDS = dict(ids=lambda p: p.relative_to(FIXTURES).as_posix())

# ---------------------------------------------------------------- goldens


@pytest.mark.parametrize("fixture", _fixture_files(), **_IDS)
def test_fixture_golden(fixture):
    findings, n_files, _ = lint_paths([str(fixture)])
    assert n_files == 1
    actual = Counter((f.line, f.code) for f in findings)
    assert actual == _expected(fixture), "\n".join(
        f"  {f.line}: {f.code} {f.message}" for f in findings)


@pytest.mark.parametrize("fixture", _fixture_files(), **_IDS)
def test_fixture_findings_equal_the_reference(fixture):
    """Rule, line, message and suppression count, finding for finding."""
    got, n, suppressed = lint_paths([str(fixture)])
    want, jn, jsuppressed = jax_lint_paths([str(fixture)])
    assert (n, suppressed) == (jn, jsuppressed)
    assert [(f.code, f.path, f.line, f.message) for f in got] == \
        [(f.code, f.path, f.line, f.message) for f in want]


def test_every_rule_has_a_failing_and_passing_fixture():
    demonstrated = set()
    for f in _fixture_files():
        if f.name.endswith("_fail.py"):
            demonstrated.update(code for _, code in _expected(f))
            ok = f.with_name(f.name.replace("_fail", "_ok"))
            assert ok.exists() and not _expected(ok)
            assert not lint_paths([str(ok)])[0], ok.name
    assert demonstrated == {
        "NAV101", "NAV102", "NAV103", "NAV104",
        "NAV201", "NAV202", "NAV203", "NAV204", "NAV205",
        "NAV301", "NAV401", "NAV402",
    }


def test_suppressions_are_counted_not_reported():
    findings, _, suppressed = lint_paths([str(FIXTURES / "suppressed_ok.py")])
    assert findings == []
    assert suppressed == 2  # one line-scoped NAV101, one file-scoped NAV301


# ---------------------------------------------------- self-hosting (no FPs)


def test_navlint_is_clean_over_the_port():
    findings, n_files, _ = lint_paths([str(PORT)])
    assert findings == [], "\n".join(f"{f.path}:{f.line}: {f.code} {f.message}"
                                     for f in findings)
    assert n_files > 70  # sanity: the whole port was scanned


def test_module_cli_self_hosts_jax_free():
    """``python -m repro_torch.analysis --check --coverage src/repro_torch``
    exits 0 and prints "navlint: clean", and the process never imports jax
    or the JAX package."""
    code = ("import runpy, sys; sys.argv = ['navlint', '--check', '--coverage', "
            f"{str(PORT)!r}, '--docs', {str(DOCS)!r}]\n"
            "try:\n    runpy.run_module('repro_torch.analysis', run_name='__main__')\n"
            "except SystemExit as e:\n    rc = e.code\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro'))\n"
            "print('IMPORTED', bad); sys.exit(rc)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=REPO, env={**os.environ, "PYTHONPATH": str(REPO / "src")},
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "navlint: clean" in proc.stdout
    assert "IMPORTED []" in proc.stdout, proc.stdout


# ------------------------------------------------------------ coverage


def test_coverage_clean_on_the_port():
    """The port's own SITES and CELLS by default."""
    assert check_coverage(PORT, docs_path=DOCS) == []


def test_fire_site_extraction_matches_registry():
    sites = extract_fire_sites(PORT)
    assert set(sites) == set(SITES)
    for dynamic in ("hop_stream.mid_stream", "relay.mid_stream", "fetch_stream.mid_pump"):
        assert sites[dynamic], f"dynamic site {dynamic} not extracted"


def test_coverage_flags_orphaned_fire_site(tmp_path):
    pkg = tmp_path / "app"
    pkg.mkdir()
    (pkg / "__init__.py").write_text("")
    lines = [f'    faults.fire("{p}")' for p in SITES] + ['    faults.fire("bogus.nope")']
    (pkg / "proto.py").write_text(
        "from repro_torch.chaos import faults\n\ndef run():\n" + "\n".join(lines) + "\n")
    findings = check_coverage(tmp_path, docs_path=DOCS)
    assert [f.code for f in findings] == ["NAV501"]
    assert "bogus.nope" in findings[0].message


def test_coverage_flags_removed_site():
    doctored = {k: v for k, v in SITES.items() if k != "hop.after_save"}
    findings = check_coverage(PORT, sites=doctored, docs_path=DOCS)
    codes = {f.code for f in findings if "hop.after_save" in f.message}
    assert {"NAV501", "NAV504"} <= codes
    assert "NAV506" in {f.code for f in findings}


def test_coverage_flags_removed_cell():
    doctored = [c for c in matrix.CELLS if c["spec"]["point"] != "publish.before_commit"]
    findings = check_coverage(PORT, cells=doctored, docs_path=DOCS)
    assert [f.code for f in findings] == ["NAV503"]
    assert "publish.before_commit" in findings[0].message


def test_coverage_flags_unfired_and_undocumented_site():
    doctored = {**SITES, "hop.new_state": "a state we forgot to wire up"}
    findings = check_coverage(PORT, sites=doctored, docs_path=DOCS)
    assert {f.code for f in findings if "hop.new_state" in f.message} == \
        {"NAV502", "NAV503", "NAV505"}


def test_doc_table_extraction():
    assert extract_doc_points(DOCS) == set(SITES)


# ------------------------------------------------------------------ CLI


def test_cli_exit_codes(capsys):
    assert main(["--check", str(FIXTURES / "nav201_fail.py")]) == 1
    assert main(["--check", str(FIXTURES / "nav201_ok.py")]) == 0
    assert main(["--list-rules"]) == 0
    assert main(["--check", str(FIXTURES / "does_not_exist.py")]) == 2
    capsys.readouterr()


def test_cli_coverage_defaults_to_the_port(capsys):
    assert main(["--coverage", "--docs", str(DOCS)]) == 0
    assert main(["--coverage", "--src-root", str(PORT), "--docs", str(DOCS)]) == 0
    capsys.readouterr()


def test_cli_json_output(capsys):
    rc = main(["--check", "--json", str(FIXTURES / "nav402_fail.py")])
    out = json.loads(capsys.readouterr().out)
    assert rc == 1
    assert out["counts"] == {"NAV402": 1}
    (finding,) = out["findings"]
    assert (finding["code"], finding["line"]) == ("NAV402", 8)


def test_cli_reports_syntax_errors_as_nav000(tmp_path, capsys):
    bad = tmp_path / "broken.py"
    bad.write_text("def half(:\n")
    assert main(["--check", str(bad)]) == 1
    assert "NAV000" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [["--list-rules"],
                                  ["--check", "--json", str(FIXTURES)],
                                  ["--check", str(FIXTURES)]],
                         ids=["list-rules", "fixtures-json", "fixtures-text"])
def test_cli_output_equals_the_reference(argv, capsys):
    rc = main(argv)
    got = capsys.readouterr().out
    assert jax_main(argv) == rc
    assert capsys.readouterr().out == got


# ------------------------------------------- runtime half (shared rules)


def test_stage_ref_rejects_what_navlint_rejects():
    from repro_torch.core.itinerary import ref_obstacle, stage_ref
    from repro_torch.fabric.worker import tour_read

    assert stage_ref(tour_read) == "repro_torch.fabric.worker:tour_read"
    assert stage_ref(lambda s: s) is None
    assert stage_ref(partial(sorted, reverse=True)) is None

    def nested(s):
        return s

    assert stage_ref(nested) is None
    assert ref_obstacle("pkg.mod", "fn") is None
    assert ref_obstacle("__main__", "fn") is not None
    assert ref_obstacle("pkg.mod", "fn", bound=True) is not None
    for args in (("m", "<lambda>"), ("m", "outer.<locals>.f"), ("__main__", "f")):
        assert ref_obstacle(*args) == jax_itinerary.ref_obstacle(*args)


def test_validate_stages_preflight(tmp_path):
    from repro_torch.core.itinerary import Stage, declared_destinations, validate_stages
    from repro_torch.core.nbs import NBS
    from repro_torch.fabric.worker import tour_read

    nbs = NBS(str(tmp_path))
    nbs.add_node("A", device="cpu")
    good = [Stage("A", tour_read, "read")]
    assert validate_stages(good, nbs) == []
    assert declared_destinations(good + good) == ["A"]
    bad = [Stage("B", lambda s: s, "oops")]
    problems = validate_stages(bad, nbs)
    assert len(problems) == 2
    assert any("undeclared node 'B'" in p for p in problems)
    assert any("not worker-addressable" in p for p in problems)
    assert validate_stages([Stage("A", lambda s: s, "ok", fn_ref="app:step")], nbs) == []


def test_declared_destinations_equal_the_reference():
    from repro_torch.core.itinerary import Stage, declared_destinations

    dests = ["C", "A", "C", "B", "A", "D", "B"]
    port = [Stage(d, sorted, f"s{i}") for i, d in enumerate(dests)]
    ref = [jax_itinerary.Stage(d, sorted, f"s{i}") for i, d in enumerate(dests)]
    assert declared_destinations(port) == jax_itinerary.declared_destinations(ref) == \
        ["C", "A", "B", "D"]
    assert declared_destinations([]) == jax_itinerary.declared_destinations([]) == []


def test_ping_exposes_registered_stages():
    from repro_torch.fabric import server

    before = server.registered_stages()
    server.register_stage("_navlint_test_stage", lambda s: s)
    try:
        assert "_navlint_test_stage" in server.registered_stages()
    finally:
        server.STAGE_REGISTRY.pop("_navlint_test_stage", None)
    assert server.registered_stages() == before
