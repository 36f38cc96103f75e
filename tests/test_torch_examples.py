"""The port's examples (``examples/torch_*.py``) run end to end on the CPU
(``--device cpu``, smoke models), each in its own process as a user runs
it, and print their pass lines; navlint (both packages') is clean over
them.

* quickstart: qwen3's smoke trainer reclaimed at step 17, resumed, the job
  finished;
* navp_colocation: the Fig. 8 itinerary over two nodes, the product
  published with the job finished;
* spot_migration: granite's smoke trainer on 4×2 gloo ranks, reclaimed at
  step 12 and resumed on 2×2 (``--remesh 4x2,2x2``), then a fabric job
  SIGKILLed once and finished by a second worker process;
* elastic_serve: two serving worker processes, a live migration and a
  SIGKILL, every transcript equal to an unperturbed worker's.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.analysis import lint_paths as jax_lint_paths
from repro_torch.analysis import lint_paths

REPO = Path(__file__).resolve().parent.parent
EXAMPLES = {
    "torch_quickstart": ["quickstart: job finished after a reclaim at step 17",
                         "jobs: [['1', 'finished']]"],
    "torch_navp_colocation": ["job status: [['1', 'finished']]", "product: matched_frac="],
    "torch_spot_migration": ["final loss after elastic 8→4 rank migration",
                             "after 1 SIGKILL reclaim(s), 2 worker process(es)",
                             "spot migration: both jobs finished"],
    "torch_elastic_serve": ["zero re-prefill", "all transcripts identical to the unperturbed run"],
}


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_on_the_cpu(name):
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"), "OMP_NUM_THREADS": "2"}
    proc = subprocess.run([sys.executable, f"examples/{name}.py", "--device", "cpu"], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=420)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-5000:]
    for line in EXAMPLES[name]:
        assert line in proc.stdout, (line, proc.stdout[-3000:])


def test_examples_are_navlint_clean():
    paths = [str(p) for p in sorted((REPO / "examples").glob("torch_*.py"))]
    assert len(paths) == len(EXAMPLES)
    for lint in (lint_paths, jax_lint_paths):
        findings, n_files, _ = lint(paths)
        assert n_files == len(EXAMPLES) and findings == [], findings
