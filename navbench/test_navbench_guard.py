"""The import guard: the JAX package and JAX fail a run by their whole
top-level name; the program passes; the reference imports nothing of the
program."""

import subprocess
import sys
import types
from pathlib import Path

import guard
import reference

HERE = Path(__file__).resolve().parent


def test_whole_top_level_names():
    loaded = ["repro_torch", "repro_torch.models", "repro", "repro.models.x", "jax.numpy",
              "jaxlib", "flax.linen", "reprox", "jaxtyping", "numpy"]
    assert guard.loaded_forbidden(loaded) == ["flax.linen", "jax.numpy", "jaxlib", "repro",
                                              "repro.models.x"]
    assert guard.loaded_forbidden(["repro_torch", "repro_torch.serve"]) == []


def test_the_reference_imports_nothing_of_the_program(tmp_path):
    assert guard.reference_imports(reference) == []
    bad = tmp_path / "bad_reference.py"
    bad.write_text("import torch\nfrom repro_torch.models import layers\n")
    mod = types.ModuleType("bad_reference")
    mod.__file__ = str(bad)
    assert guard.reference_imports(mod) == ["repro_torch.models"]
    sneaky = types.ModuleType("sneaky")
    sneaky.__file__ = str(HERE / "reference.py")
    sneaky.helper = types.ModuleType("repro_torch.kernels")
    assert guard.reference_imports(sneaky) == ["repro_torch.kernels"]


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """What a run imports, up to the look for a card (the rest is the
    program, checked in every run on the card)."""
    code = ("import sys; sys.argv = ['run.py', '--workload', 'hymba-1.5b.serve-32k', '--seed', '1',"
            " '--seconds', '1']; sys.path.insert(0, %r); import run, harness, drive_train, "
            "drive_serve, guard, reference, compare, devtrace, calibrate, faults;"
            " import repro_torch.serve.engine, repro_torch.distributed.steps;"
            " print(guard.loaded_forbidden())" % str(HERE))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=HERE.parent, env={"PYTHONPATH": str(HERE.parent / "src"),
                                               "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
