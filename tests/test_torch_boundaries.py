"""repro_torch stands alone: it imports no JAX and nothing of the JAX
package, builds no kernel at import, and never runs on the CPU in place of
the card it was asked for."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch.core import NBS, restore_cmi, save_cmi
from repro_torch.kernels import _build
from repro_torch.kernels.colocate import ops as colocate_ops
from repro_torch.kernels.delta_encode import ops as delta_ops

SRC = Path(repro_torch.__file__).resolve().parent.parent
PKG = Path(repro_torch.__file__).resolve().parent


def test_port_imports_no_jax_and_no_reference_package():
    modules = sorted(
        ".".join(p.relative_to(SRC).with_suffix("").parts).removesuffix(".__init__")
        for p in PKG.rglob("*.py")
    )
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'repro' or m.startswith('repro.') or m == 'ml_dtypes')\n"
        "print('BAD', bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"}, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    assert len(modules) >= 20


def test_sources_name_no_jax_or_reference_import():
    root = SRC.parent
    for path in list(PKG.rglob("*.py")) + [root / "chip_smoke.py"]:
        for line in path.read_text().splitlines():
            s = line.strip()
            assert not s.startswith(("import jax", "from jax", "import repro.", "from repro.",
                                     "import ml_dtypes")), f"{path}: {line}"
            assert s != "import repro", f"{path}: {line}"


def test_default_device_entry_points_raise_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the CUDA-less behaviour")
    with pytest.raises(RuntimeError, match="CUDA"):
        NBS(tmp_path / "s3").add_node("n")
    save_cmi(tmp_path, "c", {"w": torch.ones(3)})
    with pytest.raises(RuntimeError, match="CUDA"):
        restore_cmi(tmp_path, "c")
    from repro_torch.core import colocation as co

    with pytest.raises(RuntimeError, match="CUDA"):
        co.stage_read({}, n_scans=1, viirs_pixels_per_scan=4, viirs_lines_per_scan=1)
    # the CPU is there when the caller asks for it
    node = NBS(tmp_path / "s3b").add_node("n", device="cpu")
    assert node.device == torch.device("cpu")


def _no_plain(*args, **kwargs):
    raise AssertionError("a non-CPU tensor reached the plain version")


def test_wrappers_never_fall_back_to_the_plain_version(monkeypatch):
    """A tensor that is not on the CPU goes to the kernel or raises."""
    monkeypatch.setattr(delta_ops, "changed_blocks_plain", _no_plain)
    monkeypatch.setattr(colocate_ops, "colocate_match_plain", _no_plain)
    meta = torch.empty(64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        delta_ops.changed_blocks(meta, meta, 8)
    with pytest.raises(ValueError, match="CUDA"):
        colocate_ops.colocate_match(torch.empty(4, 3, device="meta"),
                                    torch.empty(5, 3, device="meta"))
    with pytest.raises(ValueError):  # mixed devices
        delta_ops.changed_blocks(torch.zeros(64), meta, 8)


def test_kernel_build_raises_without_toolkit(monkeypatch):
    if Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("a CUDA toolkit is installed here")
    monkeypatch.setenv("PATH", "/nonexistent")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build(["delta_encode"])


def test_import_builds_nothing():
    # importing every kernel module above left no library loaded
    assert _build._libs == {}
    assert set(_build.SOURCES) == {p.stem for p in _build.CSRC.glob("*.cu")}


def test_build_tag_follows_the_shared_header(tmp_path, monkeypatch):
    # a library's name hashes the headers its source may include, so an
    # edited csrc/*.cuh is never served by a stale build; the sources stay
    # the .cu files
    import shutil

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    assert sorted(p.name for p in csrc.glob("*.cuh")) == ["hopper.cuh"]
    before = {name: _build.lib_path(name) for name in _build.SOURCES}
    assert before == {name: _build.lib_path(name) for name in _build.SOURCES}  # stable
    header = csrc / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: _build.lib_path(name) for name in _build.SOURCES}
    assert all(after[name] != before[name] for name in _build.SOURCES)
    assert all(after[name].name.startswith(f"lib{name}-") for name in _build.SOURCES)
    assert set(_build.SOURCES) == {p.stem for p in csrc.glob("*.cu")}
